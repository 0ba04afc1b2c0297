"""PyTorch port: the CUDA generation kernel against its plain twin on the
card (tests marked ``cuda``; they skip without a GPU), and the twin at the
kernel's own widths (R = D = 32) against the JAX scan sampler where JAX is
installed.

The card's machine has no JAX, and tests/conftest.py imports it, so there
the card tests run without the conftest, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.config import WaveNetConfig
from tacotron_wavenet_vocoder_korean_tpu_torch.ops import wavenet_gen as G

# A stack the CUDA kernel takes (R = D = 32, W = 32), cut to 6 layers and
# S = 64.
CARD = WaveNetConfig(dilations=(1, 2, 4, 1, 2, 4), skip_channels=64,
                     upsample_factor=(2, 5))


def _card_inputs(dev, B=3, T=300, seed=0):
    packed = G.pack_params(CARD, convert.seeded_params(CARD, 1, dev))
    gen = torch.Generator(dev).manual_seed(seed)
    proj = G.precompute_lc_proj(
        packed, torch.randn(B, T, 80, generator=gen, device=dev))
    return packed, proj, gen


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["deterministic", "noise", "primed"])
def test_cuda_kernel_matches_plain_twin(mode):
    """3 streams x 300 steps: <= 1e-4 (f32 sums in another order; no
    near-tie flip is expected at this size)."""
    dev = _cuda()
    packed, proj, gen = _card_inputs(dev)
    T, B = proj.shape[1], proj.shape[0]
    kw = {"deterministic": mode == "deterministic"}
    if mode != "deterministic":
        kw["noise"] = torch.rand(T, B, 11, generator=gen, device=dev)
    if mode == "primed":
        kw["primed"] = 0.3 * torch.randn(T, B, generator=gen, device=dev)
        kw["prime_len"] = 120
    before = G.wavenet_generate.launches
    got = G.wavenet_generate(packed, proj, **kw)
    torch.cuda.synchronize()
    assert G.wavenet_generate.launches == before + 1
    want = G.generate_plain(packed, proj, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_philox_is_seeded_and_in_range():
    dev = _cuda()
    packed, proj, _ = _card_inputs(dev, B=2, T=400)
    run = lambda s: G.wavenet_generate(
        packed, proj, generator=torch.Generator(dev).manual_seed(s))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.abs().max()) <= 1.0 and float(a.std()) > 0
    assert not torch.equal(a[0], a[1])           # streams draw apart


@pytest.mark.cuda
def test_cuda_wrapper_refuses_bad_inputs():
    dev = _cuda()
    packed, proj, _ = _card_inputs(dev, B=1, T=10)
    before = G.wavenet_generate.launches
    with pytest.raises(TypeError):
        G.wavenet_generate(packed, proj.double(), deterministic=True)
    with pytest.raises(ValueError):
        G.wavenet_generate(packed, proj[:, :, :-64], deterministic=True)
    with pytest.raises(ValueError):
        G.wavenet_generate(packed, proj[:, ::2], deterministic=True)
    assert G.wavenet_generate.launches == before


def test_twin_at_kernel_width_matches_jax_scan_sampler():
    """The twin at the widths the kernel takes, against the JAX scan
    sampler on the same seeded weights, deterministic, 200 samples:
    <= 1e-4."""
    jax = pytest.importorskip("jax")
    import dataclasses
    from tacotron_wavenet_vocoder_korean_tpu.config import (
        WaveNetConfig as JaxWaveNetConfig)
    from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW

    from torch_port_util import nest

    tree = convert.seeded_tree(CARD, 1)
    jp = nest(tree)
    jcfg = JaxWaveNetConfig(**dataclasses.asdict(CARD))
    lc = np.random.default_rng(2).standard_normal((2, 200, 80)).astype(
        np.float32)
    want = np.asarray(JW.incremental_generate(
        jcfg, jp, jax.numpy.asarray(lc), jax.random.PRNGKey(0),
        deterministic=True))
    packed = G.pack_params(CARD, convert.params_from_jax(CARD, tree))
    got = G.incremental_generate_cuda(CARD, packed, torch.from_numpy(lc),
                                      deterministic=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert want.std() > 1e-4
