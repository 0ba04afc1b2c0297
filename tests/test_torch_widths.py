"""PyTorch port: the generation kernel at other widths than wn_moon's.

On the CPU: the kernel's plain twin against the JAX package's Pallas
kernel (interpret mode, f32, deterministic) at R != D, S and W that are
not multiples of 8 or 32, a 300-way softmax head and a 40-component MoL
head; the twin on the kernel's zero-padded layout against the twin on the
caller's; the shared-memory limit of ``kernel_limits_error``.

On the card (tests marked ``cuda``; they skip without a GPU): the kernel
against its twin at each width, both weight types, the C and Python
shared-memory sizes, and ``WaveNetGenerator`` serving those widths.  The
card's machine has no JAX, and tests/conftest.py imports it, so there they
run without the conftest, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_widths.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.config import (
    AudioConfig, Config, WaveNetConfig)
from tacotron_wavenet_vocoder_korean_tpu_torch.ops import wavenet_gen as G
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
    WaveNetGenerator)

# The tiny stack of the JAX tests (tests/torch_port_util.py TINY), and
# widths the kernel took only at R = D = 32 before: R != D, S and W off the
# 8- and 32-channel grid, many components, many classes.
TINY = WaveNetConfig(
    dilations=(1, 2, 4, 1, 2, 4), residual_channels=8, dilation_channels=8,
    skip_channels=16, out_channels=12, initial_filter_width=8,
    upsample_factor=(2, 5), sample_size=100, batch_size=2)
SOFTMAX = dict(input_type="mulaw-quantize", scalar_input=False)
CPU_WIDTHS = {
    # R = 16, D = 8, S = 20, W = 40, 5 components
    "r16_d8_s20_w40": dataclasses.replace(
        TINY, residual_channels=16, skip_channels=20, initial_filter_width=40,
        out_channels=15),
    "softmax_q300": dataclasses.replace(
        TINY, quantization_channels=300, out_channels=300, **SOFTMAX),
    "mol_40": dataclasses.replace(TINY, out_channels=120),
}
MOON = WaveNetConfig()                       # wn_moon's architecture
TWICE = dataclasses.replace(MOON, residual_channels=64, dilation_channels=64)
CARD_WIDTHS = {
    "twice": TWICE,
    "twice_softmax": dataclasses.replace(TWICE, out_channels=256, **SOFTMAX),
    "r64_d32": dataclasses.replace(MOON, dilations=MOON.dilations[:10],
                                   residual_channels=64),
    "r32_d64": dataclasses.replace(MOON, dilations=MOON.dilations[:10],
                                   dilation_channels=64),
    "tiny": TINY,
    "r12_d12_s20": dataclasses.replace(TINY, residual_channels=12,
                                       dilation_channels=12, skip_channels=20),
    "w40_mol40": dataclasses.replace(TINY, residual_channels=16,
                                     dilation_channels=16, skip_channels=24,
                                     initial_filter_width=40,
                                     out_channels=120),
    "softmax_q300": CPU_WIDTHS["softmax_q300"],
}
# Over the shared-memory ceiling even with the gate channels split over an
# 8-block cluster (R = D = 128 now takes a cluster: tests/test_torch_cluster.py).
CEILING = dataclasses.replace(MOON, residual_channels=256,
                              dilation_channels=256)


def _jax_cfg(cfg):
    from tacotron_wavenet_vocoder_korean_tpu.config import (
        WaveNetConfig as JaxWaveNetConfig)
    return JaxWaveNetConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", sorted(CPU_WIDTHS))
def test_twin_matches_pallas_kernel_at_width(name):
    """Deterministic, free-running 60 steps (30 for the softmax head) on 2
    streams, f32: the twin within 1e-4 of the Pallas kernel run as the JAX
    tests run it (interpret mode, chunk 32); the same classes."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW
    from tacotron_wavenet_vocoder_korean_tpu.ops import wavenet_pallas as JP
    from torch_port_util import RNG, jax_params, make_inputs, t

    cfg = _jax_cfg(CPU_WIDTHS[name])
    jp = jax_params(cfg)
    port = CPU_WIDTHS[name]
    packed = G.pack_params(port, convert.params_from_jax(port, jp))
    frames = 3 if name.startswith("softmax") else 6
    _, mel = make_inputs(B=2, frames=frames, seed=4)
    lc = np.asarray(JW.Upsampler(cfg).apply({"params": jp["upsampler"]},
                                            jnp.asarray(mel)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JP.pallas_incremental_generate(
            cfg, jp, jnp.asarray(lc), RNG, chunk=32, deterministic=True,
            weight_dtype=jnp.float32))
    got = G.incremental_generate_cuda(port, packed, t(lc),
                                      deterministic=True).numpy()
    assert got.shape == want.shape == (2, 10 * frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if port.scalar_input:
        assert want.std() > 1e-3
    else:
        assert len(np.unique(want)) > 1


def _pad_lc(proj: torch.Tensor, D: int) -> torch.Tensor:
    """[B, T, L*2D] -> [B, T, L*2Dp]: the padded gate channels' lc is 0."""
    B, T, n = proj.shape
    Dp = -(-D // G.PAD) * G.PAD
    out = proj.new_zeros(B, T, n // (2 * D), 2, Dp)
    out[..., :D] = proj.view(B, T, -1, 2, D)
    return out.view(B, T, -1)


@pytest.mark.parametrize("name", ["r12_d12_s20", "w40_mol40",
                                  "softmax_q300"])
def test_twin_on_padded_layout_equals_twin(name):
    """``kernel_layout`` pads R, D and S to multiples of 8 with zeros; the
    twin on it, teacher-forced 40 steps, against the twin on the caller's
    layout.  The padded terms are exact zeros, but a product over a longer
    row may group its f32 sums otherwise: within 1e-6 for samples (the
    same classes)."""
    cfg = dataclasses.replace(CARD_WIDTHS[name], skip_channels=20)
    packed = G.pack_params(cfg, convert.seeded_params(cfg, 3))
    padded = G.kernel_layout(packed)
    R, D, S = (cfg.residual_channels, cfg.dilation_channels,
               cfg.skip_channels)
    Rp, Dp, Sp = (-(-n // 8) * 8 for n in (R, D, S))
    assert padded["w_tap"].shape == (6, 2 * Dp, 2 * Rp)
    assert padded["w_skip"].shape == (6 * Dp, Sp)
    assert padded["post2_t"].shape == (packed["b2"].shape[0], Sp)
    gen = torch.Generator().manual_seed(5)
    lc = torch.randn(2, 40, 80, generator=gen)
    proj = G.precompute_lc_proj(packed, lc)
    proj_p = _pad_lc(proj, D)
    primed = (torch.randint(0, packed["b2"].shape[0], (40, 2),
                            generator=gen).float()
              if "front_oh" in packed else 0.3 * torch.randn(40, 2,
                                                             generator=gen))
    kw = dict(deterministic=True, primed=primed, prime_len=40)
    want = G.generate_plain(packed, proj, **kw)
    got = G.generate_plain(padded, proj_p, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_kernel_layout_leaves_aligned_widths_alone():
    """wn_moon's widths need no padding: the packed layout itself."""
    cfg = dataclasses.replace(MOON, dilations=(1, 2), skip_channels=64)
    packed = G.pack_params(cfg, convert.seeded_params(cfg, 0))
    assert G.kernel_layout(packed) is packed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_limits_error_takes_every_width_that_fits(dtype):
    """Accepted: each width above in both weight types, 2x wn_moon's at 50
    layers with 3 bf16 weight slots or 1 f32 slot, wn_moon's with the full
    ring (8 / 4), R = D = 128 at 50 layers (on a cluster).  Refused: R = D
    = 256 at 50 layers, naming the bytes of shared memory per block at 8
    blocks and the 232,448 a block may use."""
    wdt = getattr(torch, dtype)
    for name, cfg in {**CPU_WIDTHS, **CARD_WIDTHS}.items():
        assert G.kernel_limits_error(cfg, wdt) is None, name
    slots = lambda c: G.kernel_smem(
        len(c.dilations), c.residual_channels, c.dilation_channels,
        c.skip_channels, c.out_channels, c.initial_filter_width, wdt)[1]
    assert slots(TWICE) == (3 if dtype == "bfloat16" else 1)
    assert slots(MOON) == (8 if dtype == "bfloat16" else 4)
    assert G.kernel_limits_error(dataclasses.replace(
        MOON, residual_channels=128, dilation_channels=128), wdt) is None
    error = G.kernel_limits_error(CEILING, wdt)
    assert error is not None
    assert "shared memory" in error and "232,448" in error
    blocks, _, nbytes = G.kernel_plan(50, 256, 256, 512, 30, 32, wdt)
    assert f"{nbytes:,}" in error and nbytes > G.SMEM_LIMIT
    assert blocks == 8 and "8 blocks" in error


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _inputs(cfg, dev, weight_dtype, B=2, T=128, seed=0):
    packed = G.pack_params(cfg, convert.seeded_params(cfg, 1, dev),
                           weight_dtype)
    gen = torch.Generator(dev).manual_seed(seed)
    proj = G.precompute_lc_proj(
        packed, torch.randn(B, T, 80, generator=gen, device=dev))
    n = cfg.out_channels
    primed = (torch.randint(0, n, (T, B), generator=gen, device=dev).float()
              if not cfg.scalar_input else
              0.3 * torch.randn(T, B, generator=gen, device=dev))
    return packed, proj, primed


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_WIDTHS))
def test_cuda_f32_kernel_matches_twin_at_width(name):
    """f32, 2 streams: teacher-forced 128 steps within 1e-4 (MoL) or 99.9%
    of the classes equal (softmax), then free-running 64 steps within 1e-3
    (the same classes): sums in another order."""
    dev = _cuda()
    cfg = CARD_WIDTHS[name]
    packed, proj, primed = _inputs(cfg, dev, torch.float32)
    kw = dict(deterministic=True, primed=primed, prime_len=proj.shape[1])
    before = G.wavenet_generate.launches
    got = G.wavenet_generate(packed, proj, **kw)
    torch.cuda.synchronize()
    assert G.wavenet_generate.launches == before + 1
    want = G.generate_plain(packed, proj, **kw)
    free = proj[:, :64].contiguous()
    got_free = G.wavenet_generate(packed, free, deterministic=True)
    want_free = G.generate_plain(packed, free, deterministic=True)
    if cfg.scalar_input:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        torch.testing.assert_close(got_free, want_free, rtol=0, atol=1e-3)
        assert float(want_free.std()) > 0
    else:
        assert float((got == want).float().mean()) >= 0.999
        assert torch.equal(got_free, want_free)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_WIDTHS))
def test_cuda_bf16_kernel_matches_twin_at_width(name):
    """bf16, teacher-forced 512 steps on 4 streams, held as chip_smoke.py's
    compare_bf16 holds it at these widths, to the bf16 twin's own distance
    from the f32 kernel: the mean error and the share of component flips
    (steps off by more than 1e-2) at most twice the twin's; over the first
    64 steps, the steps that are not flips within 1e-3 or twice the twin's
    there, whichever is larger (a wider network carries more bf16 rounding
    steps, and meets near-tied components early); softmax classes 95%
    equal and at most twice the twin's share apart."""
    dev = _cuda()
    cfg = CARD_WIDTHS[name]
    packed, proj, primed = _inputs(cfg, dev, torch.bfloat16, B=4, T=512)
    kw = dict(deterministic=True, primed=primed, prime_len=proj.shape[1])
    k16 = G.wavenet_generate(packed, proj, **kw)
    t16 = G.generate_plain(packed, proj, **kw)
    packed32 = G.pack_params(cfg, convert.seeded_params(cfg, 1, dev))
    k32 = G.wavenet_generate(packed32, proj, **kw)
    assert bool(torch.isfinite(k16).all())
    if cfg.scalar_input:
        e_kt, e_tf = (k16 - t16).abs(), (t16 - k32).abs()
        early = lambda e: float(e[:, :64][e[:, :64] <= 1e-2].max())
        assert early(e_kt) <= max(1e-3, 2 * early(e_tf))
        assert float(e_kt.mean()) <= 2 * float(e_tf.mean())
        flips = lambda e: float((e > 1e-2).float().mean())
        assert flips(e_kt) <= 2 * flips(e_tf)
    else:
        differ = float((k16 != t16).float().mean())
        assert differ <= 0.05
        assert differ <= 2 * float((t16 != k32).float().mean())


@pytest.mark.cuda
def test_cuda_smem_bytes_match_python():
    """The library's shared-memory bytes and weight slots equal
    ``kernel_smem``'s at every tested width, the ceiling's and wn_moon's,
    both weight types."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.build import (
        load_library)
    _cuda()
    lib = load_library("wavenet_gen")
    cfgs = {**CARD_WIDTHS, **CPU_WIDTHS, "ceiling": CEILING, "moon": MOON}
    for name, c in cfgs.items():
        W = c.initial_filter_width if c.scalar_input else c.filter_width
        args = (len(c.dilations), c.residual_channels, c.dilation_channels,
                c.skip_channels, c.out_channels, W)
        for wdt in G.WEIGHT_DTYPES:
            bf16 = int(wdt == torch.bfloat16)
            assert (lib.wavenet_gen_smem_bytes(*args, bf16),
                    lib.wavenet_gen_slots(*args, bf16)) == \
                G.kernel_smem(*args, wdt), (name, wdt)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["twice", "r64_d32", "r32_d64", "tiny",
                                  "w40_mol40", "softmax_q300"])
def test_cuda_generator_serves_width(name):
    """``WaveNetGenerator`` on the card constructs each width (bf16) and
    vocodes a 4-frame mel in one launch: finite samples in [-1, 1]."""
    _cuda()
    cfg = CARD_WIDTHS[name]
    hop = int(np.prod(cfg.upsample_factor))
    gen = WaveNetGenerator(Config(audio=AudioConfig(hop_size=hop),
                                  wavenet=cfg),
                           convert.seeded_params(cfg, 0), device="cuda")
    mel = np.random.default_rng(0).standard_normal((4, 80)).astype(
        np.float32)
    before = G.wavenet_generate.launches
    wav = gen.generate(mel)
    assert G.wavenet_generate.launches == before + 1
    assert wav.shape == (4 * hop,) and np.isfinite(wav).all()
    assert np.abs(wav).max() <= 1.0
