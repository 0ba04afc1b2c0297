"""PyTorch port: the generation kernel's packing, lc projection and plain
twin against the JAX package's Pallas kernel (interpret mode) and scan
sampler.  The CUDA kernel itself is tested in test_torch_cuda.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW
from tacotron_wavenet_vocoder_korean_tpu.ops import wavenet_pallas as JP
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.ops import wavenet_gen as G
from torch_port_util import (
    RNG, TINY, TINY_GC, jax_params, make_inputs, port_cfg, scan_uniforms, t)


@pytest.fixture(scope="module")
def tiny():
    jp = jax_params(TINY)
    pp = convert.params_from_jax(port_cfg(TINY), jp)
    _, mel = make_inputs(B=2, frames=10)
    lc = np.asarray(JW.Upsampler(TINY).apply({"params": jp["upsampler"]},
                                             jnp.asarray(mel)))
    return jp, G.pack_params(port_cfg(TINY), pp), lc


@pytest.mark.parametrize("primed", [False, True], ids=["free", "primed"])
def test_plain_twin_matches_pallas_kernel_interpret(primed, tiny):
    """The twin against the Pallas kernel run as the JAX tests run it
    (interpret mode, f32 weights, deterministic, chunk 32; T = 100 is
    ragged against the chunk): <= 1e-4."""
    jp, packed, lc = tiny
    audio, _ = make_inputs(B=2, frames=10, seed=5)
    seed = audio[:, :37] if primed else None
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JP.pallas_incremental_generate(
            TINY, jp, jnp.asarray(lc), RNG, chunk=32, deterministic=True,
            weight_dtype=jnp.float32,
            seed_audio=None if seed is None else jnp.asarray(seed)))
    before = G.wavenet_generate.launches
    got = G.incremental_generate_cuda(
        port_cfg(TINY), packed, t(lc),
        seed_audio=None if seed is None else t(seed),
        deterministic=True).numpy()
    assert G.wavenet_generate.launches == before   # CPU: twin, no launch
    assert got.shape == want.shape == (2, 100)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert want.std() > 1e-3


def test_lc_projection_matches_pallas_packing():
    """Layer biases and the speaker row fold into the lc projection as the
    JAX packing folds them (fuse_block 1 adds no residual-bias cross
    terms): <= 1e-5."""
    jp = jax_params(TINY_GC)
    # nonzero biases, so their placement is checked
    jp = {k: (v + 0.1 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape)
              / v.size if k.endswith("bias") else v) for k, v in jp.items()}
    packed = G.pack_params(port_cfg(TINY_GC),
                           convert.params_from_jax(port_cfg(TINY_GC), jp))
    jpack = JP.pack_params(TINY_GC, jp, weight_dtype=jnp.float32,
                           fuse_block=1)
    lc = np.random.default_rng(0).standard_normal((2, 30, 80)).astype(
        np.float32)
    g = np.asarray(jp["gc_embedding"])[[1, 0]]
    want = np.stack([np.asarray(JP.precompute_lc_proj(
        jpack, jnp.asarray(lc[b]), jnp.asarray(g[b]))) for b in range(2)])
    got = G.precompute_lc_proj(packed, t(lc), t(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(packed["skip_bias"].numpy(),
                               np.asarray(jpack["skip_bias"]), atol=1e-6)


def test_plain_twin_matches_scan_sampler_stochastic_gc_seeded():
    """Stochastic twin fed the scan sampler's own uniforms as its noise
    tensor, with speaker conditioning and seed priming: <= 1e-4."""
    jp = jax_params(TINY_GC)
    packed = G.pack_params(port_cfg(TINY_GC),
                           convert.params_from_jax(port_cfg(TINY_GC), jp))
    audio, mel = make_inputs(B=2, frames=7, seed=2)
    lc = np.asarray(JW.Upsampler(TINY_GC).apply(
        {"params": jp["upsampler"]}, jnp.asarray(mel)))
    g = np.asarray(jp["gc_embedding"])[[0, 1]]
    seed = audio[:, :23]
    rng = jax.random.PRNGKey(4)
    want = np.asarray(JW.incremental_generate(
        TINY_GC, jp, jnp.asarray(lc), rng, gc=jnp.asarray(g),
        seed_audio=jnp.asarray(seed)))
    u_sel, u = scan_uniforms(rng, lc.shape[1], 2, TINY_GC.out_channels // 3)
    noise = t(np.concatenate([u_sel, u[..., None]], axis=-1))
    got = G.incremental_generate_cuda(
        port_cfg(TINY_GC), packed, t(lc), gc=t(g), seed_audio=t(seed),
        noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_wrapper_refuses_what_it_cannot_run(tiny):
    _, packed, lc = tiny
    proj = G.precompute_lc_proj(packed, t(lc))
    with pytest.raises(ValueError, match="generator or noise"):
        G.wavenet_generate(packed, proj)
    with pytest.raises(ValueError, match="primed"):
        G.wavenet_generate(packed, proj, deterministic=True, prime_len=3)
    with pytest.raises(ValueError, match="unsupported device"):
        G.wavenet_generate(packed, proj.to("meta"), deterministic=True)
    with pytest.raises(NotImplementedError):
        G.pack_params(dataclasses.replace(port_cfg(TINY), scalar_input=False,
                                          input_type="mulaw-quantize"), {})

