"""PyTorch port: the Upsampler against the JAX package's flax Upsampler,
and the generation path's plain sampler (the kernel's twin, which CPU
tensors take) against the JAX scan sampler (f32, CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu.config import WaveNetConfig
from tacotron_wavenet_vocoder_korean_tpu.models import wavenet as JW
from tacotron_wavenet_vocoder_korean_tpu_torch import convert
from tacotron_wavenet_vocoder_korean_tpu_torch.models import mixture as PX
from tacotron_wavenet_vocoder_korean_tpu_torch.models import wavenet as PW
from tacotron_wavenet_vocoder_korean_tpu_torch.ops import wavenet_gen as G
from torch_port_util import (
    RNG, TINY, TINY_GC, jax_params, make_inputs, port_cfg, scan_uniforms, t)


@pytest.fixture(scope="module")
def tiny():
    params = jax_params(TINY)
    return params, G.pack_params(port_cfg(TINY), convert.params_from_jax(
        port_cfg(TINY), params))


@pytest.fixture(scope="module")
def tiny_gc():
    params = jax_params(TINY_GC)
    return params, G.pack_params(port_cfg(TINY_GC), convert.params_from_jax(
        port_cfg(TINY_GC), params))


@pytest.mark.parametrize("factors,frames", [((2, 5), 12), ((5, 5, 12), 7)],
                         ids=["tiny", "wn_moon"])
def test_upsampler_matches_flax(factors, frames):
    """Hand-built transposed convolution (no kernel flip, asymmetric SAME
    padding on the mel axis) against flax ConvTranspose: <= 1e-5."""
    cfg = dataclasses.replace(TINY, upsample_factor=factors)
    mel = np.random.default_rng(1).standard_normal(
        (2, frames, 80)).astype(np.float32) * 2
    up = JW.Upsampler(cfg)
    variables = up.init(jax.random.PRNGKey(3), jnp.asarray(mel))
    # non-symmetric kernels, so a flip or a misplaced pad shows
    variables = jax.tree.map(
        lambda k: k + jnp.arange(k.size, dtype=k.dtype).reshape(k.shape)
        * 0.05, variables)
    want = np.asarray(up.apply(variables, jnp.asarray(mel)))
    params = {f"upsampler/{k}/kernel": t(v["kernel"])
              for k, v in variables["params"].items()}
    got = PW.Upsampler(port_cfg(cfg)).load_params(params)(t(mel)).numpy()
    assert got.shape == (2, frames * int(np.prod(factors)), 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("gc", [False, True], ids=["plain", "gc"])
def test_teacher_forced_logits_match_jax(gc, tiny, tiny_gc):
    """A fully teacher-forced run (every step's input given, so nothing
    compounds) against the JAX per-step logits read through both sampling
    heads: the argmax component's mean, and a draw on given uniforms (it
    reads the log-scales too).  <= 1e-4."""
    jp, packed = tiny_gc if gc else tiny
    cfg = TINY_GC if gc else TINY
    audio, mel = make_inputs(B=2, frames=6)
    lc = np.asarray(JW.Upsampler(cfg).apply(
        {"params": jp["upsampler"]}, jnp.asarray(mel)))
    g = np.asarray(jp["gc_embedding"])[[1, 0]] if gc else None
    logits = t(JW.teacher_forced_incremental(
        cfg, jp, jnp.asarray(audio), jnp.asarray(lc),
        None if g is None else jnp.asarray(g)))         # [B, T, C]
    nr = cfg.out_channels // 3
    T = lc.shape[1]
    u = torch.rand(T, 2, nr + 1, generator=torch.Generator().manual_seed(1))
    run = lambda **kw: G.incremental_generate_cuda(
        port_cfg(cfg), packed, t(lc), gc=None if g is None else t(g),
        seed_audio=t(audio), **kw).numpy()

    idx = torch.argmax(logits[..., :nr], dim=-1, keepdim=True)
    want = torch.gather(logits[..., nr:2 * nr], -1, idx)[..., 0].clamp(-1, 1)
    np.testing.assert_allclose(run(deterministic=True), want.numpy(),
                               rtol=0, atol=1e-4)
    want = PX.sample_from_discretized_mix_logistic(
        logits, uniforms=(u[..., :nr].transpose(0, 1), u[..., nr].T))
    np.testing.assert_allclose(run(noise=u), want.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", ["plain", "gc", "seed_audio"])
def test_deterministic_rollout_matches_jax(case, tiny, tiny_gc):
    """Free-running deterministic generation (argmax component mean):
    <= 1e-4 over 80 samples, with speaker conditioning or seed priming."""
    jp, packed = tiny_gc if case == "gc" else tiny
    cfg = TINY_GC if case == "gc" else TINY
    audio, mel = make_inputs(B=2, frames=8)
    lc = np.asarray(JW.Upsampler(cfg).apply(
        {"params": jp["upsampler"]}, jnp.asarray(mel)))
    g = np.asarray(jp["gc_embedding"])[[0, 1]] if case == "gc" else None
    seed = audio[:, :27] if case == "seed_audio" else None
    want = np.asarray(JW.incremental_generate(
        cfg, jp, jnp.asarray(lc), RNG,
        gc=None if g is None else jnp.asarray(g),
        seed_audio=None if seed is None else jnp.asarray(seed),
        deterministic=True))
    got = G.incremental_generate_cuda(
        port_cfg(cfg), packed, t(lc), gc=None if g is None else t(g),
        seed_audio=None if seed is None else t(seed),
        deterministic=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert want.std() > 1e-3


def test_stochastic_rollout_matches_jax_given_its_uniforms(tiny_gc):
    """The scan sampler's own per-step draws, replayed into the port as its
    noise tensor: <= 1e-4 over 60 samples (speaker-conditioned)."""
    jp, packed = tiny_gc
    _, mel = make_inputs(B=2, frames=6)
    lc = np.asarray(JW.Upsampler(TINY_GC).apply(
        {"params": jp["upsampler"]}, jnp.asarray(mel)))
    g = np.asarray(jp["gc_embedding"])[[1, 1]]
    rng = jax.random.PRNGKey(11)
    want = np.asarray(JW.incremental_generate(
        TINY_GC, jp, jnp.asarray(lc), rng, gc=jnp.asarray(g)))
    u_sel, u = scan_uniforms(rng, lc.shape[1], 2, TINY_GC.out_channels // 3)
    noise = t(np.concatenate([u_sel, u[..., None]], axis=-1))
    got = G.incremental_generate_cuda(
        port_cfg(TINY_GC), packed, t(lc), gc=t(g), noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert want.std() > 1e-3


def test_quantized_input_is_refused(tiny):
    """mulaw-quantize (one-hot input, softmax head) is refused before any
    packing or sampling; the scalar-input config is taken."""
    cfg = port_cfg(WaveNetConfig(input_type="mulaw-quantize",
                                 scalar_input=False))
    with pytest.raises(NotImplementedError):
        PW.require_scalar_input(cfg)
    with pytest.raises(NotImplementedError):
        G.incremental_generate_cuda(cfg, tiny[1], torch.zeros(1, 4, 80),
                                    deterministic=True)
    PW.require_scalar_input(port_cfg(TINY))
