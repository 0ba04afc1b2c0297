"""PyTorch port: mu-law family and mixture-of-logistics sampler against the
JAX package."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import dsp as jdsp
from tacotron_wavenet_vocoder_korean_tpu.models import mixture as JM
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp import mulaw as PM
from tacotron_wavenet_vocoder_korean_tpu_torch.models import mixture as PX
from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
    _mol_sample)

X = np.concatenate([np.linspace(-1, 1, 201),
                    np.random.default_rng(0).uniform(-1, 1, 300)]
                   ).astype(np.float32)


@pytest.mark.parametrize("name,mu", [
    ("mulaw", 256), ("inv_mulaw", 256), ("mulaw", 65536),
    ("mulaw_quantize", 256), ("inv_mulaw_quantize", 256)])
def test_mulaw_family_matches_jax(name, mu):
    """Tolerance 1e-6 (f32; the port divides by log1p(mu) in double)."""
    x = X
    if name == "inv_mulaw_quantize":
        x = np.arange(mu, dtype=np.float32)
    got = getattr(PM, name)(torch.from_numpy(x), mu).numpy()
    want = np.asarray(getattr(jdsp, name)(jnp.asarray(x), mu))
    if name == "mulaw_quantize":
        assert got.dtype == np.int32
        # floor of a value computed in another order: allow one class
        # where the JAX value sits within rounding of a class edge
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        assert (got == want).mean() > 0.99
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _mol_inputs(seed=0, n=64, nr=10):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, 1, 3 * nr)).astype(np.float32)
    y[:8, :, nr:2 * nr] = 3.0 * np.sign(y[:8, :, nr:2 * nr])  # clip edges
    y[8:16, :, 2 * nr:] = -60.0                                # scale floor
    y[16:24, :, 2 * nr:] = 2.0                                 # wide, clips
    return y


def test_mol_sampler_matches_jax_given_the_same_uniforms():
    """The JAX sampler's own draws, fed to the port: <= 1e-6, including
    means beyond [-1, 1] (clip) and log-scales below log(1e-14) (floor)."""
    y = _mol_inputs()
    nr = y.shape[-1] // 3
    rng = jax.random.PRNGKey(7)
    want = np.asarray(JM.sample_from_discretized_mix_logistic(
        rng, jnp.asarray(y)))
    r_sel, r_u = jax.random.split(rng)
    u_sel = np.array(jax.random.uniform(r_sel, y.shape[:-1] + (nr,),
                                          minval=1e-5, maxval=1 - 1e-5))
    u = np.array(jax.random.uniform(r_u, y.shape[:-1], minval=1e-5,
                                      maxval=1 - 1e-5))
    got = PX.sample_from_discretized_mix_logistic(
        torch.from_numpy(y), uniforms=(torch.from_numpy(u_sel),
                                       torch.from_numpy(u))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() <= 1.0
    assert (np.abs(got[:8]) == 1.0).any()          # the clip edge is hit
    assert PX.LOG_SCALE_MIN == JM.LOG_SCALE_MIN == math.log(1e-14)


def test_mol_sampler_clips_uniforms_and_uses_the_generator():
    y = torch.from_numpy(_mol_inputs(1)[:, 0])
    nr = y.shape[-1] // 3
    # uniforms at 0 and 1 are clipped to [1e-5, 1-1e-5]: finite samples
    edge = PX.sample_from_discretized_mix_logistic(
        y, uniforms=(torch.zeros(len(y), nr), torch.ones(len(y))))
    assert torch.isfinite(edge).all()
    a = PX.sample_from_discretized_mix_logistic(
        y, generator=torch.Generator().manual_seed(3))
    b = PX.sample_from_discretized_mix_logistic(
        y, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_kernel_head_equals_sampler_and_averages_ties():
    """The kernel's sampling head (plain twin) equals the port's sampler
    on the same uniforms; in deterministic mode it averages tied maxima as
    the Pallas kernel does, where the scan sampler takes the first."""
    y = torch.from_numpy(_mol_inputs(2)[:, 0])
    nr = y.shape[-1] // 3
    u = torch.rand(len(y), nr + 1, generator=torch.Generator().manual_seed(0))
    got = _mol_sample(y, False, u)
    want = PX.sample_from_discretized_mix_logistic(
        y, uniforms=(u[:, :nr], u[:, nr]))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)

    tied = torch.zeros(1, 3 * nr)
    tied[0, [2, 5]] = 1.0                      # two equal top logits
    tied[0, nr + 2], tied[0, nr + 5] = 0.2, 0.6
    assert float(_mol_sample(tied, True, None)) == pytest.approx(0.4)
