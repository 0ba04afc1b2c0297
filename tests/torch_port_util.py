"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*.py):
tiny configs, JAX-initialised parameters, and the noise the JAX scan
sampler draws, so both frameworks can be fed the same numbers."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tacotron_wavenet_vocoder_korean_tpu.config import WaveNetConfig
from tacotron_wavenet_vocoder_korean_tpu.models.wavenet import WaveNet
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC

RNG = jax.random.PRNGKey(0)

# The tiny stack of tests/test_wavenet.py: rf = 22, hop = 10.
TINY = WaveNetConfig(
    dilations=(1, 2, 4, 1, 2, 4), residual_channels=8, dilation_channels=8,
    skip_channels=16, out_channels=12, initial_filter_width=8,
    upsample_factor=(2, 5), sample_size=100, batch_size=2)
TINY_GC = dataclasses.replace(TINY, num_speakers=2, gc_channels=4)
HOP = 10


def port_cfg(cfg: WaveNetConfig) -> PC.WaveNetConfig:
    """The port's WaveNetConfig with the same architecture fields."""
    names = {f.name for f in dataclasses.fields(PC.WaveNetConfig)}
    return PC.WaveNetConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                               if k in names})


def port_full_cfg(cfg: WaveNetConfig) -> PC.Config:
    return PC.Config(audio=PC.AudioConfig(
        hop_size=int(np.prod(cfg.upsample_factor))), wavenet=port_cfg(cfg))


def make_inputs(B=2, frames=12, hop=HOP, seed=0):
    rng = np.random.RandomState(seed)
    audio = rng.uniform(-0.9, 0.9, (B, frames * hop, 1)).astype(np.float32)
    mel = rng.randn(B, frames, 80).astype(np.float32)
    return audio, mel


def jax_params(cfg: WaveNetConfig, seed: int = 0):
    """flax-initialised WaveNet params (with the speaker table when the
    config has speakers)."""
    audio, mel = make_inputs(B=1, frames=12, hop=int(np.prod(
        cfg.upsample_factor)))
    args = (jnp.asarray(audio), jnp.asarray(mel))
    if cfg.num_speakers > 1:
        args += (jnp.zeros((1,), jnp.int32),)
    return WaveNet(cfg).init(jax.random.PRNGKey(seed), *args)["params"]


def scan_uniforms(rng, T: int, B: int, nr: int):
    """The uniforms the JAX scan sampler draws over T steps from ``rng``
    (``incremental_generate`` splits per step, the mixture sampler splits
    again): ``(u_sel [T, B, nr], u [T, B])`` as numpy."""
    u_sel, u = [], []
    for _ in range(T):
        rng, step = jax.random.split(rng)
        r_sel, r_u = jax.random.split(step)
        u_sel.append(np.asarray(jax.random.uniform(
            r_sel, (B, 1, nr), minval=1e-5, maxval=1.0 - 1e-5))[:, 0])
        u.append(np.asarray(jax.random.uniform(
            r_u, (B, 1), minval=1e-5, maxval=1.0 - 1e-5))[:, 0])
    return np.stack(u_sel), np.stack(u)


def nest(flat):
    """The port's flat ``/``-joined parameter dict as a nested JAX tree."""
    out = {}
    for k, v in flat.items():
        *heads, leaf = k.split("/")
        d = out
        for h in heads:
            d = d.setdefault(h, {})
        d[leaf] = jnp.asarray(v)
    return out


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))
