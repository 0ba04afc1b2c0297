"""Griffin-Lim phase reconstruction on the tensor's device (counterpart of
the JAX package's ``dsp/griffin_lim.py``): a random initial phase, one
``istft``, then ``n_iters`` rounds of ``stft`` -> keep the phase ->
``istft``, computed in complex64 and float32 whatever the caller's type.

The JAX function draws its initial phase with ``jax.random`` (threefry),
which this port does not reproduce: the phase comes from one function,
``initial_phase``, drawing from a ``torch.Generator`` on the device, and
every entry point also takes the phase itself (``phase=``), so the same
uniforms can be fed to both.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import AudioConfig
from .stft import (db_to_amp, denormalize, inv_preemphasis, istft,
                   mel_to_linear, stft)


def initial_phase(shape: Tuple[int, ...], seed: int,
                  device: torch.device) -> torch.Tensor:
    """Uniform phases in [0, 2 pi), float32, drawn on ``device`` from a
    generator seeded with ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=g, device=device) * (2 * math.pi)


def griffin_lim(magnitude: torch.Tensor, cfg: AudioConfig,
                n_iters: Optional[int] = None, seed: int = 0,
                phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear magnitude spectrogram [num_freq, frames] -> waveform
    [(frames - 1) * hop_size].  ``phase`` [num_freq, frames] replaces the
    draw of ``initial_phase(shape, seed)``."""
    if n_iters is None:
        n_iters = cfg.griffin_lim_iters
    mag = magnitude.abs().float()
    if phase is None:
        phase = initial_phase(tuple(mag.shape), seed, mag.device)
    y = istft(mag * torch.exp(1j * phase.float()), cfg)
    frames = mag.shape[1]
    for _ in range(n_iters):
        est = stft(y, cfg)
        ang = est / torch.clamp(est.abs(), min=1e-8)
        # stft may give a frame more than the target; keep the target's.
        y = istft(mag * ang[:, :frames], cfg)
    return y


def inv_linear_spectrogram(linear: torch.Tensor, cfg: AudioConfig,
                           seed: int = 0,
                           phase: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Normalized linear spectrogram [num_freq, frames] (any float type,
    bf16 too) -> waveform."""
    D = denormalize(linear.float(), cfg)
    mag = db_to_amp(D + cfg.ref_level_db)
    y = griffin_lim(mag ** cfg.power, cfg, seed=seed, phase=phase)
    return inv_preemphasis(y, cfg.preemphasis, cfg.preemphasize)


def inv_mel_spectrogram(mel: torch.Tensor, cfg: AudioConfig, seed: int = 0,
                        phase: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Normalized mel spectrogram [num_mels, frames] -> waveform, through
    the filterbank's pseudo-inverse."""
    D = denormalize(mel.float(), cfg)
    mag = mel_to_linear(db_to_amp(D + cfg.ref_level_db), cfg)
    y = griffin_lim(mag ** cfg.power, cfg, seed=seed, phase=phase)
    return inv_preemphasis(y, cfg.preemphasis, cfg.preemphasize)
