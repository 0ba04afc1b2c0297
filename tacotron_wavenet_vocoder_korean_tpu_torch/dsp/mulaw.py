"""Mu-law companding family on tensors (counterpart of the JAX package's
``dsp/mulaw.py``)."""
from __future__ import annotations

import math

import torch


def mulaw(x: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """Compand [-1,1] -> [-1,1]: sign(x) * log1p(mu|x|) / log1p(mu)."""
    mu = float(mu)
    return torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)


def inv_mulaw(y: torch.Tensor, mu: int = 256) -> torch.Tensor:
    mu = float(mu)
    return torch.sign(y) * (1.0 / mu) * ((1.0 + mu) ** torch.abs(y) - 1.0)


def mulaw_quantize(x: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """[-1,1] -> int in [0, mu-1] (mu-1 companding then scale)."""
    m = mu - 1
    return ((mulaw(x, m) + 1) / 2 * m).to(torch.int32)


def inv_mulaw_quantize(y: torch.Tensor, mu: int = 256) -> torch.Tensor:
    m = mu - 1
    return inv_mulaw(2 * y.to(torch.float32) / m - 1, m)


def mulaw_encode(audio: torch.Tensor, quantization_channels: int = 256
                 ) -> torch.Tensor:
    """Float audio, clipped to [-1, 1] -> ids in [0, qc - 1], rounded."""
    mu = float(quantization_channels - 1)
    safe = torch.clamp(audio, -1.0, 1.0)
    magnitude = torch.log1p(mu * torch.abs(safe)) / math.log1p(mu)
    signal = torch.sign(safe) * magnitude
    return ((signal + 1) / 2 * mu + 0.5).to(torch.int32)


def mulaw_decode(ids: torch.Tensor, quantization_channels: int = 256
                 ) -> torch.Tensor:
    """Ids -> float audio in [-1, 1]."""
    mu = float(quantization_channels - 1)
    signal = 2.0 * (ids.to(torch.float32) / mu) - 1.0
    magnitude = (1.0 / mu) * ((1.0 + mu) ** torch.abs(signal) - 1.0)
    return torch.sign(signal) * magnitude
