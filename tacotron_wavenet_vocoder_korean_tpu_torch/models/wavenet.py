"""WaveNet generation half: weight-norm folding and the mel ``Upsampler``.

Counterpart of the JAX package's ``models/wavenet.py`` (``wn_weight``,
``materialize_wn_params``, ``Upsampler``).  The sampler itself lives in
``ops/wavenet_gen.py``: the generation kernel's wrapper and its plain
twin ``generate_plain``, which is the CPU path and the reference the kernel
is held against.

Parameters are a flat dict of tensors keyed by the JAX package's flat
names, nested flax names joined by ``/`` (``post_1/kernel``,
``upsampler/upsample_0/kernel``); ``convert.py`` builds it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WaveNetConfig

Params = Dict[str, torch.Tensor]


def wn_weight(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Weight normalization: w = g * v / ||v||, the norm reduced over every
    axis but the last (output features)."""
    v = np.asarray(v, np.float32)
    norm = np.sqrt(np.sum(np.square(v), axis=tuple(range(v.ndim - 1)),
                          keepdims=True) + 1e-12)
    return v * (np.asarray(g, np.float32) / norm)


def materialize_wn_params(cfg: WaveNetConfig, params: dict) -> dict:
    """Fold ``<name>_v`` / ``<name>_g`` pairs of a weight-normalized tree
    into ``<name>`` and restore the nested ``post_N`` layout.  No-op when
    ``cfg.weight_normalization`` is off."""
    if not cfg.weight_normalization:
        return params
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = v
        elif k.endswith("_v"):
            out[k[:-2]] = wn_weight(v, params[k[:-2] + "_g"])
        elif not k.endswith("_g"):
            out[k] = v
    for p in ("post_1", "post_2"):
        if p + "_kernel" in out:
            sub = {"kernel": out.pop(p + "_kernel")}
            if p + "_bias" in out:
                sub["bias"] = out.pop(p + "_bias")
            out[p] = sub
    return out


def _conv_transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """Before/after padding of a SAME transposed convolution, as
    ``lax.conv_transpose`` computes it (asymmetric for even kernels)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class Upsampler(torch.nn.Module):
    """mel (frame rate) -> sample-rate local condition: stacked transposed
    convolutions, kernel (factor, filter_width), stride (factor, 1), SAME
    padding, no bias, one input and one output channel.

    Written out by hand: the input is dilated by the stride, padded as
    ``lax.conv_transpose`` pads it, and cross-correlated with the kernel as
    it is stored (flax does not flip it; ``conv_transpose2d`` would)."""

    def __init__(self, cfg: WaveNetConfig):
        super().__init__()
        self.factors = tuple(cfg.upsample_factor)
        self.kernels = torch.nn.ParameterList(
            torch.nn.Parameter(torch.zeros(f, cfg.filter_width),
                               requires_grad=False)
            for f in self.factors)

    def load_params(self, params: Params) -> "Upsampler":
        """Take ``upsampler/upsample_i/kernel`` [factor, fw, 1, 1]."""
        for i, k in enumerate(self.kernels):
            k.data.copy_(params[f"upsampler/upsample_{i}/kernel"][:, :, 0, 0])
        return self

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, frames, num_mels] -> [B, frames*hop, num_mels]."""
        x = mel[:, None]                                  # [B, 1, F, M]
        for f, k in zip(self.factors, self.kernels):
            B, _, H, W = x.shape
            kh, kw = k.shape
            dil = x.new_zeros(B, 1, (H - 1) * f + 1, W)
            dil[:, :, ::f] = x
            ph = _conv_transpose_padding(kh, f)
            pw = _conv_transpose_padding(kw, 1)
            x = F.conv2d(F.pad(dil, (pw[0], pw[1], ph[0], ph[1])),
                         k[None, None].to(x.dtype))
        return x[:, 0]
