"""Operations and bytes of the work a cell asks for, counted from a
configuration's shapes (never from the program's layouts), and the
roofline's least time.

Operations are those of the matrix products and convolutions, a
multiply-add counting two; elementwise work (activations, biases, sums of
the residual stream, the sampling heads) is left out.  The test
``tests/test_bench_work.py`` holds these counts to
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

from .harness import HBM_BYTES_PER_S, PEAK_FLOPS

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


# ----------------------------------------------------------------------
# WaveNet
# ----------------------------------------------------------------------
def wavenet_sample_flops(w: dict) -> int:
    """One sample of the per-sample network: the front causal conv, per
    layer the filter/gate taps, the lc projection, the residual and skip
    products, then post_1 and post_2."""
    R, D, S = (w["residual_channels"], w["dilation_channels"],
               w["skip_channels"])
    L = len(w["dilations"])
    M = w["local_condition_channels"]
    fw = w["filter_width"]
    if w["scalar_input"]:
        C, front = w["out_channels"], 2 * w["initial_filter_width"] * R
    else:
        Q = w["quantization_channels"]
        C, front = Q, 2 * fw * Q * R
    layer = 2 * (fw * R * 2 * D + M * 2 * D + D * R + D * S)
    return front + L * layer + 2 * (S * S + S * C)


def upsample_flops(w: dict, frames: int) -> int:
    """The upsampler's transposed convolutions over ``frames`` mel frames:
    each output value takes ``filter_width`` products of one input
    frame."""
    M, fw = w["local_condition_channels"], w["filter_width"]
    total, rows = 0, frames
    for f in w["upsample_factor"]:
        rows *= f
        total += 2 * fw * rows * M
    return total


def wavenet_weight_count(w: dict) -> int:
    from .weights import wavenet_shapes
    return sum(math.prod(s) for s in wavenet_shapes(w).values())


def mel_to_wav_flops(w: dict, frames: Iterable[int], hop: int) -> int:
    """The upsampler, the lc projection and the per-sample network over
    each wav's own length."""
    per = wavenet_sample_flops(w)
    return sum(upsample_flops(w, n) + per * n * hop for n in frames)


def mel_to_wav_bytes(w: dict, frames: Iterable[int], hop: int,
                     weight_dtype: str) -> int:
    """The weights read once (at the serving width), each mel read once
    and each wav written once (float32)."""
    frames = list(frames)
    M = w["local_condition_channels"]
    return (wavenet_weight_count(w) * DTYPE_BYTES[weight_dtype]
            + sum(4 * n * M + 4 * n * hop for n in frames))


def train_step_flops(w: dict, batch: int, samples: int, hop: int) -> float:
    """Three times the forward operations of ``batch`` x ``samples``
    samples (forward, and a backward of twice the forward)."""
    per = wavenet_sample_flops(w) + upsample_flops(w, 1) / hop
    return 3.0 * batch * samples * per


# ----------------------------------------------------------------------
# The roofline
# ----------------------------------------------------------------------
def least_time(flops: float, nbytes: float, dtype: str
               ) -> Tuple[float, str]:
    """The least time the chip could take, and which bound sets it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
