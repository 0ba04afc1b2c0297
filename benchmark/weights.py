"""Weights made by the benchmark from ``--seed``, on the device, in a few
large calls: one normal draw for every parameter, scaled and offset by
per-parameter constants.  The program and the reference are each handed a
set made from the same seed; neither reads the other's.

Names and shapes are the WaveNet's flat parameter names (nested names
joined by ``/``), worked out here from a configuration's sizes.  The
scales are flax's initialisers (glorot-normal stack, lecun-normal post and
upsampler kernels, zero biases), and for the mixture-of-logistics head the
log-scale columns of the output kernel are scaled by 0.1 and their biases
start at -3: the components' means then spread over about +-0.2, their
logits about as widely, and the sampled signal is neither silent nor
clipped.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def wavenet_shapes(w: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of a WaveNet configuration's ``wavenet`` group
    (no speaker conditioning, no weight normalisation)."""
    if w.get("num_speakers", 1) > 1 or w.get("weight_normalization"):
        raise ValueError("speaker conditioning and weight normalisation "
                         "are not made here")
    R, D, S = (w["residual_channels"], w["dilation_channels"],
               w["skip_channels"])
    M = w["local_condition_channels"]
    scalar = w["scalar_input"]
    C = w["out_channels"] if scalar else w["quantization_channels"]
    cin = 1 if scalar else w["quantization_channels"]
    width = w["initial_filter_width"] if scalar else w["filter_width"]
    fw = w["filter_width"]
    shapes = {"causal_kernel": (width, cin, R)}
    for i in range(len(w["dilations"])):
        for kind in ("filter", "gate"):
            shapes[f"layer_{i}_{kind}_kernel"] = (fw, R, D)
            shapes[f"layer_{i}_lc_{kind}"] = (M, D)
            if w["use_biases"]:
                shapes[f"layer_{i}_{kind}_bias"] = (D,)
        shapes[f"layer_{i}_res_kernel"] = (D, R)
        shapes[f"layer_{i}_skip_kernel"] = (D, S)
        if w["use_biases"]:
            shapes[f"layer_{i}_res_bias"] = (R,)
            shapes[f"layer_{i}_skip_bias"] = (S,)
    shapes["post_1/kernel"] = (S, S)
    shapes["post_2/kernel"] = (S, C)
    if w["use_biases"]:
        shapes["post_1/bias"] = (S,)
        shapes["post_2/bias"] = (C,)
    for i, f in enumerate(w["upsample_factor"]):
        shapes[f"upsampler/upsample_{i}/kernel"] = (f, fw, 1, 1)
    return shapes


def _scale(name: str, shape: Tuple[int, ...], w: dict) -> float:
    if name.endswith("bias"):
        return 0.0
    if name.startswith(("post_", "upsampler/")):
        return 1.0 / math.sqrt(math.prod(shape[:-1]))
    rf = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return math.sqrt(2.0 / (shape[-2] * rf + shape[-1] * rf))


def wavenet_weights(w: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 parameters on ``device`` from ``seed``."""
    shapes = wavenet_shapes(w)
    names = list(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    scale = torch.tensor([_scale(k, shapes[k], w) for k in names],
                         dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat = flat * torch.repeat_interleave(scale, counts)
    out = dict(zip(names, (v.view(shapes[k]) for k, v in
                           zip(names, torch.split(flat, sizes)))))
    if w["scalar_input"]:
        nr = w["out_channels"] // 3
        out["post_2/kernel"][:, 2 * nr:] *= 0.1
        if w["use_biases"]:
            out["post_2/bias"][2 * nr:] = -3.0
    return out
