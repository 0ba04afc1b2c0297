"""WaveNet parameters for the port: from the JAX package's flax tree, from
an ``.npz`` of JAX-named arrays, or made from a seed.

The port's state is a flat dict of float32 tensors keyed by the JAX flat
names, nested flax names joined by ``/`` (``post_1/kernel``,
``upsampler/upsample_0/kernel``).  Weight-normalized trees are folded first,
as the JAX package's ``materialize_wn_params`` folds them.  Every name the
port reads must be present with its shape, and nothing else may be left
over.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import WaveNetConfig
from .models.wavenet import Params, materialize_wn_params


def gc_enabled(cfg: WaveNetConfig) -> bool:
    return cfg.num_speakers > 1


def param_shapes(cfg: WaveNetConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter the generation path reads, with its shape."""
    R, D, S = (cfg.residual_channels, cfg.dilation_channels,
               cfg.skip_channels)
    G, M = cfg.gc_channels, cfg.local_condition_channels
    # The softmax head has one logit per class (the JAX model's n_out).
    C = cfg.out_channels if cfg.scalar_input else cfg.quantization_channels
    cin = 1 if cfg.scalar_input else cfg.quantization_channels
    width = cfg.initial_filter_width if cfg.scalar_input else cfg.filter_width
    shapes = {"causal_kernel": (width, cin, R)}
    for i in range(len(cfg.dilations)):
        for kind in ("filter", "gate"):
            shapes[f"layer_{i}_{kind}_kernel"] = (cfg.filter_width, R, D)
            shapes[f"layer_{i}_lc_{kind}"] = (M, D)
            if cfg.use_biases:
                shapes[f"layer_{i}_{kind}_bias"] = (D,)
            if gc_enabled(cfg):
                shapes[f"layer_{i}_gc_{kind}"] = (G, D)
        shapes[f"layer_{i}_res_kernel"] = (D, R)
        shapes[f"layer_{i}_skip_kernel"] = (D, S)
        if cfg.use_biases:
            shapes[f"layer_{i}_res_bias"] = (R,)
            shapes[f"layer_{i}_skip_bias"] = (S,)
    shapes["post_1/kernel"] = (S, S)
    shapes["post_2/kernel"] = (S, C)
    if cfg.use_biases:
        shapes["post_1/bias"] = (S,)
        shapes["post_2/bias"] = (C,)
    if gc_enabled(cfg):
        shapes["gc_embedding"] = (cfg.num_speakers, G)
    for i, f in enumerate(cfg.upsample_factor):
        shapes[f"upsampler/upsample_{i}/kernel"] = (f, cfg.filter_width, 1, 1)
    return shapes


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> flat dict with ``/``-joined keys."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def _unflatten_top(flat: Mapping[str, np.ndarray]) -> dict:
    """Undo ``flatten`` for the ``post_N`` sub-dicts weight-norm folding
    expects; everything else stays flat."""
    out: dict = {}
    for k, v in flat.items():
        if k.startswith(("post_1/", "post_2/")):
            head, leaf = k.split("/", 1)
            out.setdefault(head, {})[leaf] = v
        else:
            out[k] = v
    return out


def params_from_jax(cfg: WaveNetConfig, tree: Mapping,
                    device: Optional[torch.device] = None) -> Params:
    """The port's state from a JAX WaveNet param tree (nested as flax makes
    it, or flat with ``/``-joined names), weight-norm pairs folded.  Raises
    on a missing name, a wrong shape, or a name left unused."""
    flat = flatten(tree)
    folded = flatten(materialize_wn_params(cfg, _unflatten_top(flat)))
    shapes = param_shapes(cfg)
    missing = sorted(set(shapes) - set(folded))
    unused = sorted(set(folded) - set(shapes))
    if missing or unused:
        raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                       f"unused {unused[:5]}")
    out = {}
    for k, shape in shapes.items():
        v = np.asarray(folded[k], np.float32)
        if v.shape != shape:
            raise ValueError(f"{k}: shape {v.shape}, expected {shape}")
        out[k] = torch.from_numpy(v.copy()).to(device)
    return out


def params_from_npz(cfg: WaveNetConfig, path: str,
                    device: Optional[torch.device] = None) -> Params:
    """The port's state from an ``.npz`` of JAX-named arrays (flat names,
    nested ones joined by ``/``)."""
    with np.load(path) as f:
        return params_from_jax(cfg, {k: f[k] for k in f.files}, device)


def seeded_tree(cfg: WaveNetConfig, seed: int) -> Dict[str, np.ndarray]:
    """Random full-width parameters in the JAX layout, from a numpy seed, at
    flax's init scales (glorot-normal stack, lecun-normal post and
    upsampler kernels, zero biases).  For the mixture-of-logistics head two
    changes keep random weights in a useful range: the output layer is
    scaled down and the log-scale biases start at -3, so the sampled signal
    is neither silent nor clipped.  The softmax head keeps flax's scales."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in param_shapes(cfg).items():
        if k.endswith("bias"):
            v = np.zeros(shape)
        elif k.startswith(("post_", "upsampler/")):
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            rf = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
            fan_in = shape[-2] * rf if len(shape) > 1 else 1
            std = np.sqrt(2.0 / (fan_in + shape[-1] * rf))
            v = rng.standard_normal(shape) * std
        out[k] = v.astype(np.float32)
    if cfg.scalar_input:
        nr = cfg.out_channels // 3
        out["post_2/kernel"] *= 0.1
        if cfg.use_biases:
            out["post_2/bias"][2 * nr:] = -3.0
    return out


def seeded_params(cfg: WaveNetConfig, seed: int,
                  device: Optional[torch.device] = None) -> Params:
    return params_from_jax(cfg, seeded_tree(cfg, seed), device)
