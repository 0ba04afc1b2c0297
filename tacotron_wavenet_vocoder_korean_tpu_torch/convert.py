"""Parameters for the port: from the JAX package's flax trees, from an
``.npz`` of JAX-named arrays, or made from a seed.

WaveNet: the port's state is a flat dict of float32 tensors keyed by the
JAX flat names, nested flax names joined by ``/`` (``post_1/kernel``,
``upsampler/upsample_0/kernel``).  For serving, weight-normalized trees are
folded first, as the JAX package's ``materialize_wn_params`` folds them.
For training the pairs stay unfolded (``train_param_shapes``), and the
whole train state maps to the JAX tree and back (``to_jax_tree``,
``from_jax_tree``): ``step``, ``params``, ``ema_params`` and ``opt_state``
in optax's layout (``train/optim.py``).

Tacotron: the port's state is the ``state_dict`` of its ``nn.Module``s,
whose attribute paths follow the flax scopes (``encoder_cbhg.proj_1.conv``
is ``encoder_cbhg/proj_1/conv``).  Dense kernels [in, out] become torch's
[out, in], conv kernels [k, in, out] become [out, in, k], fused GRU
``w_ih``/``w_hh`` are transposed the same way, BatchNorm ``scale``/``bias``
and the ``batch_stats`` ``mean``/``var`` become the weight, bias and running
statistics.  A tree of flax ``GRUCell``s is fused first
(:func:`fuse_gru_params`).

Either way, every name the port reads must be present with its shape, and
nothing else may be left over.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import AudioConfig, TacotronConfig, WaveNetConfig
from .models.tacotron import Tacotron
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


# Names whose leaves are not weight-normalized in training.
_PLAIN = ("gc_embedding", "upsampler/")


def train_param_shapes(cfg: WaveNetConfig, gc_enable: bool = False
                       ) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the training graph with its shape, named as the
    JAX ``WaveNet.init`` names it.  ``gc_embedding`` and the speaker
    projections exist when ``gc_enable`` is set and the config has more
    than one speaker.  With ``weight_normalization`` each stack and post
    kernel ``<name>`` is a pair ``<name>_v`` (its shape) and ``<name>_g``
    (its last axis), and the post layers are flat: ``post_N_kernel_v``,
    ``post_N_bias``."""
    shapes = {}
    for k, shape in param_shapes(cfg).items():
        if "_gc_" in k or k == "gc_embedding":
            if not gc_enable:
                continue
        if cfg.weight_normalization:
            k = k.replace("/", "_") if k.startswith("post_") else k
            if not (k.startswith(_PLAIN) or k.endswith("bias")):
                shapes[k + "_v"] = shape
                shapes[k + "_g"] = (shape[-1],)
                continue
        shapes[k] = shape
    return shapes


def _glorot_std(shape: Tuple[int, ...]) -> float:
    rf = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return float(np.sqrt(2.0 / (shape[-2] * rf + shape[-1] * rf)))


def seeded_train_tree(cfg: WaveNetConfig, seed: int,
                      gc_enable: bool = False) -> Dict[str, np.ndarray]:
    """Initial training parameters in the JAX layout, drawn with numpy from
    ``seed`` from flax's distributions: truncated-normal glorot for the
    stack kernels and ``gc_embedding``, truncated-normal lecun for the post
    and upsampler kernels, zero biases; with weight norm, ``_v`` as the
    kernel and ``_g`` at the analytic glorot column norm
    ``std * sqrt(prod(shape[:-1]))``."""
    rng = np.random.default_rng(seed)
    shapes = train_param_shapes(cfg, gc_enable)
    out = {}
    for k, shape in shapes.items():
        if cfg.weight_normalization and k.endswith("_g"):
            v_shape = shapes[k[:-2] + "_v"]
            g0 = _glorot_std(v_shape) * float(np.sqrt(np.prod(v_shape[:-1])))
            v = np.full(shape, g0)
        elif k.endswith("bias"):
            v = np.zeros(shape)
        elif k.startswith(("post_", "upsampler/")):
            fan_in = int(np.prod(shape[:-1]))
            v = _truncated_normal(rng, shape) / np.sqrt(fan_in)
            v /= .87962566103423978
        else:
            v = (_truncated_normal(rng, shape) * _glorot_std(shape)
                 / .87962566103423978)
        out[k] = v.astype(np.float32)
    return out


def to_jax_tree(node: Any) -> Any:
    """The port's train state (or any part of it) as the JAX tree of numpy
    arrays, its nodes in the order JAX flattens them: a named tuple becomes
    the dict of its fields in field order, a dict's ``/``-joined keys
    become nested dicts with sorted keys, tensors become arrays."""
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {k: to_jax_tree(v) for k, v in node._asdict().items()}
    if isinstance(node, tuple):
        return tuple(to_jax_tree(v) for v in node)
    if isinstance(node, Mapping):
        out: dict = {}
        for k, v in node.items():
            *heads, leaf = k.split("/")
            d = out
            for h in heads:
                d = d.setdefault(h, {})
            d[leaf] = to_jax_tree(v)
        return _sorted(out)
    return np.asarray(node)


def _sorted(d: dict) -> dict:
    return {k: _sorted(d[k]) if isinstance(d[k], dict) else d[k]
            for k in sorted(d)}


def _count_leaves(node: Any) -> int:
    if isinstance(node, Mapping):
        return sum(_count_leaves(v) for v in node.values())
    if isinstance(node, (tuple, list)):
        return sum(_count_leaves(v) for v in node)
    return 1


def from_jax_tree(template: Any, node: Any, path: str = "") -> Any:
    """The inverse of ``to_jax_tree``, laid out as ``template`` (the port's
    state, or any part of it): every leaf of the template is looked up in
    the JAX tree ``node`` and must have the template's shape and dtype; it
    comes back as a tensor on the template leaf's device.  A leaf of
    ``node`` that the template does not hold raises, as a missing one
    does."""
    if isinstance(template, torch.Tensor):
        arr = np.asarray(node)
        dtype = torch.from_numpy(np.zeros(0, arr.dtype)).dtype
        if arr.shape != tuple(template.shape) or dtype != template.dtype:
            raise ValueError(f"{path}: {arr.dtype}{list(arr.shape)}, expected "
                             f"{template.dtype}{list(template.shape)}")
        return torch.from_numpy(np.array(arr)).to(template.device)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**from_jax_tree(template._asdict(), node, path))
    if isinstance(template, tuple):
        if not isinstance(node, (tuple, list)) or len(node) != len(template):
            raise KeyError(f"{path}: expected a sequence of {len(template)}")
        return tuple(from_jax_tree(t, n, f"{path}/{i}")
                     for i, (t, n) in enumerate(zip(template, node)))
    out = {}
    for k, t in template.items():
        sub = node
        for part in k.split("/"):
            if not isinstance(sub, Mapping) or part not in sub:
                raise KeyError(f"{path}/{k}: not in the tree")
            sub = sub[part]
        out[k] = from_jax_tree(t, sub, f"{path}/{k}")
    if _count_leaves(node) != _count_leaves(template):
        raise KeyError(f"{path or '/'}: the tree holds leaves the port does "
                       "not")
    return out


# ---------------------------------------------------------------------------
# Tacotron
# ---------------------------------------------------------------------------

_GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")
# Leaves stored [in, out] (or [k, in, out]) by flax, [out, in(, k)] by torch.
_TRANSPOSED = ("kernel", "w_ih", "w_hh")


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *heads, leaf = k.split("/")
        d = out
        for h in heads:
            d = d.setdefault(h, {})
        d[leaf] = v
    return out


def _is_gru_cell(d) -> bool:
    return isinstance(d, Mapping) and set(_GRU_GATES) <= set(d)


def _fuse_cell(d) -> dict:
    cat = lambda names, leaf, axis: np.concatenate(
        [np.asarray(d[n][leaf]) for n in names], axis=axis)
    return {"w_ih": cat(("ir", "iz", "in"), "kernel", 1),
            "w_hh": cat(("hr", "hz", "hn"), "kernel", 1),
            "b_ih": cat(("ir", "iz", "in"), "bias", 0),
            "b_hn": np.asarray(d["hn"]["bias"])}


def fuse_gru_params(tree):
    """Every flax ``GRUCell`` subtree (``ir/iz/in/hr/hz/hn`` Denses) in
    ``tree`` -> the fused layout (``w_ih``/``w_hh``/``b_ih``/``b_hn``),
    computing the same function: a cell named ``GRUCell_0`` under a GRU's
    scope is spliced into that scope, a cell directly at a module scope
    (the decoder's GRU cells) is replaced.  Fused trees pass unchanged."""
    if not isinstance(tree, Mapping):
        return tree
    out = {}
    for k, v in tree.items():
        if _is_gru_cell(v):
            out[k] = _fuse_cell(v)
        elif (isinstance(v, Mapping) and "GRUCell_0" in v
              and _is_gru_cell(v["GRUCell_0"])):
            rest = {kk: fuse_gru_params(vv)
                    for kk, vv in v.items() if kk != "GRUCell_0"}
            out[k] = {**rest, **_fuse_cell(v["GRUCell_0"])}
        else:
            out[k] = fuse_gru_params(v)
    return out


_FUSED_LEAVES = ("w_ih", "w_hh", "b_ih", "b_hn")
# Scopes of the JAX ``GRU`` module, whose flax ``GRUCell`` is ``GRUCell_0``
# inside them; every other fused scope is a cell itself.
_GRU_MODULE_SCOPES = ("gru_fw", "gru_bw")


def _unfuse_cell(d) -> dict:
    ir, iz, in_ = np.split(np.asarray(d["w_ih"]), 3, axis=1)
    hr, hz, hn = np.split(np.asarray(d["w_hh"]), 3, axis=1)
    br, bz, bn = np.split(np.asarray(d["b_ih"]), 3)
    return {"ir": {"kernel": ir, "bias": br}, "iz": {"kernel": iz, "bias": bz},
            "in": {"kernel": in_, "bias": bn}, "hr": {"kernel": hr},
            "hz": {"kernel": hz},
            "hn": {"kernel": hn, "bias": np.asarray(d["b_hn"])}}


def unfuse_gru_params(tree):
    """The inverse of :func:`fuse_gru_params`, exact (a split of each
    fused leaf into its gate blocks r, z, n): the fused leaves of a
    CBHG's ``gru_fw`` / ``gru_bw`` scope become the flax ``GRUCell`` named
    ``GRUCell_0`` inside it, those of a decoder cell become its
    ``ir/iz/in/hr/hz/hn`` Denses.  Elementwise trees of the same layout
    (Adam's moments) split the same way."""
    if not isinstance(tree, Mapping):
        return tree
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping) and set(_FUSED_LEAVES) <= set(v):
            rest = {kk: unfuse_gru_params(vv) for kk, vv in v.items()
                    if kk not in _FUSED_LEAVES}
            cell = _unfuse_cell(v)
            out[k] = ({**rest, "GRUCell_0": cell} if k in _GRU_MODULE_SCOPES
                      else {**rest, **cell})
        else:
            out[k] = unfuse_gru_params(v)
    return out


def _jax_key(key: str, scopes: Mapping[str, str]) -> Tuple[str, str]:
    """torch ``state_dict`` key -> (flax collection, flat flax name)."""
    path, _, leaf = key.rpartition(".")
    path = path.replace(".", "/")
    for ours, theirs in scopes.items():
        if path == ours or path.startswith(ours + "/"):
            path = theirs + path[len(ours):]
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", f"{path}/{leaf[len('running_'):]}"
    if leaf == "weight":
        leaf = "scale" if path.rpartition("/")[2] == "bn" else "kernel"
    return "params", f"{path}/{leaf}" if path else leaf


def state_from_jax(module: torch.nn.Module, params: Mapping,
                   batch_stats: Optional[Mapping] = None,
                   scopes: Optional[Mapping[str, str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` (any of the port's Tacotron modules)
    from a flax ``params`` tree and its ``batch_stats`` (nested, or flat
    with ``/``-joined names); with ``batch_stats`` None, the parameters
    alone (no running statistics, no ``num_batches_tracked``).
    ``scopes`` renames flax scopes that differ from the module's attribute
    paths.  Raises on a missing name, a wrong shape, or a name left
    unused."""
    flat = {("params", k): v for k, v in flatten(params).items()}
    flat.update({("batch_stats", k): v
                 for k, v in flatten(batch_stats or {}).items()})
    out, used, missing = {}, set(), []
    for key, ref in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            if batch_stats is not None:
                out[key] = torch.zeros((), dtype=torch.long)
            continue
        name = _jax_key(key, scopes or {})
        if name[0] == "batch_stats" and batch_stats is None:
            continue
        if name not in flat:
            missing.append("/".join(name))
            continue
        used.add(name)
        v = np.asarray(flat[name], np.float32)
        if name[1].rpartition("/")[2] in _TRANSPOSED:
            v = v.T                       # [in, out] / [k, in, out] reversed
        if v.shape != tuple(ref.shape):
            raise ValueError(f"{'/'.join(name)}: shape {v.shape[::-1]}, "
                             f"expected {tuple(ref.shape)[::-1]}")
        out[key] = torch.from_numpy(np.array(v, order="C"))
    unused = sorted("/".join(k) for k in set(flat) - used)
    if missing or unused:
        raise KeyError(f"parameter names differ: missing {missing[:5]}, "
                       f"unused {unused[:5]}")
    return out


def tacotron_skeleton(cfg: TacotronConfig, audio: Optional[AudioConfig] = None,
                      vocab_size: int = 80) -> Tacotron:
    """The port's Tacotron on the meta device: names and shapes only."""
    with torch.device("meta"):
        return Tacotron(cfg, audio or AudioConfig(), vocab_size)


def tacotron_scopes(model: Tacotron) -> Dict[str, str]:
    """flax names the decoder's mechanism by its class: ``attention`` is
    ``{class name}_0`` inside ``decoder/step`` (``LocationSensitiveAttention_0``
    for ``loc_sen``, and so on)."""
    mech = type(model.decoder.step.attention).__name__
    return {"decoder/step/attention": f"decoder/step/{mech}_0"}


def tacotron_params_from_jax(cfg: TacotronConfig, tree: Mapping,
                             batch_stats: Mapping,
                             audio: Optional[AudioConfig] = None,
                             vocab_size: int = 80,
                             device: Optional[torch.device] = None
                             ) -> Dict[str, torch.Tensor]:
    """The port's Tacotron ``state_dict`` from a JAX ``Tacotron`` params
    tree and its ``batch_stats`` (nested or flat); flax ``GRUCell`` trees
    (``fused_rnn: false``) are fused first, as the JAX ``Synthesizer``
    loads them with ``fused_rnn=True``."""
    model = tacotron_skeleton(cfg, audio, vocab_size)
    fused = fuse_gru_params(_nest(flatten(tree)))
    state = state_from_jax(model, fused, batch_stats, tacotron_scopes(model))
    return {k: v.to(device) for k, v in state.items()}


def tacotron_to_jax(cfg: TacotronConfig, tensors: Mapping[str, torch.Tensor],
                    audio: Optional[AudioConfig] = None,
                    vocab_size: int = 80) -> Dict[str, dict]:
    """The inverse of :func:`tacotron_params_from_jax`: tensors under the
    port's ``state_dict`` names (all of them or any part, such as the
    parameters alone or Adam's moments of them) as the nested numpy trees
    ``{"params": ..., "batch_stats": ...}`` that the JAX ``Tacotron`` with
    this config holds: flax names, flax layouts, and flax ``GRUCell``s
    when the config says ``fused_rnn: false``."""
    model = tacotron_skeleton(cfg, audio, vocab_size)
    scopes = tacotron_scopes(model)
    known = model.state_dict()
    out = {"params": {}, "batch_stats": {}}
    for key, v in tensors.items():
        if key not in known or key.endswith("num_batches_tracked"):
            raise KeyError(f"{key}: not a Tacotron parameter or statistic")
        col, name = _jax_key(key, scopes)
        a = v.detach().cpu().numpy()
        if name.rpartition("/")[2] in _TRANSPOSED:
            a = a.T
        out[col][name] = np.array(a, order="C")
    params = _nest(out["params"])
    if not cfg.fused_rnn:
        params = unfuse_gru_params(params)
    return {"params": params, "batch_stats": _nest(out["batch_stats"])}


def tacotron_params_from_npz(cfg: TacotronConfig, path: str,
                             audio: Optional[AudioConfig] = None,
                             vocab_size: int = 80,
                             device: Optional[torch.device] = None
                             ) -> Dict[str, torch.Tensor]:
    """The port's Tacotron ``state_dict`` from an ``.npz`` of flat JAX
    names of both collections: the ``batch_stats`` are the names ending in
    ``/mean`` or ``/var``, every other name is a parameter."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    is_stat = lambda k: k.rpartition("/")[2] in ("mean", "var")
    return tacotron_params_from_jax(
        cfg, {k: v for k, v in flat.items() if not is_stat(k)},
        {k: v for k, v in flat.items() if is_stat(k)}, audio, vocab_size,
        device)


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Standard normal truncated to [-2, 2], as flax's initializers draw."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return x


def _orthogonal(rng: np.random.Generator, n: int) -> np.ndarray:
    q, r = np.linalg.qr(rng.standard_normal((n, n)))
    return q * np.sign(np.diag(r))


def seeded_tacotron_tree(cfg: TacotronConfig, seed: int,
                         audio: Optional[AudioConfig] = None,
                         vocab_size: int = 80
                         ) -> Tuple[Dict[str, np.ndarray],
                                    Dict[str, np.ndarray]]:
    """Random weights in the JAX layout, ``(params, batch_stats)`` as flat
    ``/``-joined dicts, drawn with numpy from ``seed`` at flax's init
    scales: lecun-normal Dense and conv kernels and fused ``w_ih``,
    orthogonal ``w_hh`` per [H, H] gate block, truncated-normal (std 0.5)
    embeddings, glorot-uniform attention ``v`` (``attention_variable``
    too), ``g`` = sqrt(1 / units) (Luong's scale ``g`` = 1), zero biases
    (the alignment and score biases too) but the highways' T-gate bias of
    -1, BatchNorm scale 1, running mean 0 and variance 1."""
    rng = np.random.default_rng(seed)
    model = tacotron_skeleton(cfg, audio, vocab_size)
    scopes = tacotron_scopes(model)
    params, stats = {}, {}
    for key, ref in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        col, name = _jax_key(key, scopes)
        leaf = name.rpartition("/")[2]
        shape = tuple(ref.shape)
        if leaf in _TRANSPOSED:
            shape = shape[::-1]
        if col == "batch_stats":
            v = np.zeros(shape) if leaf == "mean" else np.ones(shape)
        elif leaf in ("char_embedding", "speaker_embedding"):
            v = 0.5 * _truncated_normal(rng, shape)
        elif leaf in ("kernel", "w_ih"):
            fan_in = int(np.prod(shape[:-1]))
            v = _truncated_normal(rng, shape) / np.sqrt(fan_in) / .87962566103423978
        elif leaf == "w_hh":
            v = np.concatenate([_orthogonal(rng, shape[0]) for _ in range(3)],
                               axis=1)
        elif leaf == "scale":
            v = np.ones(shape)
        elif leaf in ("attention_v", "attention_variable"):
            lim = np.sqrt(6.0 / (shape[0] + shape[1]))
            v = rng.uniform(-lim, lim, shape)
        elif leaf == "attention_g":
            v = np.asarray(1.0 if "/LuongAttention_0/" in name
                           else np.sqrt(1.0 / cfg.attention_size))
        elif name.endswith("/T/bias"):
            v = np.full(shape, -1.0)
        else:                             # biases, b_ih, b_hn, score_bias
            v = np.zeros(shape)
        (stats if col == "batch_stats" else params)[name] = v.astype(
            np.float32)
    return params, stats


def seeded_tacotron_params(cfg: TacotronConfig, seed: int,
                           audio: Optional[AudioConfig] = None,
                           vocab_size: int = 80,
                           device: Optional[torch.device] = None
                           ) -> Dict[str, torch.Tensor]:
    params, stats = seeded_tacotron_tree(cfg, seed, audio, vocab_size)
    return tacotron_params_from_jax(cfg, params, stats, audio, vocab_size,
                                    device)
