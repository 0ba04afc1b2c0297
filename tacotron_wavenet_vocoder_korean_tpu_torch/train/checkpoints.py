"""Orbax checkpoints without JAX, Orbax, tensorstore or a zstd module:
the JAX package's ``train/checkpoints.py`` (``CheckpointManager``,
``prepare_run_dir``, ``load_run_config``, ``restore_into_state``) and a
reader of the repository's committed checkpoints.

A run dir holds ``params.json`` and ``ckpt/<step>/default/``, where the
state is stored as Orbax's ``StandardCheckpointHandler`` stores it, zarr v2:
``_METADATA`` lists the tree's leaves by key path (dict keys and sequence
indices), and each leaf is a zarr ``.zarray`` header and one chunk.  Two
layouts are read:

* OCDBT, as the JAX package writes it: the headers and zstd-compressed
  chunks live in an OCDBT database (``ocdbt.py``, ``zstd.py``);
* one directory per leaf, named by its dotted key path, holding
  ``.zarray`` and the chunk (``0.0...``, or ``0`` for a 0-d leaf), as
  Orbax writes it with ``use_ocdbt=False``.  The port writes this layout,
  uncompressed (``"compressor": null``), and the JAX package's
  ``CheckpointManager`` restores it.

Anything else raises, naming the leaf.
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import tarfile
import tempfile
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, load_config, save_config
from ..convert import from_jax_tree, to_jax_tree
from . import zstd
from .ocdbt import OcdbtReader

# Orbax's key types in ``tree_metadata``: a sequence index, a dict key.
SEQUENCE_KEY, DICT_KEY = 1, 2
# What Orbax records for optax's ``EmptyState()``: a node without data.
EMPTY_NODE = "None"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
TMP_SUFFIX = ".orbax-checkpoint-tmp-"


class _LeafDirs:
    """The non-OCDBT layout read through ``OcdbtReader``'s interface: the
    value of ``<leaf>/<file>`` is that file's bytes."""

    def __init__(self, root: str):
        self.root = root

    def read(self, key: str) -> bytes:
        path = os.path.join(self.root, *key.split("/"))
        if not os.path.isfile(path):
            raise KeyError(key)
        with open(path, "rb") as f:
            return f.read()


def _array(reader, name: str) -> np.ndarray:
    """One zarr v2 array of the checkpoint, stored as a single chunk."""
    try:
        meta = json.loads(reader.read(f"{name}/.zarray"))
    except KeyError:
        raise KeyError(f"{name}: no .zarray in the checkpoint") from None
    shape = tuple(meta["shape"])
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}")
    if tuple(meta["chunks"]) != shape:
        raise ValueError(f"{name}: chunks {meta['chunks']} for shape "
                         f"{list(shape)}: more than one chunk")
    if meta.get("order") != "C":
        raise ValueError(f"{name}: order {meta.get('order')!r}")
    if meta.get("filters"):
        raise ValueError(f"{name}: filters {meta['filters']}")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{name}: dimension separator "
                         f"{meta['dimension_separator']!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor}")
    dtype = np.dtype(meta["dtype"])
    chunk = ".".join(["0"] * len(shape)) or "0"
    try:
        raw = reader.read(f"{name}/{chunk}")
    except KeyError:
        raise KeyError(f"{name}: chunk {chunk} absent") from None
    if compressor is not None:
        raw = zstd.decompress(raw)
    want = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
    if len(raw) != want:
        raise ValueError(f"{name}: chunk holds {len(raw)} bytes, "
                         f"{want} expected")
    return np.frombuffer(raw, dtype).reshape(shape).copy()


class CheckpointReader:
    """The checkpoints of one run: ``path`` is the run dir, its ``ckpt/``
    dir, or a ``*.ckpt.tar.gz`` of the run dir (unpacked into a temporary
    directory that ``close()`` removes; the reader is a context manager).

    ``decoded_bytes`` counts the bytes of arrays restored so far."""

    def __init__(self, path: str):
        self._tmp = None
        if os.path.isfile(path):
            self._tmp = tempfile.TemporaryDirectory(prefix="ckpt_")
            with tarfile.open(path, "r:*") as tar:
                tar.extractall(self._tmp.name, filter="data")
            path = self._tmp.name
        if os.path.isdir(os.path.join(path, "ckpt")):
            self.run_dir, self.ckpt_dir = path, os.path.join(path, "ckpt")
        else:
            self.run_dir, self.ckpt_dir = os.path.dirname(
                os.path.abspath(path)), path
        self.decoded_bytes = 0

    def close(self) -> None:
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    def __enter__(self) -> "CheckpointReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def latest_step(self) -> Optional[int]:
        """The largest numeric step dir, as Orbax's ``latest_step``."""
        if not os.path.isdir(self.ckpt_dir):
            return None
        return max((int(d) for d in os.listdir(self.ckpt_dir)
                    if d.isdigit()), default=None)

    def config(self) -> Config:
        return load_config(os.path.join(self.run_dir, "params.json"))

    def restore(self, step: Optional[int] = None,
                items: Optional[Iterable[str]] = ("params",)
                ) -> Dict[str, Any]:
        """The leaves under each top-level name in ``items`` (every name
        when ``items`` is None), as the tree Orbax restores: dicts under
        dict keys, tuples under sequence indices, numpy arrays at the
        leaves (a top-level leaf such as ``step`` as an array) and ``()``
        for an empty node.  ``step`` defaults to the latest.  Leaves of
        other items are not read."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under "
                                        f"{self.ckpt_dir}")
        root = os.path.join(self.ckpt_dir, str(step), "default")
        with open(os.path.join(root, "_METADATA"), encoding="utf-8") as f:
            meta = json.load(f)
        if meta.get("use_zarr3"):
            raise ValueError(f"{root}: only zarr v2 is read")
        reader = OcdbtReader(root) if meta.get("use_ocdbt") else _LeafDirs(
            root)
        items = None if items is None else tuple(items)
        out: Dict[str, Any] = {}
        sequences = set()
        for key, leaf in meta["tree_metadata"].items():
            path = [(k["key"], k["key_type"]) for k in leaf["key_metadata"]]
            if items is not None and path[0][0] not in items:
                continue
            names = tuple(k for k, _ in path)
            if names != ast.literal_eval(key):
                raise ValueError(f"{key}: key metadata disagrees")
            if path[0][1] != DICT_KEY or any(
                    kind not in (DICT_KEY, SEQUENCE_KEY) for _, kind in path):
                raise ValueError(f"{key}: key types {[k for _, k in path]}")
            sequences.update(names[:i] for i, (_, kind) in enumerate(path)
                             if kind == SEQUENCE_KEY)
            kind = leaf["value_metadata"]["value_type"]
            if kind == EMPTY_NODE:
                value = ()
            elif kind == "np.ndarray":
                value = _array(reader, ".".join(names))
                self.decoded_bytes += value.nbytes
            else:
                raise ValueError(f"{key}: value type {kind}")
            node = out
            for k in names[:-1]:
                node = node.setdefault(k, {})
            node[names[-1]] = value
        missing = [i for i in items or () if i not in out]
        if missing:
            raise KeyError(f"{root}: no {missing} in the checkpoint")
        return {k: _as_sequences(v, (k,), sequences) for k, v in out.items()}


def _as_sequences(node: Any, prefix: Tuple[str, ...], sequences) -> Any:
    """The dicts at the key paths in ``sequences`` as tuples in index order
    (the indices of a node must run 0..n-1)."""
    if not isinstance(node, dict):
        return node
    node = {k: _as_sequences(v, prefix + (k,), sequences)
            for k, v in node.items()}
    if prefix not in sequences:
        return node
    if sorted(node) != sorted(str(i) for i in range(len(node))):
        raise ValueError(f"{prefix}: sequence indices {sorted(node)}")
    return tuple(node[str(i)] for i in range(len(node)))


# ---------------------------------------------------------------------------
# Writing: Orbax's non-OCDBT layout
# ---------------------------------------------------------------------------

def _leaves(node: Any, path: Tuple[Tuple[str, int], ...] = ()):
    """(key path, array or None for an empty node), dicts in their order,
    sequences in index order."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, path + ((k, DICT_KEY),))
    elif isinstance(node, (tuple, list)):
        if not node:
            yield path, None
        for i, v in enumerate(node):
            yield from _leaves(v, path + ((str(i), SEQUENCE_KEY),))
    else:
        yield path, np.asarray(node)


def _write_leaf(root: str, name: str, value: np.ndarray) -> None:
    if value.dtype.byteorder == ">" or value.dtype.kind not in "biuf":
        raise ValueError(f"{name}: dtype {value.dtype} is not written")
    if value.size == 0:
        raise ValueError(f"{name}: empty array")
    shape = list(value.shape)
    zarray = {"chunks": shape, "compressor": None, "dimension_separator": ".",
              "dtype": value.dtype.str, "fill_value": None, "filters": None,
              "order": "C", "shape": shape, "zarr_format": 2}
    leaf_dir = os.path.join(root, name)
    os.makedirs(leaf_dir)
    with open(os.path.join(leaf_dir, ".zarray"), "w", encoding="utf-8") as f:
        f.write(json.dumps(zarray, separators=(",", ":"), sort_keys=True))
    chunk = ".".join(["0"] * value.ndim) or "0"
    with open(os.path.join(leaf_dir, chunk), "wb") as f:
        f.write(np.ascontiguousarray(value).tobytes())


def write_tree(root: str, tree: Dict[str, Any]) -> None:
    """Write a tree of dicts, tuples and arrays into the new directory
    ``root`` as Orbax's ``StandardCheckpointHandler(use_ocdbt=False)``
    writes one item (``<step>/default/``): ``_METADATA``, its leaves in the
    tree's order (``convert.to_jax_tree`` gives JAX's), and one directory
    per leaf.  An empty tuple is recorded as Orbax records optax's
    ``EmptyState()``."""
    os.makedirs(root)
    tree_metadata = {}
    for path, value in _leaves(tree):
        names = tuple(k for k, _ in path)
        if value is None:
            value_meta = {"value_type": EMPTY_NODE, "skip_deserialize": True}
        else:
            _write_leaf(root, ".".join(names), value)
            value_meta = {"value_type": "np.ndarray",
                          "skip_deserialize": False}
        tree_metadata[str(names)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in path],
            "value_metadata": value_meta}
    meta = {"tree_metadata": tree_metadata, "use_ocdbt": False,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    with open(os.path.join(root, "_METADATA"), "w", encoding="utf-8") as f:
        f.write(json.dumps(meta))


class CheckpointManager:
    """The checkpoints of a run dir, ``<log_dir>/ckpt/<step>/``, the latest
    ``max_to_keep`` of them kept (all when it is None).  ``save`` takes the port's train state
    (or any tree of dicts, tuples and tensors; ``convert.to_jax_tree``
    lays it out as the JAX tree) and writes it into a temporary directory
    that is renamed to ``<step>`` when complete, as Orbax does.

    On a ``mesh`` every rank calls ``save`` with the full state (a
    sharded one gathered first, e.g. by ``WaveNetTask.gather_state``):
    rank 0 writes it, then every rank meets at a barrier.  ``restore``
    reads on every rank (a tarball into each rank's own temporary
    directory); the caller keeps its shard."""

    def __init__(self, log_dir: str, max_to_keep: Optional[int] = 3,
                 mesh=None):
        if max_to_keep is not None and max_to_keep < 1:
            raise ValueError(f"max_to_keep={max_to_keep}")
        self.log_dir = os.path.abspath(log_dir)
        self.ckpt_dir = os.path.join(self.log_dir, "ckpt")
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.ckpt_dir)
                      if d.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        if self.mesh is None:
            self._write(step, state)
            return
        if self.mesh.is_main:
            self._write(step, state)
        self.mesh.barrier()

    def _write(self, step: int, state: Any) -> None:
        final = os.path.join(self.ckpt_dir, str(int(step)))
        if os.path.exists(final):
            raise FileExistsError(f"{final} exists")
        t0 = time.time_ns()
        tmp = f"{final}{TMP_SUFFIX}{t0}"
        try:
            write_tree(os.path.join(tmp, "default"), to_jax_tree(state))
            meta = {"item_handlers": {"default": HANDLER}, "metrics": {},
                    "performance_metrics": {}, "init_timestamp_nsecs": t0,
                    "commit_timestamp_nsecs": time.time_ns(),
                    "custom_metadata": {}}
            with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w",
                      encoding="utf-8") as f:
                f.write(json.dumps(meta))
            os.rename(tmp, final)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.ckpt_dir, str(old)))

    def restore(self, template: Any = None, step: Optional[int] = None
                ) -> Any:
        """The state of ``step`` (the latest by default): laid out as
        ``template`` (``convert.from_jax_tree``: every leaf checked, on
        the template's devices), or as the raw JAX tree when no template
        is given."""
        with CheckpointReader(self.ckpt_dir) as reader:
            tree = reader.restore(step, items=None)
        return tree if template is None else from_jax_tree(template, tree)


def prepare_run_dir(log_dir: str, cfg: Config) -> None:
    """Create the run dir and write its ``params.json``."""
    os.makedirs(log_dir, exist_ok=True)
    save_config(cfg, log_dir)


def load_run_config(load_path: str) -> Config:
    """The config of an existing run (its ``params.json``)."""
    return load_config(load_path)


def restore_into_state(task_state: Any, load_path: Optional[str],
                       initialize_path: Optional[str],
                       from_tree: Optional[Callable[[Any, Any], Any]] = None
                       ) -> Tuple[Any, int]:
    """Apply the load / initialize semantics to a freshly made state and
    return ``(state, start_step)``: ``load_path`` continues a run, keeping
    its step; ``initialize_path`` warm-starts from its weights and optimizer
    state with the step reset to 0; both at once raise.  Either path may be
    a run dir, its ``ckpt/`` dir or a ``*.ckpt.tar.gz``; the latest step is
    read, every leaf checked against ``task_state``.  ``from_tree(
    task_state, tree)`` first maps the JAX tree to the port's names where
    they differ (the Tacotron task's ``from_jax_tree``)."""
    if load_path and initialize_path:
        raise ValueError("load_path and initialize_path are mutually "
                         "exclusive")
    if not load_path and not initialize_path:
        return task_state, 0
    with CheckpointReader(load_path or initialize_path) as reader:
        tree = reader.restore(items=None)
    if from_tree is not None:
        tree = from_tree(task_state, tree)
    state = from_jax_tree(task_state, tree)
    if initialize_path:
        return state._replace(step=torch.zeros_like(state.step)), 0
    return state, int(state.step)
