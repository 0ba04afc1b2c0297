"""Restoring the repository's Orbax checkpoints without JAX, Orbax,
tensorstore or a zstd module: the restore half of the JAX package's
``train/checkpoints.py``.

A run dir holds ``params.json`` and ``ckpt/<step>/default/``, where Orbax
(``StandardCheckpointer``, OCDBT on, zarr v2) wrote the state:
``_METADATA`` lists the tree's leaves by key path, and the OCDBT database
(``ocdbt.py``) holds per leaf a zarr ``.zarray`` header and one chunk,
zstd-compressed (``zstd.py``).  Only the layout these checkpoints use is
read; anything else raises, naming the leaf.
"""
from __future__ import annotations

import ast
import json
import os
import tarfile
import tempfile
from typing import Dict, Iterable, Optional

import numpy as np

from ..config import Config, load_config
from . import zstd
from .ocdbt import OcdbtReader

# Orbax's key type of a dict key in ``tree_metadata`` (1 is a sequence
# index, which only ``opt_state`` holds).
DICT_KEY = 2


def _array(reader: OcdbtReader, name: str) -> np.ndarray:
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
                items: Iterable[str] = ("params",)) -> Dict[str, object]:
        """The leaves under each top-level name in ``items`` as nested dicts
        of numpy arrays (a top-level leaf such as ``step`` as an array).
        ``step`` defaults to the latest.  Leaves of other items are not
        read; a requested leaf that is not an array under dict keys
        raises."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under "
                                        f"{self.ckpt_dir}")
        root = os.path.join(self.ckpt_dir, str(step), "default")
        with open(os.path.join(root, "_METADATA"), encoding="utf-8") as f:
            meta = json.load(f)
        if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
            raise ValueError(f"{root}: only OCDBT with zarr v2 is read")
        reader = OcdbtReader(root)
        items = tuple(items)
        out: Dict[str, object] = {}
        for key, leaf in meta["tree_metadata"].items():
            path = [(k["key"], k["key_type"]) for k in leaf["key_metadata"]]
            if path[0][0] not in items:
                continue
            names = tuple(k for k, _ in path)
            if names != ast.literal_eval(key):
                raise ValueError(f"{key}: key metadata disagrees")
            if any(kind != DICT_KEY for _, kind in path):
                raise ValueError(f"{key}: not a path of dict keys")
            kind = leaf["value_metadata"]["value_type"]
            if kind != "np.ndarray":
                raise ValueError(f"{key}: value type {kind}")
            value = _array(reader, ".".join(names))
            self.decoded_bytes += value.nbytes
            node = out
            for k in names[:-1]:
                node = node.setdefault(k, {})
            node[names[-1]] = value
        missing = [i for i in items if i not in out]
        if missing:
            raise KeyError(f"{root}: no {missing} in the checkpoint")
        return out
