"""The device mesh as process groups, sharding rules over a tree, and the
collectives of data and tensor parallelism (counterpart of the JAX
package's ``parallel/mesh.py``).

JAX runs one global program over a ``(data, model)`` mesh and XLA inserts
the collectives.  Here every rank is a process (launched by ``python -m
torch.distributed.run``), holds one device, and the collectives are
written out where XLA would put them: a ``Mesh`` holds the rank's
coordinates and one process group per mesh row (``model``: the ranks of
one data shard) and per column (``data``: the ranks of one model shard).
Rank ``r`` sits at ``(r // n_model, r % n_model)``, JAX's device order.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: the gloo
backend runs just these on CUDA tensors, and gloo is what ranks sharing a
card must use.  The collectives that carry a gradient are autograd
functions: ``copy_to_model`` (identity, its gradient summed over the
model group), ``reduce_from_model`` (summed, its gradient passed through)
and ``all_reduce_sum`` (summed both ways).

Placements are JAX's ``PartitionSpec``s as tuples (``P(None, "model")``
splits dim 1 over the model axis; ``P()`` is replicated), found by the
JAX package's ordered regex rules over key paths spelled as
``jax.tree_util.keystr`` spells them.
"""
from __future__ import annotations

import math
import os
import re
import socket
import sys
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# How long a collective (and the rendezvous) waits for the other ranks
# before it raises.
INIT_TIMEOUT = timedelta(minutes=10)


class P(tuple):
    """A partition spec: one mesh axis name (or None) per leading dim."""

    def __new__(cls, *names):
        return tuple.__new__(cls, names)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def mesh_ranks(n_data: int, n_model: int) -> np.ndarray:
    """The rank at each mesh coordinate, [n_data, n_model]: JAX's
    ``make_mesh`` order, ``rank = d * n_model + m``."""
    return np.arange(n_data * n_model).reshape(n_data, n_model)


def choose_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when each rank of the node has a card of its own, ``gloo``
    when ranks share a card (NCCL refuses two ranks on one device) or run
    on the CPU."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(n_data, n_model)`` mesh: its device,
    the backend, and the process groups of its data column and its model
    row (None where that axis has extent 1)."""
    world: int
    rank: int
    n_data: int
    n_model: int
    backend: str
    device: torch.device
    data_group: Any
    model_group: Any
    owns_process_group: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def coords(self) -> Tuple[int, int]:
        """``(d, m)``: this rank's data and model coordinates."""
        return divmod(self.rank, self.n_model)

    def index(self, axis: str) -> int:
        return self.coords[0 if axis == DATA_AXIS else 1]

    def group(self, axis: str):
        return self.data_group if axis == DATA_AXIS else self.model_group

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def broadcast_flag(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=self.device)
        dist.broadcast(t, src=0)
        return bool(t.item())

    def close(self) -> None:
        """Destroy the default process group if ``make_mesh`` made it."""
        if self.owns_process_group and dist.is_initialized():
            dist.destroy_process_group()

    def describe(self) -> str:
        d, m = self.coords
        return (f"mesh ({self.n_data}, {self.n_model}) over "
                f"('{DATA_AXIS}', '{MODEL_AXIS}'): rank {self.rank} of "
                f"{self.world} at ({d}, {m}) on {self.device}, backend "
                f"{self.backend}")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None) -> Mesh:
    """This process's rank of a ``(n_data, n_model)`` mesh.

    The rank, the world and the rendezvous come from the variables
    ``torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); without them the mesh has one rank, as JAX's
    ``make_mesh()`` on a host with one device.  ``n_data`` defaults to the
    world over ``n_model``; ``n_data * n_model`` must be the world.
    ``device`` is ``cuda`` unless the caller asks for another; on a card a
    rank takes ``cuda:{LOCAL_RANK % device_count}``.  The backend follows
    ``choose_backend`` and is printed before the process group is made;
    a failed initialisation raises."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        init_method = "env://"
    else:
        rank, world, local_rank, local_world = 0, 1, 0, 1
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh ({n_data}, {n_model}) for a world of "
                         f"{world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = resolve_device(
            f"cuda:{local_rank % torch.cuda.device_count()}")
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world)
    print(f"[rank {rank}] backend {backend}: {local_world} rank(s) on this "
          f"node, device {dev}"
          + (f", {torch.cuda.device_count()} card(s)"
             if dev.type == "cuda" else ""), file=sys.stderr, flush=True)
    owns = not dist.is_initialized()
    if not owns:
        if dist.get_backend() != backend or dist.get_world_size() != world:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks exists; this mesh needs "
                f"{backend} over {world}")
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=INIT_TIMEOUT)
    # Every rank makes every group, in one order.
    grid = mesh_ranks(n_data, n_model)
    groups = {}
    for axis, members in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
        for ranks in members.tolist():
            if len(ranks) == 1:
                g = None
            elif len(ranks) == world:
                g = dist.group.WORLD
            else:
                g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(world, rank, n_data, n_model, backend, dev,
                groups[DATA_AXIS], groups[MODEL_AXIS], owns)


# ---------------------------------------------------------------------------
# Trees: nested dicts, tuples and named tuples
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on every leaf of ``tree`` and the matching leaves of
    ``rest``; a ``P`` is a leaf."""
    if isinstance(tree, P) or not isinstance(tree, (dict, tuple, list)):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    items = [_tree_map(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(tree)]
    return type(tree)(*items) if _is_namedtuple(tree) else type(tree)(items)


def _spec_fits(shape_of: Dict[str, int], spec: P, shape: Tuple[int, ...]
               ) -> bool:
    """A spec is usable iff it has no more entries than the leaf has dims
    and every named axis divides its dim."""
    if len(spec) > len(shape):
        return False
    for dim, name in zip(shape, spec):
        if name is None:
            continue
        names = name if isinstance(name, tuple) else (name,)
        if dim % math.prod(shape_of[n] for n in names):
            return False
    return True


def tree_placements(mesh: Optional[Mesh], tree: Any,
                    rules: Sequence[Tuple[str, P]], default: P = P()
                    ) -> Any:
    """A ``P`` for every leaf of ``tree``: the first rule whose pattern
    ``re.search``-matches the leaf's key path (``['key']`` for a dict key,
    ``[i]`` for a sequence index, ``.field`` for a named tuple's field)
    and whose spec fits the leaf's shape, else ``default``.  The optimizer
    moments and the EMA hold the parameter names in their paths, so one
    rule set places the whole train state.  With no rules ``mesh`` may be
    None."""
    shape_of = mesh.shape if rules else {}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}['{k}']") for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(walk(v, f"{path}.{f}")
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, f"{path}[{i}]")
                              for i, v in enumerate(node))
        shape = tuple(getattr(node, "shape", ()))
        for pattern, spec in rules:
            if re.search(pattern, path) and _spec_fits(shape_of, spec,
                                                       shape):
                return spec
        return default

    return walk(tree, "")


def _split(mesh: Mesh, spec: P):
    """``(dim, shards, index)`` for each dim of ``spec`` split over axes
    of more than one rank."""
    out = []
    for dim, name in enumerate(spec):
        if name is None:
            continue
        idx, n = 0, 1
        for a in (name if isinstance(name, tuple) else (name,)):
            idx, n = idx * mesh.shape[a] + mesh.index(a), n * mesh.shape[a]
        if n > 1:
            out.append((dim, n, idx))
    return out


def shard_tree(mesh: Mesh, tree: Any, placements: Any) -> Any:
    """Each leaf's slice at this rank's coordinates, in memory of its own;
    replicated leaves as they are."""
    def local(x, spec):
        parts = _split(mesh, spec)
        if not parts:
            return x
        for dim, n, idx in parts:
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
        return x.clone()
    return _tree_map(local, tree, placements)


def _axes_group(mesh: Mesh, spec: P):
    names = set()
    for name in spec:
        if name is not None:
            names.update(name if isinstance(name, tuple) else (name,))
    names = {a for a in names if mesh.shape[a] > 1}
    if names == {MODEL_AXIS}:
        return mesh.model_group
    if names == {DATA_AXIS}:
        return mesh.data_group
    return dist.group.WORLD


def gather_tree(mesh: Mesh, tree: Any, placements: Any) -> Any:
    """The full leaves on every rank (every rank calls it): each rank
    writes its slice into zeros of the full shape, and one ``all_reduce``
    per group and dtype sums them."""
    pending: Dict[Any, List[torch.Tensor]] = {}

    def full(x, spec):
        parts = _split(mesh, spec)
        if not parts:
            return x
        shape = list(x.shape)
        for dim, n, _ in parts:
            shape[dim] *= n
        out = x.new_zeros(shape)
        view = out
        for dim, n, idx in parts:
            view = view.narrow(dim, idx * x.shape[dim], x.shape[dim])
        view.copy_(x)
        pending.setdefault(id(_axes_group(mesh, spec)), [
            _axes_group(mesh, spec)]).append(out)
        return out

    out = _tree_map(full, tree, placements)
    for group, *tensors in pending.values():
        _all_reduce_flat(tensors, group)
    return out


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place: one ``all_reduce`` per
    dtype, over the tensors flattened into one buffer."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean(mesh: Mesh, *trees: Dict[str, torch.Tensor]
                    ) -> List[Dict[str, torch.Tensor]]:
    """Each dict of tensors averaged over the data group, all of them in
    one collective per dtype; new tensors (the inputs are left as they
    were)."""
    if mesh.n_data == 1:
        return [dict(t) for t in trees]
    out = [{k: v.detach().clone() for k, v in t.items()} for t in trees]
    _all_reduce_flat([v for t in out for v in t.values()], mesh.data_group)
    return [{k: v / mesh.n_data for k, v in t.items()} for t in out]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis``'s group, its gradient summed too: for a sum
    whose every rank's use contributes to the loss (batch norm's
    statistics over the data group, a norm over a split dim)."""
    if mesh.shape[axis] == 1:
        return x
    return _AllReduceSum.apply(x, mesh.group(axis))


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated tensor entering the model-split part of the graph:
    itself, its gradient summed over the model group (Megatron's f)."""
    if mesh.n_model == 1:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Partial results of the model-split part summed over the model group,
    the gradient passed through (Megatron's g)."""
    if mesh.n_model == 1:
        return x
    return _ReduceFromModel.apply(x, mesh.model_group)
