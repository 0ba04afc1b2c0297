"""The optimizers of training, equal to optax 0.2.6 as the JAX package's
``train/wavenet_task.py`` and ``train/tacotron_task.py`` use it: ``exponential_decay``,
``adam``, ``sgd`` and ``rmsprop`` with momentum, ``clip_by_global_norm``,
``chain``, ``apply_updates``, ``incremental_update`` (the EMA) and
``global_norm``.

Parameters, gradients and updates are dicts of tensors with one key order.
A transformation is an ``(init, update)`` pair as in optax, and its state is
laid out as optax's tree, so a checkpoint maps leaf for leaf: a named tuple
of optax is a dict of its fields here (``{"count", "mu", "nu"}`` for
``ScaleByAdamState``), a chain is a tuple, and ``EmptyState()`` is ``()``.
Each elementwise step is the one optax takes, in the same order, on the
same dtype; the arithmetic runs as ``torch._foreach_*`` ops, a few kernel
launches for all leaves together.  Counts are int32 tensors and the
learning rate is a float32 tensor on the parameters' device, so a step
never waits on the host.

``torch.optim.Adam`` and ``RMSprop`` differ from optax: RMSprop puts eps
outside the square root, decays by 0.99 and applies momentum before the
learning rate.  They are not used.
"""
from __future__ import annotations

from typing import (Any, Callable, Collection, Dict, List, NamedTuple,
                    Optional, Tuple)

import torch
import torch.distributed as dist

Params = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]
INT32_MAX = 2 ** 31 - 1


class Transformation(NamedTuple):
    """``init(params) -> state``; ``update(updates, state, params) ->
    (updates, state)``."""
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Optional[Params]], Tuple[Params, Any]]


def _leaves(tree: Params, keys: List[str]) -> List[torch.Tensor]:
    return [tree[k] for k in keys]


def _count0(params: Params) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def safe_increment(count: torch.Tensor) -> torch.Tensor:
    """count + 1, held at the int32 maximum."""
    return torch.where(count < INT32_MAX, count + 1, count)


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Schedule:
    """``init_value * decay_rate ** (count / transition_steps)``, not
    staircase, in float32; ``init_value`` at ``count <= 0``."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: torch.full((), init_value, dtype=torch.float32,
                                        device=count.device)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        p = count.to(torch.float32) / float(transition_steps)
        decayed = init_value * torch.pow(decay_rate, p)
        return torch.where(count <= 0, torch.full_like(decayed, init_value),
                           decayed)
    return schedule


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    return 1 - torch.pow(decay, count.to(torch.float32))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Transformation:
    """Adam's scaling (``eps_root`` 0, eps outside the square root, the
    count incremented before the bias correction)."""
    def init(params):
        return {"count": _count0(params),
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(updates, state, params=None):
        keys = list(updates)
        g = _leaves(updates, keys)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(_leaves(state["mu"], keys),
                                                   b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul(_leaves(state["nu"], keys), b2))
        count = safe_increment(state["count"])
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        nu_hat = torch._foreach_div(nu, _bias_correction(b2, count))
        out = torch._foreach_div(
            mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
        return (dict(zip(keys, out)),
                {"count": count, "mu": dict(zip(keys, mu)),
                 "nu": dict(zip(keys, nu))})
    return Transformation(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8) -> Transformation:
    """RMSprop's scaling: ``nu`` starts at 0 (``initial_scale``), eps
    inside the reciprocal square root, no bias correction."""
    def init(params):
        return {"nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(updates, state, params=None):
        keys = list(updates)
        g = _leaves(updates, keys)
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - decay),
            torch._foreach_mul(_leaves(state["nu"], keys), decay))
        out = torch._foreach_mul(
            torch._foreach_rsqrt(torch._foreach_add(nu, eps)), g)
        return dict(zip(keys, out)), {"nu": dict(zip(keys, nu))}
    return Transformation(init, update)


def trace(decay: float) -> Transformation:
    """Momentum: ``trace = g + decay * trace``, the update is the trace
    (not Nesterov)."""
    def init(params):
        return {"trace": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(updates, state, params=None):
        keys = list(updates)
        new = torch._foreach_add(
            _leaves(updates, keys),
            torch._foreach_mul(_leaves(state["trace"], keys), decay))
        new = dict(zip(keys, new))
        return new, {"trace": new}
    return Transformation(init, update)


def scale_by_learning_rate(schedule: Schedule) -> Transformation:
    """``-schedule(count) * g``, with the count before its increment."""
    def init(params):
        return {"count": _count0(params)}

    def update(updates, state, params=None):
        keys = list(updates)
        step_size = -schedule(state["count"])
        out = torch._foreach_mul(_leaves(updates, keys), step_size)
        return (dict(zip(keys, out)),
                {"count": safe_increment(state["count"])})
    return Transformation(init, update)


def global_norm(tree: Params, sharded: Collection[str] = (),
                mesh=None) -> torch.Tensor:
    """The L2 norm of all leaves together.  The leaves named in
    ``sharded`` are this rank's slices of leaves split over ``mesh``'s
    model axis: their squares are summed over the model group, the
    replicated leaves' counted once."""
    norms = torch._foreach_norm(list(tree.values()))
    if not sharded:
        return torch.sqrt(torch.sum(torch.stack(norms) ** 2))
    sq = torch.stack(norms) ** 2
    split = torch.tensor([k in sharded for k in tree], device=sq.device)
    part = torch.sum(torch.where(split, sq, torch.zeros_like(sq)))
    dist.all_reduce(part, group=mesh.model_group)
    return torch.sqrt(torch.sum(torch.where(split, torch.zeros_like(sq), sq))
                      + part)


def clip_by_global_norm(max_norm: float, sharded: Collection[str] = (),
                        mesh=None) -> Transformation:
    """Leaves scaled by ``max_norm / global_norm`` when the norm is not
    below ``max_norm``; the state is optax's ``EmptyState()``.
    ``sharded`` and ``mesh`` as ``global_norm`` takes them."""
    def update(updates, state, params=None):
        keys = list(updates)
        g_norm = global_norm(updates, sharded, mesh)
        divisor = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                              g_norm)
        scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                            torch.full_like(g_norm, max_norm))
        out = torch._foreach_mul(
            torch._foreach_div(_leaves(updates, keys), divisor), scale)
        return dict(zip(keys, out)), state
    return Transformation(lambda params: (), update)


def chain(*txs: Transformation) -> Transformation:
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)
    return Transformation(init, update)


def adam(schedule: Schedule, b1: float = 0.9, b2: float = 0.999
         ) -> Transformation:
    return chain(scale_by_adam(b1, b2), scale_by_learning_rate(schedule))


def sgd(schedule: Schedule, momentum: float) -> Transformation:
    return chain(trace(momentum), scale_by_learning_rate(schedule))


def rmsprop(schedule: Schedule, momentum: float) -> Transformation:
    return chain(scale_by_rms(), scale_by_learning_rate(schedule),
                 trace(momentum))


def apply_updates(params: Params, updates: Params) -> Params:
    keys = list(params)
    return dict(zip(keys, torch._foreach_add(_leaves(params, keys),
                                             _leaves(updates, keys))))


def incremental_update(new: Params, old: Params, step_size: float) -> Params:
    """``step_size * new + (1 - step_size) * old``: the EMA."""
    keys = list(new)
    return dict(zip(keys, torch._foreach_add(
        torch._foreach_mul(_leaves(new, keys), step_size),
        torch._foreach_mul(_leaves(old, keys), 1.0 - step_size))))
