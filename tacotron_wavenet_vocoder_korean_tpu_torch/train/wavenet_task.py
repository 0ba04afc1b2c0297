"""WaveNet training task: an exponentially decaying Adam (or sgd / rmsprop
with momentum), an optional clip of the global norm, and an exponential
moving average of the parameters (counterpart of the JAX package's
``train/wavenet_task.py``).

A step is a function of the state, as in JAX: ``train_step(state, batch)``
returns a new ``WaveNetTrainState`` and leaves the old one as it was.  Its
metrics are 0-d tensors on the device, so the caller decides when to wait
for them.  A batch is a dict of tensors on the task's device:
``input_wav`` [B, T, 1], ``local_condition`` [B, T // hop, num_mels] and,
with speakers, ``speaker_id`` [B].

With a ``mesh`` (``parallel.make_mesh``) the step is the JAX task's
``jit_train_step(mesh)`` written out per rank: each rank takes its rows of
the global batch (the batchers cut them), the skip/post stack is tensor
parallel over the model axis (``WAVENET_TP_RULES``, as in JAX; see
``models.wavenet.WaveNet``), the gradients and losses are averaged over
the data group in one collective, and the optimizer and the EMA run on
the shards.  ``shard_state`` keeps this rank's slices of a full state;
``gather_state`` and ``to_jax_tree`` rebuild the full one on every rank,
so a checkpoint has the unsharded layout.
"""
from __future__ import annotations

import contextlib
from typing import Any, Collection, Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..config import Config
from ..convert import seeded_train_tree, to_jax_tree, train_param_shapes
from ..device import no_tf32, resolve_device
from ..models.wavenet import Params, WaveNet, wavenet_loss
from ..parallel.mesh import (
    MODEL_AXIS, Mesh, P, all_reduce_mean, gather_tree, shard_tree,
    tree_placements)
from . import optim

# Tensor parallelism over the model axis, the JAX task's rules: every
# layer's skip projection column-parallel (its kernel's columns, its bias),
# post_1 row-parallel; the first rule that matches a leaf's path and fits
# its shape wins, so a 1-D weight-norm ``_g`` stays replicated, and the
# Adam moments and the EMA are placed as their parameters.
WAVENET_TP_RULES = (
    (r"layer_\d+_skip_kernel", P(None, MODEL_AXIS)),
    (r"layer_\d+_skip_bias", P(MODEL_AXIS)),
    (r"post_1.*kernel|post_1_kernel", P(MODEL_AXIS, None)),
)


class WaveNetTrainState(NamedTuple):
    step: torch.Tensor            # int32, 0-d
    params: Params
    ema_params: Params
    opt_state: Any                # optax's tree (train/optim.py)


def make_optimizer(cfg: Config, sharded: Collection[str] = (),
                   mesh: Optional[Mesh] = None) -> optim.Transformation:
    """adam, sgd or rmsprop (with ``momentum``) on the exponential decay of
    ``learning_rate``, behind a clip of the global norm to 1.0 when
    ``clip_gradients`` is set (over the whole tensors when ``sharded``
    names leaves split over ``mesh``'s model axis)."""
    w = cfg.wavenet
    schedule = optim.exponential_decay(w.learning_rate, w.decay_steps,
                                       w.decay_rate)
    opts = {
        "adam": lambda: optim.adam(schedule),
        "sgd": lambda: optim.sgd(schedule, w.momentum),
        "rmsprop": lambda: optim.rmsprop(schedule, w.momentum),
    }
    if w.optimizer not in opts:
        raise KeyError(f"unknown optimizer {w.optimizer!r}")
    tx = opts[w.optimizer]()
    if w.clip_gradients:
        tx = optim.chain(optim.clip_by_global_norm(1.0, sharded, mesh), tx)
    return tx


class WaveNetTask:
    """The training graph, its loss, optimizer and EMA on ``device``
    (``cuda`` unless the caller asks for another; no GPU raises), or on
    ``mesh``'s device.  f32 steps run with TF32 off, so the card computes
    what the CPU does."""

    def __init__(self, cfg: Config, gc_enable: bool = False,
                 device: Union[str, torch.device, None] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.gc_enable = gc_enable
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh else device)
        self.model = WaveNet(cfg.wavenet, mesh)
        self.rules = WAVENET_TP_RULES if mesh and mesh.n_model > 1 else ()
        meta = {k: torch.empty(v, device="meta") for k, v in
                train_param_shapes(cfg.wavenet, gc_enable).items()}
        self.sharded = frozenset(
            k for k, spec in tree_placements(mesh, meta, self.rules).items()
            if any(a is not None for a in spec))
        self.tx = make_optimizer(cfg, self.sharded, mesh)
        # A ``P`` for every leaf of the full state.
        self.placements = tree_placements(mesh, WaveNetTrainState(
            torch.empty((), device="meta"), meta, meta, self.tx.init(meta)),
            self.rules)
        self.lr_schedule = optim.exponential_decay(
            cfg.wavenet.learning_rate, cfg.wavenet.decay_steps,
            cfg.wavenet.decay_rate)

    def _precision(self):
        if self.cfg.wavenet.compute_dtype == "float32":
            return no_tf32()
        return contextlib.nullcontext()

    def init_state(self, seed: int) -> WaveNetTrainState:
        """Parameters from ``seed`` (flax's init distributions,
        ``convert.seeded_train_tree``), the EMA a copy of them, the
        optimizer's state at zero and step 0."""
        params = {k: torch.from_numpy(v).to(self.device) for k, v in
                  seeded_train_tree(self.cfg.wavenet, seed,
                                    self.gc_enable).items()}
        return WaveNetTrainState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            params=params,
            ema_params={k: v.clone() for k, v in params.items()},
            opt_state=self.tx.init(params))

    # ------------------------------------------------------------------
    def shard_state(self, state: WaveNetTrainState) -> WaveNetTrainState:
        """This rank's slices of a full state (after init or restore)."""
        if not self.sharded:
            return state
        return shard_tree(self.mesh, state, self.placements)

    def gather_state(self, state: WaveNetTrainState) -> WaveNetTrainState:
        """The full state on every rank, from its shards (every rank
        calls it)."""
        if not self.sharded:
            return state
        return gather_tree(self.mesh, state, self.placements)

    def to_jax_tree(self, state: WaveNetTrainState) -> Dict[str, Any]:
        """The full state as the JAX ``TrainState``'s tree of numpy
        arrays (``convert.to_jax_tree`` of ``gather_state``)."""
        return to_jax_tree(self.gather_state(state))

    # ------------------------------------------------------------------
    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        sid = batch["speaker_id"] if self.gc_enable else None
        out = self.model(params, batch["input_wav"], batch["local_condition"],
                         sid)
        losses = wavenet_loss(self.cfg.wavenet, out, params, self.sharded,
                              self.mesh)
        return losses["loss"], losses

    def grads(self, params: Params, batch: Dict[str, torch.Tensor]
              ) -> Tuple[Dict[str, torch.Tensor], Params]:
        """The losses and the gradient of ``loss`` in every parameter (zero
        for the last layer's residual projection, whose output nothing
        reads)."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with self._precision():
            loss, losses = self.loss_fn(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        return ({k: v.detach() for k, v in losses.items()},
                {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)})

    def train_step(self, state: WaveNetTrainState,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[WaveNetTrainState, Dict[str, torch.Tensor]]:
        losses, grads = self.grads(state.params, batch)
        if self.mesh is not None:
            grads, losses = all_reduce_mean(self.mesh, grads, losses)
        updates, new_opt = self.tx.update(grads, state.opt_state,
                                          state.params)
        new_params = optim.apply_updates(state.params, updates)
        new_ema = optim.incremental_update(
            new_params, state.ema_params, 1.0 - self.cfg.wavenet.ema_decay)
        metrics = dict(losses)
        metrics["learning_rate"] = self.lr_schedule(state.step)
        metrics["grad_norm"] = optim.global_norm(grads, self.sharded,
                                                 self.mesh)
        return WaveNetTrainState(state.step + 1, new_params, new_ema,
                                 new_opt), metrics

    @torch.no_grad()
    def eval_step(self, state: WaveNetTrainState,
                  batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Teacher-forced losses with the EMA parameters (the weights
        generation serves)."""
        with self._precision():
            return self.loss_fn(state.ema_params, batch)[1]


def batch_to_device(batch: Any, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (a dict, or the batcher's ``WaveNetBatch``)
    as tensors on ``device``: audio and mel as float32, speaker ids, when
    the batch has them, as int64."""
    get = (batch.get if isinstance(batch, dict)
           else lambda k: getattr(batch, k, None))
    out = {k: torch.as_tensor(get(k), dtype=torch.float32).to(device)
           for k in ("input_wav", "local_condition")}
    if get("speaker_id") is not None:
        out["speaker_id"] = torch.as_tensor(get("speaker_id")).long().to(
            device)
    return out
