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

The mesh and tensor-parallel parts of the JAX task are not ported yet.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from ..config import Config
from ..convert import seeded_train_tree
from ..device import no_tf32, resolve_device
from ..models.wavenet import Params, WaveNet, wavenet_loss
from . import optim


class WaveNetTrainState(NamedTuple):
    step: torch.Tensor            # int32, 0-d
    params: Params
    ema_params: Params
    opt_state: Any                # optax's tree (train/optim.py)


def make_optimizer(cfg: Config) -> optim.Transformation:
    """adam, sgd or rmsprop (with ``momentum``) on the exponential decay of
    ``learning_rate``, behind a clip of the global norm to 1.0 when
    ``clip_gradients`` is set."""
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
        tx = optim.chain(optim.clip_by_global_norm(1.0), tx)
    return tx


class WaveNetTask:
    """The training graph, its loss, optimizer and EMA on ``device``
    (``cuda`` unless the caller asks for another; no GPU raises).  f32
    steps run with TF32 off, so the card computes what the CPU does."""

    def __init__(self, cfg: Config, gc_enable: bool = False,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.gc_enable = gc_enable
        self.device = resolve_device(device)
        self.model = WaveNet(cfg.wavenet)
        self.tx = make_optimizer(cfg)
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

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        sid = batch["speaker_id"] if self.gc_enable else None
        out = self.model(params, batch["input_wav"], batch["local_condition"],
                         sid)
        losses = wavenet_loss(self.cfg.wavenet, out, params)
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
        updates, new_opt = self.tx.update(grads, state.opt_state,
                                          state.params)
        new_params = optim.apply_updates(state.params, updates)
        new_ema = optim.incremental_update(
            new_params, state.ema_params, 1.0 - self.cfg.wavenet.ema_decay)
        metrics = dict(losses)
        metrics["learning_rate"] = self.lr_schedule(state.step)
        metrics["grad_norm"] = optim.global_norm(grads)
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
