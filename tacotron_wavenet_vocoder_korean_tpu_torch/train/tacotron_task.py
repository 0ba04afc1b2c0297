"""Tacotron training task: the train state, the training and evaluation
steps, and the state's JAX layout (counterpart of the JAX package's
``train/tacotron_task.py``).

The step is ``clip_by_global_norm(1.0)`` then Adam (the config's betas) on
the Noam schedule, read at Adam's own count as optax reads it; batch norm
runs on the batch's statistics and the new running statistics replace the
old, as flax's ``mutable=["batch_stats"]`` returns them.  A step is a
function of the state: ``train_step(state, batch)`` returns a new
``TacotronTrainState`` and leaves the old one as it was; its metrics are
0-d tensors on the device.

The model is called through ``torch.func.functional_call`` on a module
built on the meta device, so the state's tensors are the only copy of the
weights.  Parameters, their Adam moments and the running statistics are
dicts under the module's ``state_dict`` names; the port trains the fused
GRU layout and converts at the checkpoint boundary (``to_jax_tree``,
``from_jax_tree``), to flax ``GRUCell``s when the config says
``fused_rnn: false``.

A batch is a dict of tensors on the task's device: ``inputs`` [B, T_in],
``input_lengths`` [B], ``speaker_id`` [B] (int64), ``loss_coeff`` [B]
float32, ``mel_targets`` [B, T_out, num_mels] and ``linear_targets`` [B,
T_out, num_freq], float16 or float32 (upcast in the loss, as in JAX).
Dropout and scheduled sampling draw from a ``torch.Generator`` or take
injected draws (:meth:`TacotronTask.draw`), since JAX's threefry stream is
not reproduced.

With a ``mesh`` (``parallel.make_mesh``, data parallel) the step is the
JAX task's ``jit_train_step(mesh)`` written out per rank: each rank takes
its rows of the global batch (the batcher cuts them), batch norm's
training statistics are summed over the data group (flax's statistics
over JAX's global batch), every rank draws the global batch's dropout and
scheduled-sampling masks from the same generator and keeps its rows, and
the gradients and losses are averaged over the data group in one
collective.  The state is replicated.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..convert import (fuse_gru_params, seeded_tacotron_params,
                       state_from_jax, tacotron_scopes, tacotron_skeleton,
                       tacotron_to_jax)
from ..device import no_tf32, resolve_device
from ..models.modules import BatchNormConv1d
from ..models.tacotron import (learning_rate_schedule,
                               scheduled_sampling_prob, tacotron_loss)
from ..parallel.mesh import DATA_AXIS, Mesh, all_reduce_mean
from . import optim

Tensors = Dict[str, torch.Tensor]
BATCH_KEYS = ("inputs", "input_lengths", "loss_coeff", "mel_targets",
              "linear_targets", "speaker_id")


class TacotronTrainState(NamedTuple):
    step: torch.Tensor            # int32, 0-d
    params: Tensors
    batch_stats: Tensors          # running_mean / running_var
    opt_state: Any                # optax's tree (train/optim.py)


def _is_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


class TacotronTask:
    """The training graph, its loss and optimizer on ``device`` (``cuda``
    unless the caller asks for another; no GPU raises).  Steps run without
    cuDNN, and f32 steps with TF32 off, so the card computes what the CPU
    does (see ``_precision``).

    ``is_randomly_initialized`` picks the schedule's warmup (4,000, else
    40,000): the JAX trainer sets it for every run not started with
    ``--initialize_path``, resumed ones included."""

    def __init__(self, cfg: Config, vocab_size: int = 80,
                 is_randomly_initialized: bool = False,
                 device: Union[str, torch.device, None] = None,
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.mesh = mesh if mesh is not None and mesh.n_data > 1 else None
        self.device = resolve_device(mesh.device if mesh else device)
        self.model = tacotron_skeleton(cfg.tacotron, cfg.audio, vocab_size)
        if self.mesh is not None:
            for m in self.model.modules():
                if isinstance(m, BatchNormConv1d):
                    m.stats_mesh = self.mesh
        self.lr_schedule = learning_rate_schedule(cfg.tacotron,
                                                  is_randomly_initialized)
        t = cfg.tacotron
        self.tx = optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adam(self.lr_schedule, b1=t.adam_beta1, b2=t.adam_beta2))

    def _precision(self):
        """The step's numerics on a card: TF32 off for f32, and cuDNN off.
        cuDNN's convolutions are as exact as the native ones alone, but in
        this graph they put the card's f32 gradient hundreds of times
        farther from the CPU's than the native ones do (``chip_smoke.py``
        measures both, phase taco_train (a))."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.backends.cudnn.flags(enabled=False))
        if self.cfg.tacotron.compute_dtype == "float32":
            stack.enter_context(no_tf32())
        return stack

    # ------------------------------------------------------------------
    def state_from_tensors(self, tensors: Tensors, step: int = 0
                           ) -> TacotronTrainState:
        """A state at ``step`` from a full ``state_dict``, the optimizer's
        state at zero."""
        params = {k: v.to(self.device, torch.float32)
                  for k, v in tensors.items()
                  if not _is_stat(k) and not k.endswith("num_batches_tracked")}
        stats = {k: v.to(self.device, torch.float32)
                 for k, v in tensors.items() if _is_stat(k)}
        return TacotronTrainState(
            step=torch.full((), step, dtype=torch.int32, device=self.device),
            params=params, batch_stats=stats, opt_state=self.tx.init(params))

    def init_state(self, seed: int) -> TacotronTrainState:
        """Weights from ``seed`` at flax's init distributions
        (``convert.seeded_tacotron_tree``), running mean 0 and variance 1,
        the optimizer's state at zero and step 0."""
        return self.state_from_tensors(seeded_tacotron_params(
            self.cfg.tacotron, seed, self.cfg.audio, self.vocab_size))

    # ------------------------------------------------------------------
    def draw(self, batch: Tensors, generator: torch.Generator,
             step: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """The random draws of one training step, on ``generator``'s
        device: the encoder- and decoder-prenet keep-masks when the config
        has dropout, and with scheduled sampling the per-step, per-example
        choice of the teacher's frame (``uniform < p(step)``, as
        ``jax.random.bernoulli`` draws it)."""
        t = self.cfg.tacotron
        B, T_in = batch["inputs"].shape
        T_dec = batch["mel_targets"].shape[1] // t.reduction_factor
        # On a mesh: the global batch's draws, this rank's rows of them.
        n, d = ((self.mesh.n_data, self.mesh.index(DATA_AXIS))
                if self.mesh else (1, 0))
        rows = slice(d * B, (d + 1) * B)
        out: Dict[str, Any] = {}
        if t.dropout_prob > 0:
            out["encoder_prenet_masks"] = [
                m[rows] for m in self.model.draw_encoder_masks(
                    B * n, T_in, generator)]
            out["prenet_masks"] = [
                m[:, rows] for m in self.model.draw_prenet_masks(
                    T_dec, B * n, generator)]
        if t.scheduled_sampling:
            p = scheduled_sampling_prob(t, step.to(generator.device))
            out["use_teacher"] = (torch.rand(
                (T_dec, B * n), generator=generator,
                device=generator.device) < p)[:, rows]
        return out

    def forward(self, params: Tensors, batch_stats: Tensors,
                batch: Tensors, **kwargs) -> Dict[str, torch.Tensor]:
        """The model on ``params`` and ``batch_stats`` (``functional_call``),
        targets upcast to float32."""
        return torch.func.functional_call(
            self.model, {**params, **batch_stats},
            (batch["inputs"], batch["input_lengths"]),
            dict(speaker_id=batch["speaker_id"],
                 mel_targets=batch["mel_targets"].float(), **kwargs),
            strict=False)

    def _losses(self, outputs, batch) -> Dict[str, torch.Tensor]:
        return tacotron_loss(outputs, batch["mel_targets"].float(),
                             batch["linear_targets"].float(),
                             batch["loss_coeff"], self.cfg.tacotron,
                             self.cfg.audio)

    def loss_fn(self, params: Tensors, batch_stats: Tensors,
                batch: Tensors, draws: Optional[Dict[str, Any]] = None
                ) -> Tuple[torch.Tensor, Tuple[Tensors, Dict, Tensors]]:
        """Training-mode forward and loss: ``(loss, (losses, outputs, new
        batch_stats))``."""
        updates: dict = {}
        outputs = self.forward(params, batch_stats, batch, train=True,
                               bn_updates=updates, **(draws or {}))
        losses = self._losses(outputs, batch)
        return losses["loss"], (losses, outputs,
                                self.model.running_stats(updates))

    def grads(self, params: Tensors, batch_stats: Tensors, batch: Tensors,
              draws: Optional[Dict[str, Any]] = None
              ) -> Tuple[Tensors, Tensors, Tensors]:
        """``(losses, gradients of loss, new batch_stats)``; a parameter
        the loss does not read gets a zero gradient."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with self._precision():
            loss, (losses, _, new_stats) = self.loss_fn(
                leaves, batch_stats, batch, draws)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        return ({k: v.detach() for k, v in losses.items()},
                {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)},
                new_stats)

    def train_step(self, state: TacotronTrainState, batch: Tensors,
                   draws: Optional[Dict[str, Any]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TacotronTrainState, Tensors]:
        """One optimizer step.  ``draws`` (see :meth:`draw`) are used as
        given; else they are drawn from ``generator`` when the config has
        dropout or scheduled sampling."""
        t = self.cfg.tacotron
        if draws is None and (t.dropout_prob > 0 or t.scheduled_sampling):
            if generator is None:
                raise ValueError("dropout or scheduled sampling needs draws "
                                 "or a generator")
            draws = self.draw(batch, generator, state.step)
        losses, grads, new_stats = self.grads(state.params, state.batch_stats,
                                              batch, draws)
        if self.mesh is not None:
            grads, losses = all_reduce_mean(self.mesh, grads, losses)
        updates, new_opt = self.tx.update(grads, state.opt_state,
                                          state.params)
        new_params = optim.apply_updates(state.params, updates)
        metrics = dict(losses)
        metrics["learning_rate"] = self.lr_schedule(state.step)
        metrics["grad_norm"] = optim.global_norm(grads)
        if t.scheduled_sampling:
            metrics["teacher_force_prob"] = scheduled_sampling_prob(
                t, state.step)
        return TacotronTrainState(state.step + 1, new_params,
                                  {**state.batch_stats, **new_stats},
                                  new_opt), metrics

    @torch.no_grad()
    def eval_step(self, state: TacotronTrainState, batch: Tensors,
                  seed: int = 0) -> Dict[str, torch.Tensor]:
        """The losses of a free-running decode against the targets (the
        decoder feeds its own frames for T_out / r steps), running
        statistics, decoder-prenet dropout live when the config keeps it at
        inference, from a generator seeded with ``seed`` (fixed, so eval
        curves compare across steps); with the outputs."""
        gen = torch.Generator(self.device).manual_seed(seed)
        with self._precision():
            outputs = self.forward(state.params, state.batch_stats, batch,
                                   train=False, free_run=True, generator=gen)
            losses = self._losses(outputs, batch)
        losses.update(outputs)
        return losses

    # ------------------------------------------------------------------
    def to_jax_tree(self, state: TacotronTrainState) -> Dict[str, Any]:
        """The state as the JAX ``TrainState``'s tree of numpy arrays:
        ``step``, ``params`` and ``batch_stats`` in flax names and layouts,
        ``opt_state`` as optax's ``(EmptyState, (ScaleByAdamState,
        ScaleByScheduleState))`` with the moments in the params' layout."""
        conv = lambda t: tacotron_to_jax(self.cfg.tacotron, t,
                                         self.cfg.audio, self.vocab_size)
        names = set(state.params)

        def walk(node):
            if isinstance(node, torch.Tensor):
                return node.detach().cpu().numpy()
            if isinstance(node, tuple):
                return tuple(walk(v) for v in node)
            if set(node) == names:
                return conv(node)["params"]
            return {k: walk(v) for k, v in node.items()}

        both = conv({**state.params, **state.batch_stats})
        return {"step": walk(state.step), "params": both["params"],
                "batch_stats": both["batch_stats"],
                "opt_state": walk(state.opt_state)}

    def from_jax_tree(self, template: TacotronTrainState,
                      tree: Dict[str, Any]) -> Dict[str, Any]:
        """A JAX ``TrainState`` tree (as the checkpoint reader restores it;
        flax ``GRUCell`` trees are fused first) in the port's names, laid
        out as ``template``, for ``convert.from_jax_tree``."""
        scopes = tacotron_scopes(self.model)
        names = set(template.params)

        def port(params, stats=None):
            d = state_from_jax(self.model, fuse_gru_params(params), stats,
                               scopes)
            return {k: v.numpy() for k, v in d.items()
                    if not k.endswith("num_batches_tracked")}

        def walk(t, node):
            if isinstance(t, dict) and set(t) == names:
                return port(node)
            if isinstance(t, tuple):
                return tuple(walk(a, b) for a, b in zip(t, node))
            if isinstance(t, dict):
                return {k: walk(t[k], node[k]) for k in t}
            return node

        both = port(tree["params"], tree["batch_stats"])
        return {"step": tree["step"],
                "params": {k: both[k] for k in template.params},
                "batch_stats": {k: both[k] for k in template.batch_stats},
                "opt_state": walk(template.opt_state, tree["opt_state"])}


def batch_to_device(batch: Any, device: Union[str, torch.device],
                    transfer_dtype: str = "float32") -> Tensors:
    """A ``TacotronBatch`` (or a dict of arrays) as tensors on ``device``:
    ids and lengths int64, ``loss_coeff`` float32, the targets float16 when
    ``transfer_dtype`` is ``float16`` (rounded as JAX's ``batch_to_dict``
    rounds them; the loss upcasts), else float32."""
    get = (batch.__getitem__ if isinstance(batch, dict)
           else lambda k: getattr(batch, k))
    tdt = np.float16 if transfer_dtype == "float16" else np.float32
    out = {}
    for k in BATCH_KEYS:
        v = np.asarray(get(k))
        if k in ("mel_targets", "linear_targets"):
            v = v.astype(tdt)
        elif k == "loss_coeff":
            v = v.astype(np.float32)
        else:
            v = v.astype(np.int64)
        out[k] = torch.from_numpy(v).to(device)
    return out
