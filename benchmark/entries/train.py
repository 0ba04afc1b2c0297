"""Entry ``train``: ``WaveNetTask.train_step`` at the configuration's batch
and crop, in its compute type, fed as the port's ``train_vocoder`` feeds
it: the traffic's clips preprocessed by the port's ``preprocess_corpus``
into a moon-layout corpus under the run's temporary directory, served
from ``WaveNetBatcher``'s device store through ``DevicePrefetcher``; no
saves, no evaluation.

Set-up builds one training state from weights made from the seed and
drives it through its first ``check_steps`` steps by the window's own
call and feed; the window carries on from that same state.  After the
window the plain reference follows those first steps from its own copy of
the weights on the same batches, and the run compares each step's loss,
the first gradient as Adam received it (its first moment after one step,
over ``1 - b1``), and the change of the parameters and of their EMA over
the steps, leaf by leaf.  The batches are checked by themselves: every row
differs, and each is a frame-aligned crop of one training clip with its
mel frames."""
from __future__ import annotations

import gc
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, weights, work
from benchmark.harness import Check, Context, Outcome
from benchmark.reference import wavenet as ref

ADAM_B1 = 0.9


def prepare_corpus(ctx: Context, cfg) -> str:
    """The traffic's clips as a moon-layout corpus (wavs linked, one text
    for all), preprocessed by the port on the run's device."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.data import (
        preprocess_corpus)
    params = ctx.workload["traffic"]
    clips = harness.repo_path(params["clips"])
    names = sorted(f for f in os.listdir(clips) if f.endswith(".wav"))
    names = names[:params.get("max_clips", len(names))]
    in_dir = os.path.join(ctx.run_dir, "corpus_in")
    out_dir = os.path.join(ctx.run_dir, "corpus")
    os.makedirs(os.path.join(in_dir, "audio"))
    for n in names:
        os.symlink(os.path.join(clips, n), os.path.join(in_dir, "audio", n))
    with open(os.path.join(in_dir, "moon-recognition-All.json"), "w",
              encoding="utf-8") as f:
        json.dump({f"audio/{n}": params["text"] for n in names}, f,
                  ensure_ascii=False)
    preprocess_corpus(cfg, "moon", in_dir, out_dir,
                      num_workers=params["workers"], device=ctx.device)
    return out_dir


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tree.items()}


def worst_leaf_gap(prog: Dict[str, float], refn: Dict[str, float],
                   keys: List[str]) -> float:
    """The widest gap between the program's norm of a leaf and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    median = float(np.median([refn[k] for k in keys]))
    return max(abs(prog[k] - refn[k]) / max(refn[k], median, 1e-30)
               for k in keys)


class TrainCell:
    """One training state of the cell, its feed and its first steps."""

    def __init__(self, ctx: Context, corpus: str = None):
        from tacotron_wavenet_vocoder_korean_tpu_torch.config import from_dict
        from tacotron_wavenet_vocoder_korean_tpu_torch.data.feeder import (
            DevicePrefetcher)
        from tacotron_wavenet_vocoder_korean_tpu_torch.data.loader import (
            WaveNetBatcher)
        from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
            WaveNetTask, WaveNetTrainState)
        self.ctx = ctx
        conf = ctx.config
        self.w = conf["wavenet"]
        self.hop = conf["audio"]["hop_size"]
        self.cfg = from_dict({k: conf[k] for k in ("audio", "wavenet", "train")
                              if k in conf})
        ctx.phase("imports")
        self.corpus = corpus or prepare_corpus(ctx, self.cfg)
        ctx.phase("corpus")
        self.batcher = WaveNetBatcher(
            [self.corpus], self.cfg, gc_enable=False, seed=ctx.np_seed(4),
            device_store=self.cfg.train.device_resident_data,
            device=ctx.device)
        self.feeder = DevicePrefetcher(self.batcher, device=ctx.device)
        ctx.phase("store")
        self.task = WaveNetTask(self.cfg, gc_enable=False, device=ctx.device)
        self.p0 = weights.wavenet_weights(self.w, ctx.rng_seed(5), ctx.device)
        self.state = WaveNetTrainState(
            step=torch.zeros((), dtype=torch.int32, device=ctx.device),
            params=self.p0,
            ema_params={k: v.clone() for k, v in self.p0.items()},
            opt_state=self.task.tx.init(self.p0))
        self.batch_size = self.cfg.wavenet.batch_size
        self.samples = self.batcher.sample_size

    def step(self, rec: harness.Recorder = None):
        rec = rec or harness.Recorder()
        with rec.span("feed"):
            batch = next(self.feeder)
        with rec.span("train_step"):
            self.state, metrics = self.task.train_step(self.state, batch)
        return batch, metrics

    def first_steps(self, n: int, step_fn=None) -> dict:
        """Drive the state through its first ``n`` steps and keep what
        the check compares: the batches, each loss, the first gradient as
        Adam received it, and the change of the parameters and the EMA."""
        step_fn = step_fn or self.step
        batches, losses, first_grad = [], [], None
        for i in range(n):
            batch, metrics = step_fn()
            batches.append({k: v.clone() for k, v in batch.items()})
            losses.append(metrics["loss"])
            if i == 0:
                mu = _adam_mu(self.state.opt_state)
                first_grad = leaf_norms(
                    {k: v / (1 - ADAM_B1) for k, v in mu.items()})
        change = leaf_norms({k: self.state.params[k] - self.p0[k]
                             for k in self.p0})
        ema = leaf_norms({k: self.state.ema_params[k] - self.p0[k]
                          for k in self.p0})
        return {"batches": batches, "losses": [float(x) for x in losses],
                "first_grad": first_grad, "change": change, "ema": ema}

    def stop(self) -> None:
        self.feeder.stop()
        self.state = self.task = self.batcher = self.feeder = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def _adam_mu(opt_state) -> Dict[str, torch.Tensor]:
    """Adam's first moment in the optimizer's state (an optax-like tree:
    dicts and tuples, Adam's node holding ``mu``)."""
    if isinstance(opt_state, dict):
        if "mu" in opt_state:
            return opt_state["mu"]
        nodes = opt_state.values()
    elif isinstance(opt_state, (tuple, list)):
        nodes = opt_state
    else:
        nodes = ()
    for node in nodes:
        found = _adam_mu(node)
        if found is not None:
            return found
    return None


def reference_readings(ctx: Context, w: dict, batches: List[dict],
                       tf32: bool = False, rnd=ref.identity) -> dict:
    """The plain reference's steps from its own copy of the weights on
    ``batches``; with ``tf32`` its products in TF32 on the card (the
    control), with ``rnd`` its products' inputs rounded so."""
    params = weights.wavenet_weights(w, ctx.rng_seed(5), ctx.device)
    data = [(b["input_wav"][..., 0], b["local_condition"]) for b in batches]
    with harness.float32_products(tf32):
        out = ref.adam_steps(params, w, data, rnd=rnd)
    return {"losses": out["losses"],
            "first_grad": leaf_norms(out["first_grad"]),
            "change": leaf_norms({k: out["params"][k] - params[k]
                                  for k in params}),
            "ema": leaf_norms({k: out["ema"][k] - params[k]
                               for k in params})}


def compare(prog: dict, refr: dict) -> Dict[str, float]:
    """The numbers compared: the first step's loss and the widest of every
    step's (relative), the first gradient, the change and the EMA's change
    by the worst leaf.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone and are left
    out of the changes.  The later steps' losses carry Adam's first step,
    which moves every element whose gradient is rounding noise by a full
    learning rate of either sign, so the first step's loss is the steady
    one."""
    keys = list(refr["first_grad"])
    median = float(np.median([refr["first_grad"][k] for k in keys]))
    moving = [k for k in keys if refr["first_grad"][k] >= 1e-3 * median]
    gaps = [abs(a - b) / abs(b) for a, b in
            zip(prog["losses"], refr["losses"])]
    return {"first_loss_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": worst_leaf_gap(prog["first_grad"],
                                       refr["first_grad"], keys),
            "change_gap": worst_leaf_gap(prog["change"], refr["change"],
                                         moving),
            "ema_gap": worst_leaf_gap(prog["ema"], refr["ema"], moving)}


def data_mismatches(corpus: str, batches: List[dict], hop: int,
                    batcher_files: List[str]) -> int:
    """Rows that are not a frame-aligned crop of one training clip with its
    own mel frames (the store keeps mels in float16), plus batches that
    repeat an earlier one whole.  A single row may repeat: the batcher
    draws crops at random, and a short clip has few of them."""
    clips = []
    for path in batcher_files:
        with np.load(path) as f:
            clips.append((np.asarray(f["audio"], np.float32).reshape(-1),
                          np.asarray(f["mel"], np.float16).astype(np.float32)))
    bad, seen = 0, set()
    for b in batches:
        audio = b["input_wav"][..., 0].cpu().numpy()
        mel = b["local_condition"].cpu().numpy()
        bad += audio.tobytes() in seen
        seen.add(audio.tobytes())
        for row_a, row_m in zip(audio, mel):
            bad += not any(_is_crop(a, m, row_a, row_m, hop)
                           for a, m in clips)
    return bad


def _is_crop(audio, mel, row_a, row_m, hop) -> bool:
    frames = len(row_m)
    starts = audio[:(len(mel) - frames + 1) * hop:hop]
    for s in np.nonzero(starts == row_a[0])[0]:
        if np.array_equal(audio[s * hop:s * hop + len(row_a)], row_a):
            return np.array_equal(mel[s:s + frames], row_m)
    return False


def run(ctx: Context) -> Outcome:
    cell = TrainCell(ctx)
    n_check = ctx.workload["check"]["steps"]
    prog = cell.first_steps(n_check)
    ctx.phase("checked steps")
    files = [p for d in cell.batcher.path_dict.values() for p in d]
    window = ctx.window()
    ctx.end_setup()
    rec = ctx.recorder
    losses = []

    def body():
        window.open()
        while True:
            _, metrics = cell.step(rec)
            losses.append(metrics["loss"])
            if window.due():
                break
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        window.close()

    plain_step_s = None
    if ctx.traced:
        # The profiler doubles a step's host time, so the step time that
        # the whole-step share and the idle share read is taken untraced,
        # over the steps just before the traced ones.
        n = ctx.workload["trace"]["plain_units"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            cell.step()
        torch.cuda.synchronize()
        plain_step_s = (time.perf_counter() - t0) / n
    chrome = harness.traced_window(ctx, body)
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    last_loss = float(losses[-1])
    steps = len(losses)
    cell.stop()

    check = ctx.workload["check"]
    refr = reference_readings(ctx, cell.w, prog["batches"])
    numbers = compare(prog, refr)
    checks = [Check(k, v, check[k]) for k, v in numbers.items()]
    checks.append(Check("data_mismatch", float(data_mismatches(
        cell.corpus, prog["batches"], cell.hop, files)), 0.0))
    checks.append(Check("last_loss_nonfinite",
                        0.0 if np.isfinite(last_loss) else 1.0, 0.0))
    out = Outcome(attempted=steps, failed=0, checks=checks,
                  memory_peak_bytes=peak)
    samples = cell.batch_size * cell.samples
    out.e2e = {"train_samples_per_s": steps * samples / window.length}
    if chrome is not None:
        info = {"steps": steps, "window_s": window.length,
                "plain_step_s": plain_step_s,
                "step_flops": work.train_step_flops(
                    cell.w, cell.batch_size, cell.samples, cell.hop),
                "compute_dtype": cell.w["compute_dtype"]}
        out.trace = harness.parse_trace(chrome, rec, info)
    return out
