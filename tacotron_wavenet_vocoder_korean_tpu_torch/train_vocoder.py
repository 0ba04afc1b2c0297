"""WaveNet vocoder training CLI (counterpart of the root
``train_vocoder.py``).

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.train_vocoder \\
        --data_dir workdir/moon/data --log_dir logs/wavenet \\
        [--load_path artifacts/wn_moon.ckpt.tar.gz]

Several comma-separated ``--data_dir``s train one speaker each (global
conditioning).  ``--load_path`` continues a run (a run dir or a
``*.ckpt.tar.gz``: its config, state and step); ``--initialize_path``
starts from a run's weights and optimizer state at step 0.  The run dir
``--log_dir`` gets ``params.json``, ``train.log``, ``metrics.jsonl`` and
``ckpt/<step>/`` (read by the JAX package too).  ``touch LOG_DIR/STOP``
saves and ends the run at the next sync boundary.  Runs on the GPU unless
``--device cpu`` is given; with no GPU and no ``--device cpu`` it raises.

``--use_mesh`` trains data parallel over the ranks of the launch, one
card each (``n_model`` 1, as the JAX command):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m tacotron_wavenet_vocoder_korean_tpu_torch.train_vocoder \
        --use_mesh --data_dir ... --log_dir ...

Each rank takes its rows of the global ``batch_size`` batch, and the
gradients and losses are averaged over the ranks, so the run computes
what one process computes (``parallel.make_mesh`` picks NCCL, or gloo for
ranks sharing a card or with ``--device cpu``).  Rank 0 alone writes the
run dir and reads ``STOP``; its decision reaches every rank at the
boundary syncs.  Without the launcher, ``--use_mesh`` is a one-rank mesh.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np

from .config import (
    Config, debug_string, overlay, overlay_from_strings, split_overrides)
from .data.feeder import DevicePrefetcher
from .data.loader import WaveNetBatcher
from .device import resolve_device
from .parallel import make_mesh
from .train.checkpoints import (
    CheckpointManager, load_run_config, prepare_run_dir, restore_into_state)
from .train.wavenet_task import WaveNetTask, batch_to_device
from .train.watchdog import HangWatchdog
from .utils import infolog
from .utils.infolog import ValueWindow, log
from .utils.profiling import maybe_trace_step

CHECKPOINT_INTERVAL = 1000    # as the JAX trainer, not train.checkpoint_interval


def train(args) -> None:
    mesh = make_mesh(device=args.device) if args.use_mesh else None
    try:
        _train(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _train(args, mesh) -> None:
    device = mesh.device if mesh else resolve_device(args.device)
    main = mesh is None or mesh.is_main
    cfg = Config()
    if args.load_path:
        cfg = load_run_config(args.load_path)
    gc_enable = len(args.data_dir) > 1
    overrides = {"num_speakers": len(args.data_dir)} if gc_enable else {}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.num_steps:
        overrides["num_steps"] = args.num_steps
    if args.sample_size:
        overrides["sample_size"] = args.sample_size
    if overrides:
        cfg = overlay(cfg, wavenet=overrides)
    if args.max_host_rss_gb is not None:
        cfg = overlay(cfg, train={"max_host_rss_gb": args.max_host_rss_gb})
    if args.hparams:
        cfg = overlay_from_strings(cfg, split_overrides(args.hparams))

    log_dir = args.log_dir or os.path.join("logs", "wavenet")
    stop_path = os.path.join(log_dir, "STOP")
    if mesh is not None:     # every rank has read the run's params.json
        mesh.barrier()
    if main:
        prepare_run_dir(log_dir, cfg)
        if os.path.exists(stop_path):   # a stale stop request
            os.remove(stop_path)
    infolog.init(os.path.join(log_dir, "train.log"),
                 mesh.rank if mesh else 0)
    log(debug_string(cfg))
    if mesh is not None:
        log(mesh.describe())
    # Armed before any device work: the store upload, the init and the
    # restore can hang as a step can.
    hang_dog = HangWatchdog(cfg.train.hang_timeout_s, log_fn=log,
                            first_timeout_s=cfg.train.first_hang_timeout_s)

    use_store = cfg.train.device_resident_data
    batcher = WaveNetBatcher(args.data_dir, cfg, gc_enable=gc_enable,
                             device_store=use_store, device=device,
                             mesh=mesh)
    if use_store:
        log(f"device-resident clip store: "
            f"{batcher.store_bytes / 1e6:.0f} MB on device"
            + (" (whole on each rank)" if mesh else ""))
    task = WaveNetTask(cfg, gc_enable=gc_enable, device=device, mesh=mesh)

    # The JAX trainer draws one batch here, the example its init traces;
    # it is drawn here too, so that the stream that follows is JAX's.
    next(iter(batcher))
    state = task.init_state(cfg.train.random_seed)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"Initialized WaveNet: {n_params:,} params, "
        f"receptive_field={cfg.wavenet.receptive_field} samples, "
        f"gc={'on' if gc_enable else 'off'}")

    state, start_step = restore_into_state(state, args.load_path,
                                           args.initialize_path)
    if start_step:
        log(f"Resuming from step {start_step}")
    state = task.shard_state(state)

    ckpt = CheckpointManager(log_dir, max_to_keep=cfg.train.max_checkpoints,
                             mesh=mesh)
    save = lambda s: ckpt.save(s, task.gather_state(state))

    # Held-out eval stream (teacher-forced loss on unseen clips, EMA).
    test_batcher = WaveNetBatcher(
        args.data_dir, cfg, gc_enable=gc_enable, data_type="test",
        seed=cfg.train.random_seed + 1, batches_per_group=1)
    test_iter = iter(test_batcher)

    metrics_f = (open(os.path.join(log_dir, "metrics.jsonl"), "a",
                      encoding="utf-8") if main else None)
    feeder = DevicePrefetcher(batcher, device=device)
    time_window, loss_window = ValueWindow(100), ValueWindow(100)
    step = start_step
    # Pipelined dispatch: the host waits for the device only at a sync
    # boundary, and runs ahead between them.
    sync_every = cfg.train.sync_every
    t_sync, steps_since_sync = time.time(), 0
    try:
        for batch in feeder:
            if step == start_step and steps_since_sync == 0:
                log("first batch received; dispatching first train step")
            with maybe_trace_step(step, log_dir, cfg.train.store_metadata):
                state, metrics = task.train_step(state, batch)
            if step == start_step:
                log("first train step dispatched; fetching loss")
                log(f"first loss fetched: {float(metrics['loss']):.5f}")
                # the grace ends at the first completed step
                hang_dog.beat()
            step += 1
            steps_since_sync += 1
            boundary = (step % sync_every == 0
                        or step % cfg.train.summary_interval == 0
                        or step % cfg.train.test_interval == 0
                        or step % CHECKPOINT_INTERVAL == 0
                        or step >= cfg.wavenet.num_steps)
            if not boundary:
                continue
            loss = float(metrics["loss"])   # waits for the queued steps
            hang_dog.beat()
            now = time.time()
            time_window.append((now - t_sync) / steps_since_sync)
            t_sync, steps_since_sync = now, 0
            loss_window.append(loss)

            stop = main and os.path.exists(stop_path)
            if mesh is not None:
                stop = mesh.broadcast_flag(stop)
            if stop:
                log(f"STOP file found; saving checkpoint at step {step} "
                    "and exiting cleanly")
                save(step)
                break

            if step % sync_every == 0:
                log(f"Step {step:7d} [{time_window.average:.3f} sec/step, "
                    f"loss={loss:.5f}, avg_loss={loss_window.average:.5f}]")

            if np.isnan(loss):
                log(f"NaN loss at step {step}; aborting")
                raise RuntimeError("loss is NaN")

            if main and step % cfg.train.summary_interval == 0:
                metrics_f.write(json.dumps(
                    {"step": step,
                     **{k: float(v) for k, v in metrics.items()
                        if v.ndim == 0}}) + "\n")
                metrics_f.flush()

            if step % cfg.train.test_interval == 0:
                eval_out = task.eval_step(
                    state, batch_to_device(next(test_iter), device))
                test_loss = float(eval_out["loss"])
                log(f"  eval: test_loss={test_loss:.5f} "
                    f"(train-test gap={test_loss - loss:+.5f})")
                if main:
                    metrics_f.write(json.dumps(
                        {"step": step, "test_loss": test_loss,
                         "gap_test_train": test_loss - loss}) + "\n")
                    metrics_f.flush()

            if step % CHECKPOINT_INTERVAL == 0:
                log(f"Saving checkpoint at step {step}")
                save(step)

            if step >= cfg.wavenet.num_steps:
                log(f"Reached num_steps={cfg.wavenet.num_steps}; done")
                if ckpt.latest_step() != step:   # not saved just above
                    save(step)
                break
    except KeyboardInterrupt:
        log("Interrupted; saving checkpoint")
        if ckpt.latest_step() != step:
            save(step)
    finally:
        feeder.stop()
        if metrics_f is not None:
            metrics_f.close()
        hang_dog.stop()


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_dir", type=lambda s: s.split(","), required=True)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--load_path", default=None)
    p.add_argument("--initialize_path", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--sample_size", type=int, default=None)
    p.add_argument("--use_mesh", action="store_true",
                   help="data parallel over the ranks of a "
                        "torch.distributed.run launch")
    p.add_argument("--hparams", default=None,
                   help="comma-separated group.key=value config overrides "
                        "(e.g. wavenet.input_type=mulaw-quantize)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--max_host_rss_gb", type=float, default=None,
                   help="recorded in train.max_host_rss_gb (the JAX "
                        "trainer's RSS watchdog; the port has none)")
    args = p.parse_args(argv)
    if args.load_path and args.initialize_path:
        p.error("--load_path and --initialize_path are mutually exclusive")
    train(args)


if __name__ == "__main__":
    main()
