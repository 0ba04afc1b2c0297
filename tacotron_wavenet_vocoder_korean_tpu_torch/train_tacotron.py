"""Tacotron training CLI (counterpart of the root ``train_tacotron.py``).

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.train_tacotron \\
        --data_paths workdir/moon/data,workdir/son/data \\
        --log_dir logs/tacotron [--load_path artifacts/both_r2.ckpt.tar.gz]

Each comma-separated ``--data_paths`` dir is one speaker.  ``--load_path``
continues a run (a run dir or a ``*.ckpt.tar.gz``: its config, state and
step); ``--initialize_path`` starts from a run's weights, statistics and
optimizer state at step 0 (the learning rate goes on from the optimizer's
count, on the 40,000-step warmup).  The run dir ``--log_dir`` gets
``params.json``, ``train.log``, ``metrics.jsonl``, ``ckpt/<step>/`` (read
by the JAX package too), a Griffin-Lim wav and an alignment PNG of the
first test example at every test interval, and ``best/`` with
``best.json``: the checkpoint of the lowest free-running loss over
``train.best_eval_batches`` fixed held-out batches, kept across resumes.
``touch LOG_DIR/STOP`` saves and ends the run at the next sync boundary;
a loss above ``train.loss_explosion_threshold`` or NaN raises.  Runs on
the GPU unless ``--device cpu`` is given; with no GPU and no ``--device
cpu`` it raises.  ``--model_type`` picks the speaker mode with several
dirs (``deepvoice`` or ``simple``); the config's ``attention_type`` (any
of the nine, by ``--hparams tacotron.attention_type=loc_sen``) picks the
mechanism.

``--use_mesh`` trains data parallel over the ranks of the launch, one
card each, as the JAX command does over its devices:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m tacotron_wavenet_vocoder_korean_tpu_torch.train_tacotron \
        --use_mesh --data_paths ... --log_dir ...

Each rank takes its rows of the global batch, batch norm's statistics are
taken over the whole batch, dropout's masks are the global batch's, and
the gradients and losses are averaged over the ranks
(``train.tacotron_task``).  Rank 0 alone writes the run dir (logs,
checkpoints, the eval's wav and PNG, ``best/``) and reads ``STOP``; its
decision reaches every rank at the boundary syncs.  Without the launcher,
``--use_mesh`` is a one-rank mesh.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from datetime import datetime
from typing import List, Optional

import numpy as np
import torch

from .config import (
    Config, debug_string, overlay, overlay_from_strings, split_overrides)
from .data.feeder import DevicePrefetcher
from .data.loader import TacotronBatcher
from .device import resolve_device
from .dsp.audio_io import save_wav
from .dsp.griffin_lim import inv_linear_spectrogram
from .parallel import make_mesh
from .text import EOS, PAD, TextCodec, sequence_to_text
from .text.cleaners import get_cleaner
from .text.hangul import hangul_to_jamo
from .train.checkpoints import (
    CheckpointManager, load_run_config, prepare_run_dir, restore_into_state)
from .train.tacotron_task import TacotronTask, batch_to_device
from .train.watchdog import HangWatchdog
from .utils import infolog, plot
from .utils.infolog import MetricsWriter, ValueWindow, log
from .utils.profiling import maybe_trace_step


def save_and_plot(log_dir: str, step: int, eval_out, batch, cfg) -> None:
    """The Griffin-Lim wav and the alignment PNG of the first test
    example."""
    linear = eval_out["linear_outputs"][0]
    align = eval_out["alignments"][0].cpu().numpy()
    length = int(batch["input_lengths"][0])
    wav = inv_linear_spectrogram(linear.t(), cfg.audio).cpu().numpy()
    wav_path = os.path.join(log_dir, f"step-{step}-audio.wav")
    save_wav(wav, wav_path, cfg.audio.sample_rate)
    png_path = os.path.join(log_dir, f"step-{step}-align.png")
    plot.plot_alignment(align[:length], png_path)
    text = sequence_to_text(batch["inputs"][0, :length].tolist())
    log(f"  saved {wav_path} and {png_path} ({text!r}, loss "
        f"{float(eval_out['loss']):.5f})")


def check_text_roundtrip(data_paths, cleaners: str, max_logged: int = 10
                         ) -> int:
    """Re-decode every ``train.txt`` text and log the ones whose ids do
    not give back the jamo of the cleaned text (symbols the table drops);
    returns their number."""
    codec = TextCodec(cleaners)
    clean_fns = [get_cleaner(n) for n in codec.cleaner_names]
    n_bad = total = 0
    for d in data_paths:
        train_txt = os.path.join(d, "train.txt")
        if not os.path.exists(train_txt):
            continue
        with open(train_txt, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("|")
                if len(parts) < 4:
                    continue
                text = parts[3]
                total += 1
                cleaned = text
                for fn in clean_fns:
                    cleaned = fn(cleaned)
                expected = "".join(s for s in hangul_to_jamo(cleaned)
                                   if s not in (PAD, EOS))
                recovered = codec.decode(codec.encode(text),
                                         skip_eos_and_pad=True)
                if recovered != expected:
                    n_bad += 1
                    if n_bad <= max_logged:
                        log(f"  text round-trip mismatch [{d}]: {text!r}")
                        log(f"    recovered: {recovered!r}")
    log(f"text round-trip check: {total - n_bad}/{total} texts exact")
    return n_bad


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
    num_speakers = len(args.data_paths)
    cfg = overlay(cfg, tacotron={
        "num_speakers": num_speakers,
        "batch_size": args.batch_size or cfg.tacotron.batch_size,
        **({"model_type": args.model_type} if args.model_type else {}),
    })
    if args.max_host_rss_gb is not None:
        cfg = overlay(cfg, train={"max_host_rss_gb": args.max_host_rss_gb})
    # The held-out split depends on the filter: it is recorded in the run's
    # config, so that a resume rebuilds the same split.
    if args.skip_path_filter:
        cfg = overlay(cfg, train={"skip_path_filter": True})
    if args.hparams:
        cfg = overlay_from_strings(cfg, split_overrides(args.hparams))

    log_dir = args.log_dir or os.path.join(
        "logs", datetime.now().strftime("tacotron_%Y-%m-%d_%H-%M-%S"))
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
    train_batcher = TacotronBatcher(args.data_paths, cfg, "train",
                                    device_store=use_store, device=device,
                                    mesh=mesh)
    if use_store:
        log(f"device-resident corpus store: "
            f"{train_batcher.store_bytes / 1e6:.0f} MB on device"
            + (" (whole on each rank)" if mesh else ""))
    test_batcher = TacotronBatcher(args.data_paths, cfg, "test")
    check_text_roundtrip(args.data_paths, cfg.tacotron.cleaners)

    vocab_size = TextCodec(cfg.tacotron.cleaners).vocab_size
    task = TacotronTask(cfg, vocab_size=vocab_size,
                        is_randomly_initialized=not args.initialize_path,
                        device=device, mesh=mesh)
    # The JAX trainer draws one batch here, the example its init traces;
    # it is drawn here too, so that the stream that follows is JAX's.
    next(iter(train_batcher))
    state = task.init_state(cfg.train.random_seed)
    n_params = sum(p.numel() for p in state.params.values())
    log(f"Initialized Tacotron: {n_params:,} params, "
        f"{num_speakers} speaker(s), model_type={cfg.tacotron.model_type}")

    state, start_step = restore_into_state(
        state, args.load_path, args.initialize_path, task.from_jax_tree)
    if start_step:
        log(f"Resuming from step {start_step}")
    train_batcher.step = start_step
    # Dropout and scheduled sampling draw from a generator seeded by the
    # run's seed and its first step.
    generator = torch.Generator(device).manual_seed(
        cfg.train.random_seed * 1_000_003 + start_step)

    ckpt = CheckpointManager(log_dir, max_to_keep=cfg.train.max_checkpoints,
                             mesh=mesh)
    save = lambda mgr, s: mgr.save(s, task.to_jax_tree(state) if main
                                   else None)
    metrics_writer = MetricsWriter(
        os.path.join(log_dir, "metrics.jsonl") if main else None)

    # Best-heldout retention: the free-running loss over fixed held-out
    # batches at every test interval; the lowest one's checkpoint is kept
    # in <log_dir>/best/ (a run dir), its score in best.json.
    best_mgr, fixed_eval_batches, best_json = None, [], None
    if cfg.train.best_eval_batches > 0:
        best_dir = os.path.join(log_dir, "best")
        if main:
            prepare_run_dir(best_dir, cfg)
        best_mgr = CheckpointManager(best_dir, max_to_keep=1, mesh=mesh)
        best_json = os.path.join(best_dir, "best.json")
        fixed_iter = iter(TacotronBatcher(args.data_paths, cfg, "test"))
        fixed_eval_batches = [batch_to_device(next(fixed_iter), device)
                              for _ in range(cfg.train.best_eval_batches)]
    best_eval_loss = float("inf")
    if best_json and os.path.exists(best_json):
        with open(best_json, encoding="utf-8") as f:
            prev = json.load(f)
        best_eval_loss = float(prev.get("eval_loss", float("inf")))
        log(f"best-checkpoint tracker resumed: step {prev.get('step')} "
            f"eval_loss {best_eval_loss:.5f}")

    tdt = cfg.train.transfer_dtype
    cpu = torch.device("cpu")
    put = ((lambda b: {k: v.pin_memory() for k, v in
                       batch_to_device(b, cpu, tdt).items()})
           if device.type == "cuda" else
           (lambda b: batch_to_device(b, cpu, tdt)))
    feeder = DevicePrefetcher(train_batcher, put_fn=put, device=device)
    test_iter = iter(test_batcher)
    log("feeder started; entering train loop")

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
                state, metrics = task.train_step(state, batch,
                                                 generator=generator)
            if step == start_step:
                log("first train step dispatched; fetching loss")
                log(f"first loss fetched: {float(metrics['loss']):.5f}")
                # the grace ends at the first completed step
                hang_dog.beat()
            step += 1
            steps_since_sync += 1
            boundary = (step % sync_every == 0
                        or step % cfg.train.summary_interval == 0
                        or step % cfg.train.checkpoint_interval == 0
                        or step % cfg.train.test_interval == 0
                        or (args.num_steps and step >= args.num_steps))
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
                save(ckpt, step)
                break

            if step % sync_every == 0:
                log(f"Step {step:7d} [{time_window.average:.3f} sec/step, "
                    f"loss={loss:.5f}, avg_loss={loss_window.average:.5f}]")

            if loss > cfg.train.loss_explosion_threshold or np.isnan(loss):
                log(f"Loss exploded to {loss:.5f} at step {step}!")
                raise RuntimeError(f"loss exploded at step {step}")

            if step % cfg.train.summary_interval == 0:
                metrics_writer.write(step, metrics)

            if step % cfg.train.checkpoint_interval == 0:
                log(f"Saving checkpoint at step {step}")
                save(ckpt, step)

            if step % cfg.train.test_interval == 0:
                test_batch = batch_to_device(next(test_iter), device)
                eval_out = task.eval_step(state, test_batch)
                test_loss = float(eval_out["loss"])
                log(f"  eval: loss={test_loss:.5f} "
                    f"(train-test gap={test_loss - loss:+.5f})")
                metrics_writer.write(step, {
                    "test_loss": test_loss,
                    "test_mel_loss": eval_out["mel_loss"],
                    "test_linear_loss": eval_out["linear_loss"],
                    "gap_test_train": test_loss - loss,
                })
                if main:
                    save_and_plot(log_dir, step, eval_out, test_batch, cfg)
                if best_mgr is not None:
                    fixed_loss = float(np.mean([
                        float(task.eval_step(state, b)["loss_without_coeff"])
                        for b in fixed_eval_batches]))
                    hang_dog.beat()
                    metrics_writer.write(step, {"best_eval_loss": fixed_loss})
                    new_best = fixed_loss < best_eval_loss
                    if mesh is not None:    # rank 0's call, on every rank
                        new_best = mesh.broadcast_flag(new_best)
                    if new_best:
                        best_eval_loss = fixed_loss
                        log(f"  new best heldout eval loss {fixed_loss:.5f}; "
                            f"retaining checkpoint at step {step}")
                        save(best_mgr, step)
                        if main:
                            with open(best_json, "w", encoding="utf-8") as f:
                                json.dump({"step": step,
                                           "eval_loss": fixed_loss}, f)

            if args.num_steps and step >= args.num_steps:
                log(f"Reached num_steps={args.num_steps}; saving and exiting")
                if ckpt.latest_step() != step:   # not saved just above
                    save(ckpt, step)
                break
    except KeyboardInterrupt:
        log("Interrupted; saving checkpoint")
        if ckpt.latest_step() != step:
            save(ckpt, step)
    finally:
        feeder.stop()
        metrics_writer.close()
        hang_dog.stop()


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data_paths", type=lambda s: s.split(","), required=True)
    p.add_argument("--log_dir", default=None)
    p.add_argument("--load_path", default=None,
                   help="resume a run dir or tarball (keeps its step)")
    p.add_argument("--initialize_path", default=None,
                   help="warm-start from a run (step reset to 0)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_steps", type=int, default=None)
    p.add_argument("--model_type", default=None,
                   choices=[None, "single", "simple", "deepvoice"])
    p.add_argument("--skip_path_filter", action="store_true")
    p.add_argument("--hparams", default=None,
                   help="comma-separated group.key=value config overrides "
                        "(e.g. train.sync_every=10,train.test_interval=50)")
    p.add_argument("--use_mesh", action="store_true",
                   help="data parallel over the ranks of a "
                        "torch.distributed.run launch")
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
