"""Readings for the limits of a cell's comparison, on the card at the
cell's own size: for each seed, the program's numbers (sound runs), the
control's (the plain reference in the program's place, one precision below
the configuration's) and, with ``--fault``, the program's numbers with a
fault planted under the timed path.  One JSON line per seed.

    python3 benchmark/control.py --workload wn_moon.vocode_b8 --seeds 1,2,3 --seconds 1
    python3 benchmark/control.py --workload wn_moon.train_b8 --seeds 1,2,3 --fault half_batch

Faults: ``token`` (one served sample of every answer altered where it is
produced), ``half_batch`` (vocode: half of a call's streams served, the
rest answered with their copies; train: each step on half of the batch,
its loss the mean over that half).  A state left unchanged reads 1 by the
training numbers' measure and needs no run.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def token_fault(generate):
    """``generate`` with one sample of each answer moved by 0.5 (towards
    the middle of [-1, 1]) a third of the way in."""
    def wrapped(mels, **kw):
        wavs = generate(mels, **kw)
        out = []
        for wav in wavs:
            wav = wav.copy()
            t = len(wav) // 3
            wav[t] = wav[t] - 0.5 if wav[t] > 0 else wav[t] + 0.5
            out.append(wav)
        return out
    return wrapped


def half_batch_fault(generate):
    """``generate`` on the first half of the streams, the rest answered
    with the first half's wavs, cut or padded to their lengths."""
    import numpy as np

    def wrapped(mels, **kw):
        half = max(1, len(mels) // 2)
        wavs = generate(mels[:half], **kw)
        out = list(wavs)
        for i in range(half, len(mels)):
            src = wavs[i % half]
            n = len(mels[i]) * (len(wavs[0]) // len(mels[0]))
            out.append(np.resize(src, n))
        return out
    return wrapped


def vocode_readings(ctx, fault):
    from benchmark import harness
    entry = harness.load_module("entries", "vocode")
    cell = entry.VocodeCell(ctx)
    cell.warm_up()
    if fault == "token":
        cell.generator.generate = token_fault(cell.generator.generate)
    elif fault == "half_batch":
        cell.generator.generate = half_batch_fault(cell.generator.generate)
    served = cell.serve(ctx.window(), ctx.np_seed(2))
    cell.free()
    check = ctx.workload["check"]
    sample = cell.sample_greedy(served, check["greedy_requests"],
                                ctx.np_seed(3))
    return {"requests": len(served), "greedy_checked": len(sample),
            "bad_answers": sum(cell.bad(s) for s in served),
            "program": cell.gaps(sample),
            "control": None if fault else cell.gaps(sample, control=True)}


def train_readings(ctx, fault, corpus):
    from benchmark import harness
    entry = harness.load_module("entries", "train")
    cell = entry.TrainCell(ctx, corpus)
    step = None
    if fault == "half_batch":
        def step():
            batch = next(cell.feeder)
            half = {k: v[:len(v) // 2] for k, v in batch.items()}
            cell.state, metrics = cell.task.train_step(cell.state, half)
            return batch, metrics
    prog = cell.first_steps(ctx.workload["check"]["steps"], step)
    corpus = cell.corpus
    cell.stop()
    refr = entry.reference_readings(ctx, cell.w, prog["batches"])
    out = {"program": entry.compare(prog, refr), "losses": prog["losses"]}
    if not fault:
        ctl = entry.reference_readings(ctx, cell.w, prog["batches"], tf32=True)
        out["control"] = entry.compare(ctl, refr)
    return out, corpus


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", choices=("token", "half_batch"))
    args = p.parse_args(argv)

    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 1
    workload = harness.load_workload(args.workload)
    config = harness.load_config(workload["config"])
    device = torch.device("cuda", 0)
    corpus = None
    with tempfile.TemporaryDirectory(prefix="bench-control-") as run_dir:
        for seed in (int(s) for s in args.seeds.split(",")):
            ctx = harness.Context(
                cell=args.workload, seed=seed, seconds=args.seconds,
                traced=False, workload=workload, config=config,
                device=device, run_dir=run_dir,
                setup_start=time.perf_counter(), recorder=harness.Recorder())
            if workload["entry"] == "vocode":
                out = vocode_readings(ctx, args.fault)
            else:
                out, corpus = train_readings(ctx, args.fault, corpus)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": args.fault, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
