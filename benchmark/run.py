"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` runs a
fixed number of the cell's units under ``torch.profiler`` and prints its
per-layer metrics (each read by ``metrics/<name>.py``), the device's busy
time and the breakdown.  The run fails, printing no result, without as
many CUDA devices as the cell asks for, and when the JAX stack or the JAX
package is loaded at the end of set-up or after the window.  The numbers
compared with the plain reference are printed beside their limits, last
on standard error and last in the result line.
"""
import time

SETUP_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches of the program stay inside the checkout, at fixed
# paths, so that a checkout builds once.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness
    manifest = harness.load_manifest()
    cells = {c["name"]: c for c in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    workload = harness.load_workload(args.workload)
    config = harness.load_config(cell["config"])

    import torch
    print(f"setup torch: {time.perf_counter() - SETUP_START:.3f} s",
          file=sys.stderr)
    chips = cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kind = torch.cuda.get_device_name(0)
    print(f"setup cuda: {time.perf_counter() - SETUP_START:.3f} s",
          file=sys.stderr)
    entry = harness.load_module("entries", workload["entry"])
    with tempfile.TemporaryDirectory(prefix="bench-") as run_dir:
        ctx = harness.Context(
            cell=args.workload, seed=args.seed, seconds=args.seconds,
            traced=bool(args.trace), workload=workload, config=config,
            device=device, run_dir=run_dir, setup_start=SETUP_START,
            recorder=harness.Recorder(traced=bool(args.trace)))
        out = entry.run(ctx)
    harness.require_clean_modules("after the window")
    power = harness.power_limit_w()

    device_info = {"platform": "gpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": int(out.memory_peak_bytes),
                   "power_limit_w": power}
    metrics, breakdown = {}, None
    if not args.trace:
        values = dict(out.e2e, setup_s=ctx.setup_s)
        for m in harness.cell_metrics(manifest, args.workload, "end_to_end"):
            if values.get(m["name"]) is None:
                print(f"benchmark: no value for {m['name']}", file=sys.stderr)
                return 4
            metrics[m["name"]] = (values[m["name"]], m["unit"])
    else:
        trace = out.trace
        device_info["busy_s"] = trace.busy_us() * 1e-6 / chips
        device_info["window_s"] = trace.window_us() * 1e-6
        for m in harness.cell_metrics(manifest, args.workload, "per_layer"):
            value = harness.load_module("metrics", m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        breakdown = trace.breakdown()
    print(harness.report(out.correct, out.attempted, out.failed, metrics,
                         device_info, out.checks, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
