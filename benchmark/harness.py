"""The benchmark's shared machinery: the manifest and a cell's files, the
window, spans, the traced window and its reading, the check of imported
modules, and the result line.

Everything a configuration, a traffic mix, an entry or a per-layer metric
needs of its own lives in files found by name (``configs/<config>.json``,
``workloads/<cell>.json``, ``entries/<entry>.py``,
``metrics/<metric>.py``), so a later change adds cells and metrics as new
files and edits none of these.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

# Modules that may not be loaded in a run, by whole top-level name: the JAX
# stack and the JAX package, whose name the port's name begins with.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "tacotron_wavenet_vocoder_korean_tpu")
PORT = "tacotron_wavenet_vocoder_korean_tpu_torch"

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W).
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


# ----------------------------------------------------------------------
# Files of a cell
# ----------------------------------------------------------------------
def read_json(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_manifest() -> dict:
    return read_json(MANIFEST)


def load_workload(name: str) -> dict:
    return read_json(os.path.join(HERE, "workloads", name + ".json"))


def load_config(name: str) -> dict:
    return read_json(os.path.join(HERE, "configs", name + ".json"))


def load_module(kind: str, name: str):
    """``entries/<name>.py`` or ``metrics/<name>.py`` as a module (metric
    names hold dots, so they are loaded by path)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    module = sys.modules.get(spec.name)
    if module is None:
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module    # dataclasses look it up
        spec.loader.exec_module(module)
    return module


def cell_metrics(manifest: dict, cell: str, group: str) -> List[dict]:
    """The metrics of ``group`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those without a ``workloads`` key, and those whose
    key lists it."""
    return [m for m in manifest[group]
            if "workloads" not in m or cell in m["workloads"]]


def repo_path(rel: str) -> str:
    return os.path.join(ROOT, rel)


# ----------------------------------------------------------------------
# Statistics of the yardstick
# ----------------------------------------------------------------------
def percentile(values: List[float], q: float) -> float:
    """The nearest-rank percentile: the smallest value with at least
    ``q``% of all values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


# ----------------------------------------------------------------------
# Spans and the window
# ----------------------------------------------------------------------
@dataclass
class Span:
    name: str
    start: float
    end: float
    attrs: Dict[str, Any]


@dataclass
class Recorder:
    """Spans (host clock) taken from the benchmark's own files around the
    calls into each layer.  With ``traced`` every span is also a
    ``record_function`` range named ``bench.<name>``, so the profiler's
    trace ties the device's kernels to it."""
    traced: bool = False
    spans: List[Span] = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        rf = contextlib.nullcontext()
        if self.traced:
            import torch
            rf = torch.profiler.record_function("bench." + name)
        with rf:
            t0 = time.perf_counter()
            try:
                yield attrs
            finally:
                self.spans.append(Span(name, t0, time.perf_counter(), attrs))

    def of(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


class Window:
    """The measured window of a closed loop: it opens at ``open()`` and
    closes when the unit of work in flight at ``seconds`` has returned
    (``due()`` turns true after it), so no unit is dropped or counted in
    part.  Under a trace it runs a fixed number of units instead
    (``trace_units``) inside ``torch.profiler``."""

    def __init__(self, seconds: float, trace_units: Optional[int] = None):
        self.seconds = seconds
        self.trace_units = trace_units
        self.units = 0
        self.t0 = self.t1 = None

    def open(self) -> None:
        self.t0 = time.perf_counter()

    def due(self) -> bool:
        """Called after each unit has returned: count it, and say whether
        the window is over."""
        self.units += 1
        if self.trace_units is not None:
            return self.units >= self.trace_units
        return time.perf_counter() - self.t0 >= self.seconds

    def close(self) -> float:
        self.t1 = time.perf_counter()
        return self.t1 - self.t0

    @property
    def length(self) -> float:
        return self.t1 - self.t0


# ----------------------------------------------------------------------
# The traced window
# ----------------------------------------------------------------------
def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop_profiler(prof, run_dir: str) -> dict:
    """End the profiler and return its chrome trace as a dict (written to
    ``run_dir`` and deleted again)."""
    import torch
    torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    path = os.path.join(run_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return read_json(path)
    finally:
        os.remove(path)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    """What the per-layer readers read: the device operations, the
    benchmark's spans as the trace saw them (``bench.<name>``), the
    traced window, the recorder's spans and what the entry adds
    (``info``: work counts, steps, configuration)."""
    ops: List[dict]               # device ops: name, cat, ts, te (us)
    annotations: List[dict]       # bench.* ranges: name, ts, te, tid
    host_ops: List[dict]          # other host ranges: name, ts, te, tid
    window: tuple                 # (ts, te) us, from bench.window
    recorder: Recorder
    info: Dict[str, Any]

    # -- device time ---------------------------------------------------
    def busy_intervals(self) -> List[tuple]:
        w0, w1 = self.window
        iv = sorted((max(o["ts"], w0), min(o["te"], w1)) for o in self.ops
                    if o["te"] > w0 and o["ts"] < w1)
        merged: List[list] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [tuple(m) for m in merged]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def idle_gaps(self) -> List[tuple]:
        """(start, end) of each stretch of the window with no device
        operation."""
        gaps, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    # -- attribution ---------------------------------------------------
    def spans(self, name: str) -> List[dict]:
        return [a for a in self.annotations if a["name"] == "bench." + name]

    def ops_in(self, name: str) -> List[dict]:
        """The kernels launched inside the spans ``name``: by the launch
        call the trace ties to each (same thread, inside the span), or,
        for a kernel with no launch in the trace, by its start on the
        device inside the span."""
        spans = self.spans(name)
        out = []
        for o in self.ops:
            if o["cat"] != "kernel":
                continue
            for s in spans:
                if o.get("launch_ts") is not None:
                    inside = (o["launch_tid"] == s["tid"]
                              and s["ts"] <= o["launch_ts"] <= s["te"])
                else:
                    inside = s["ts"] <= o["ts"] <= s["te"]
                if inside:
                    out.append(o)
                    break
        return out

    def host_activity(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost benchmark span
        open then, and inside it the innermost host operation."""
        def innermost(ranges):
            best = None
            for r in ranges:
                if r["ts"] <= t <= r["te"] and (
                        best is None or r["te"] - r["ts"]
                        < best["te"] - best["ts"]):
                    best = r
            return best
        span = innermost([a for a in self.annotations
                          if a["name"] != "bench.window"])
        op = innermost(self.host_ops)
        parts = [span["name"][len("bench."):] if span else "window"]
        if op is not None:
            parts.append(op["name"])
        return " / ".join(parts)

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        w0, w1 = self.window
        for o in self.ops:
            if o["te"] > w0 and o["ts"] < w1:
                by_name[o["name"]] = (by_name.get(o["name"], 0.0)
                                      + (min(o["te"], w1) - max(o["ts"], w0)))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, us * 1e-6] for n, us in top],
                "idle_gaps": [[self.host_activity((a + b) / 2),
                               (b - a) * 1e-6] for a, b in gaps]}


def parse_trace(chrome: dict, recorder: Recorder,
                info: Dict[str, Any]) -> Trace:
    events = [e for e in chrome.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    ops, annotations, host_ops = [], [], []
    for e in events:
        cat = e.get("cat")
        ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat in DEVICE_CATS:
            launch = launches.get((e.get("args") or {}).get("correlation"))
            ops.append({"name": e.get("name", "?"), "cat": cat, "ts": ts,
                        "te": te,
                        "launch_ts": (None if launch is None
                                      else float(launch["ts"])),
                        "launch_tid": (None if launch is None
                                       else launch.get("tid"))})
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(
                "bench."):
            annotations.append({"name": e["name"], "ts": ts, "te": te,
                                "tid": e.get("tid")})
        elif cat in ("cpu_op",) + LAUNCH_CATS:
            host_ops.append({"name": e.get("name", "?"), "ts": ts, "te": te,
                             "tid": e.get("tid")})
    windows = [a for a in annotations if a["name"] == "bench.window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window ranges")
    return Trace(ops, annotations, host_ops,
                 (windows[0]["ts"], windows[0]["te"]), recorder, info)


# ----------------------------------------------------------------------
# Checks, the device, the result line
# ----------------------------------------------------------------------
def forbidden_modules() -> List[str]:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def require_clean_modules(where: str) -> None:
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: {where}: forbidden modules loaded: "
              f"{', '.join(bad)}", file=sys.stderr, flush=True)
        sys.exit(3)


@contextlib.contextmanager
def float32_products(tf32: bool = False):
    """float32 matrix products and convolutions in float32 on the card
    (or, with ``tf32``, in TF32), the caller's settings restored after."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi`` (None where it cannot
    say)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


@dataclass
class Check:
    """One number compared with its limit: correct while value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # NaN fails


def report(correct: bool, attempted: int, failed: int,
           metrics: Dict[str, tuple], device: dict, checks: List[Check],
           breakdown: Optional[dict] = None) -> str:
    """The result line (and the compared numbers as stderr's last lines)."""
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed),
            "metrics": {k: {"value": v, "unit": u}
                        for k, (v, u) in metrics.items()},
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    return json.dumps(line)


@dataclass
class Outcome:
    """What an entry hands back: end-to-end values (``e2e``), the
    traced window's reading (``trace``), the compared numbers and the
    counts of units attempted and failed."""
    attempted: int
    failed: int
    checks: List[Check]
    e2e: Dict[str, float] = field(default_factory=dict)
    trace: Optional[Trace] = None
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.ok for c in self.checks)


@dataclass
class Context:
    """What an entry is given."""
    cell: str
    seed: int
    seconds: float
    traced: bool
    workload: dict
    config: dict
    device: Any
    run_dir: str
    setup_start: float
    recorder: Recorder
    setup_s: Optional[float] = None

    def rng_seed(self, salt: int = 0) -> int:
        """A 63-bit seed for ``torch.Generator`` from the run's seed."""
        return (self.seed * 1_000_003 + salt) % (2 ** 63)

    def np_seed(self, salt: int = 0) -> int:
        """A 32-bit seed for numpy from the run's seed."""
        return (self.seed * 7919 + salt) % (2 ** 32)

    def window(self) -> Window:
        units = (self.workload.get("trace", {}).get("units")
                 if self.traced else None)
        return Window(self.seconds, units)

    def phase(self, name: str) -> None:
        """Note on stderr how far set-up has come."""
        print(f"setup {name}: {time.perf_counter() - self.setup_start:.3f} s",
              file=sys.stderr, flush=True)

    def end_setup(self) -> None:
        """Set-up is over: the first timed unit starts next."""
        require_clean_modules("end of set-up")
        self.setup_s = time.perf_counter() - self.setup_start
        self.phase("done")


def traced_window(ctx: Context, body: Callable[[], Any]) -> Optional[Any]:
    """Run ``body`` (the window loop) inside the profiler when the run is
    traced, within a ``bench.window`` range; returns the chrome trace or
    None."""
    if not ctx.traced:
        body()
        return None
    prof = start_profiler()
    try:
        with ctx.recorder.span("window"):
            body()
            import torch
            torch.cuda.synchronize()
    finally:
        chrome = stop_profiler(prof, ctx.run_dir)
    return chrome
