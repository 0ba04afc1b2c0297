"""The port's own spans (its ``utils/profiling``) as the ``vocoder.*``
readers see them: placed on the traced window's clock, with the device
operations launched inside them.

The port records spans only while a profiler runs, so its buffer holds the
traced window's calls and nothing of the warm-up or of the comparison.
They are placed by the end of the ``window`` span, known on both clocks
(the recorder's ``perf_counter`` and the trace's ``bench.window`` range).
A program without spans (one older than them) gives None here, and so do
the readers, without raising."""
from __future__ import annotations

import sys
from typing import Dict, List, Optional


def placed(trace) -> Optional[List[dict]]:
    """The port's spans on the trace's clock (``name``, ``ts``, ``te`` in
    µs, ``tid``, ``id``, ``parent``, ``call``, ``attrs``), or None when
    they hold no ``generate`` span."""
    try:
        from tacotron_wavenet_vocoder_korean_tpu_torch.utils import profiling
        records = profiling.spans()
        place = profiling.on_trace_clock
    except (ImportError, AttributeError):
        return None
    windows = trace.recorder.of("window")
    if len(windows) != 1 or not any(r.name == "generate" for r in records):
        return None
    if profiling.dropped_spans():
        print(f"program spans: {profiling.dropped_spans()} dropped by a full "
              f"buffer", file=sys.stderr)
    return [{"name": r.name, "ts": ts, "te": te, "tid": r.tid, "id": r.id,
             "parent": r.parent, "call": r.call, "attrs": r.attrs}
            for r, ts, te in place(records, round(windows[0].end * 1e9),
                                   trace.window[1])]


def named(spans: List[dict], *names: str) -> List[dict]:
    return [s for s in spans if s["name"] in names]


def kernels_in(trace, spans: List[dict]) -> List[dict]:
    """The kernels launched inside ``spans``: their launch call on the
    span's thread within it, or, for a kernel whose launch the trace does
    not hold, its start on the device within it."""
    out = []
    for o in trace.ops:
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


def device_us(ops: List[dict]) -> float:
    return sum(o["te"] - o["ts"] for o in ops)


def innermost(spans: List[dict], t: float) -> Optional[dict]:
    best = None
    for s in spans:
        if s["ts"] <= t <= s["te"] and (
                best is None or s["te"] - s["ts"] < best["te"] - best["ts"]):
            best = s
    return best


def idle_by_stage(trace, spans: List[dict]) -> Dict[str, float]:
    """µs of the window with no device operation inside each ``generate``
    span, split by the innermost span of its call open then."""
    gaps = trace.idle_gaps()
    out: Dict[str, float] = {}
    for g in named(spans, "generate"):
        members = [s for s in spans if s["call"] == g["call"]
                   and g["ts"] <= s["ts"] and s["te"] <= g["te"]]
        cuts = sorted({t for s in members for t in (s["ts"], s["te"])})
        for a, b in zip(cuts, cuts[1:]):
            idle = sum(max(0.0, min(b, y) - max(a, x)) for x, y in gaps)
            if idle > 0:
                name = innermost(members, (a + b) / 2)["name"]
                out[name] = out.get(name, 0.0) + idle
    return out


def clock_check(trace, spans: List[dict]) -> Optional[tuple]:
    """The widest distance (µs) between a program ``generate`` span's
    start and its ``bench.generate`` range's, the same between their ends,
    and whether each pair is on one thread."""
    progs = sorted(named(spans, "generate"), key=lambda s: s["ts"])
    bench = sorted(trace.spans("generate"), key=lambda s: s["ts"])
    if not progs or len(progs) != len(bench):
        return None
    pairs = list(zip(progs, bench))
    return (max(abs(p["ts"] - b["ts"]) for p, b in pairs),
            max(abs(p["te"] - b["te"]) for p, b in pairs),
            all(p["tid"] == b["tid"] for p, b in pairs))
