"""How full a call's streams are: the samples the port's ``generate``
spans delivered over the streams they ran times their padded steps (a call
lasts as long as its longest mel).  Prints the spans' count, time and
steps, and how far each program ``generate`` span placed on the trace's
clock lies from its ``bench.generate`` range."""
import sys

from benchmark import program_spans


def read(trace):
    spans = program_spans.placed(trace)
    if spans is None:
        return None
    calls = program_spans.named(spans, "generate")
    check = program_spans.clock_check(trace, spans)
    print(f"vocoder.stream_fill_pct: {len(calls)} generate spans, "
          f"{sum(s['te'] - s['ts'] for s in calls) * 1e-3!r} ms, "
          f"{sum(s['attrs']['steps'] for s in calls)} steps; against "
          f"bench.generate (widest start us, end us, same thread): {check}",
          file=sys.stderr)
    run = sum(s["attrs"]["streams"] * s["attrs"]["steps"] for s in calls)
    return 100.0 * sum(s["attrs"]["samples"] for s in calls) / run
