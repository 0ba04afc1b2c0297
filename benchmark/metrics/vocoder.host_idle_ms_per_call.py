"""The stretches of the traced window with no device operation that lie
inside the port's ``generate`` spans, per call: the device waiting on the
host inside a call.  Prints the total split by the innermost span of the
call open at the time."""
import sys

from benchmark import program_spans


def read(trace):
    spans = program_spans.placed(trace)
    if spans is None or not trace.ops:
        return None
    split = program_spans.idle_by_stage(trace, spans)
    print("vocoder.host_idle_ms_per_call: idle by stage (ms): " + ", ".join(
        f"{name} {us * 1e-3!r}" for name, us in
        sorted(split.items(), key=lambda kv: -kv[1])), file=sys.stderr)
    calls = len(program_spans.named(spans, "generate"))
    return sum(split.values()) * 1e-3 / calls
