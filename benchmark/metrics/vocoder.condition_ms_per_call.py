"""Device time of the kernels launched inside the port's
``generate.prepare``, ``generate.condition`` and ``generate.project``
spans (the upsampler, the lc projection and what feeds them), per
``generate`` call."""
from benchmark import program_spans


def read(trace):
    spans = program_spans.placed(trace)
    if spans is None or not trace.ops:
        return None
    stages = program_spans.named(spans, "generate.prepare",
                                 "generate.condition", "generate.project")
    ops = program_spans.kernels_in(trace, stages)
    calls = len(program_spans.named(spans, "generate"))
    return program_spans.device_us(ops) * 1e-3 / calls
