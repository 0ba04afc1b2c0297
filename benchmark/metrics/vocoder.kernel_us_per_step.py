"""Device time of the kernels launched inside the port's
``wavenet_gen.launch`` spans (the generation kernel, with the launch
prelude's ring fill and seed draw), per autoregressive step those launches
ran (each span's ``steps``): the kernel alone, without the call's
conditioning.  Prints how many kernels it counts."""
import sys

from benchmark import program_spans


def read(trace):
    spans = program_spans.placed(trace)
    if spans is None:
        return None
    launches = program_spans.named(spans, "wavenet_gen.launch")
    ops = program_spans.kernels_in(trace, launches)
    steps = sum(s["attrs"]["steps"] for s in launches)
    print(f"vocoder.kernel_us_per_step: {len(ops)} kernels in "
          f"{len(launches)} launch spans, "
          f"{sum(o['launch_ts'] is None for o in ops)} without a launch call "
          f"in the trace", file=sys.stderr)
    if not ops or not steps:
        return None
    return program_spans.device_us(ops) / steps
