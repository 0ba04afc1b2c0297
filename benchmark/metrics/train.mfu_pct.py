"""Three times the forward operations of the configuration's batch x crop
per step (counted from its shapes), over the step time and the published
peak of its compute type (float32 with TF32 off, as ``WaveNetTask`` runs
it: 67 TFLOP/s).  The step time is taken untraced, over the steps run just
before the traced ones, since the profiler doubles a step's host time."""
from benchmark.harness import PEAK_FLOPS


def read(trace):
    step_s = trace.info.get("plain_step_s")
    if not step_s:
        return None
    return 100.0 * trace.info["step_flops"] / (
        step_s * PEAK_FLOPS[trace.info["compute_dtype"]])
