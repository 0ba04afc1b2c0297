"""The share of a training step in which no device operation runs: one
less the device's busy time per traced step over the untraced step time
(the steps just before the traced ones; the profiler doubles a step's host
time, not its device time)."""


def read(trace):
    steps = trace.info.get("steps")
    step_s = trace.info.get("plain_step_s")
    if not steps or not step_s or not trace.ops:
        return None
    busy_s = trace.busy_us() * 1e-6 / steps
    return 100.0 * max(0.0, 1.0 - busy_s / step_s)
