"""The device's busy time in the traced training window per step: the
steadier statistic beside ``train_samples_per_s``, which the host's speed
moves from run to run while the device's work stays."""


def read(trace):
    steps = trace.info.get("steps")
    if not steps or not trace.ops:
        return None
    return trace.busy_us() * 1e-3 / steps
