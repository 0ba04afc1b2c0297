"""The share of the traced serving window in which no device operation
runs."""


def read(trace):
    window = trace.window_us()
    if window <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_us() / window)
