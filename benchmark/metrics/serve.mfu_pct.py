"""The forward operations of every model serving the requests completed in
the traced window (counted from the configuration's shapes), over the
window's length times the published peak of the configuration's serving
type; the card's power limit is under ``device``."""
from benchmark.harness import PEAK_FLOPS


def read(trace):
    flops = trace.info.get("served_flops")
    window_s = trace.window_us() * 1e-6
    if not flops or window_s <= 0:
        return None
    return 100.0 * flops / (window_s * PEAK_FLOPS[trace.info["serve_dtype"]])
