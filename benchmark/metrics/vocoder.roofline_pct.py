"""The least time the chip could take for the mel -> wav work of the
traced ``generate`` calls (upsampler, lc projection and per-sample network
over each wav's own length, counted from the configuration; weights read
once at the serving width, mels read and wavs written once), as a share of
the device time of the kernels launched inside them.  Prints which bound
sets the least time."""
import sys

from benchmark import work


def read(trace):
    ops = trace.ops_in("generate")
    if not ops:
        return None
    device_s = sum(o["te"] - o["ts"] for o in ops) * 1e-6
    info = trace.info
    least, bound = work.least_time(info["vocoder_flops"],
                                   info["vocoder_bytes"],
                                   info["serve_dtype"])
    print(f"vocoder.roofline_pct: bound by {bound}: least {least!r} s of "
          f"{device_s!r} s", file=sys.stderr)
    return 100.0 * least / device_s
