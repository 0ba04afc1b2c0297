"""The share of the traced training window spent in ``next()`` on the
prefetcher (the ``feed`` spans, host clock)."""


def read(trace):
    feeds = trace.recorder.of("feed")
    window_s = trace.info.get("window_s")
    if not feeds or not window_s:
        return None
    return 100.0 * sum(s.end - s.start for s in feeds) / window_s
