"""Device time of every kernel launched inside the ``generate`` spans, per
autoregressive step those calls ran (each call's padded length): by span,
not by kernel name, so a renamed or split kernel is still counted."""


def read(trace):
    ops = trace.ops_in("generate")
    steps = trace.info.get("generate_steps")
    if not ops or not steps:
        return None
    return sum(o["te"] - o["ts"] for o in ops) / steps
