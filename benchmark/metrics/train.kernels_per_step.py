"""Kernels launched inside the ``train_step`` spans, per step."""


def read(trace):
    spans = trace.spans("train_step")
    if not spans:
        return None
    return len(trace.ops_in("train_step")) / len(spans)
