"""Opt-in profiling (counterpart of the JAX package's
``utils/profiling.py``): a ``torch.profiler`` trace of a window of
training steps, written as a Chrome trace into ``log_dir/trace/``, and a
wall-clock step timer."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_window(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """Trace the enclosed work (host and, on a card, device activity) into
    ``log_dir/trace/trace_<ns>.json``."""
    if not enabled:
        yield
        return
    trace_dir = os.path.join(log_dir, "trace")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock per-step timing that skips the first ``warmup`` steps."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt

    @property
    def mean(self) -> float:
        steps = max(1, self.count - self.warmup)
        return self.total / steps


def maybe_trace_step(step: int, log_dir: str, store_metadata: bool,
                     every: int = 50, span: int = 3):
    """A context manager that traces steps [k * every, k * every + span)
    when ``store_metadata`` is set, and does nothing otherwise."""
    active = store_metadata and step % every < span
    return trace_window(log_dir, enabled=active)
