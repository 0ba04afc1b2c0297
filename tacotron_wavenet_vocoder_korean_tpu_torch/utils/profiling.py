"""Profiling of the port (counterpart of the JAX package's
``utils/profiling.py``): spans inside the port's own layers, and a
``torch.profiler`` trace of a window of training steps.

``span(name, **attrs)`` marks one stage of a call.  It records only while
a ``torch.profiler`` is recording; with none, it makes that one check
(``torch._C._autograd._profiler_enabled()``) and nothing more.  While one
records, a span does two things:

- it opens ``torch.profiler.record_function("twvk.<name>")``, so the
  profiler's chrome trace shows the stage as a range on the trace's own
  clock;
- it keeps a ``SpanRecord`` in a bounded buffer in memory: its name, its
  start and end in ``time.perf_counter_ns()`` (taken just outside the
  range), its parent, the call it belongs to (the id of the outermost span
  open on its thread), the OS thread id (``threading.get_native_id()``,
  the ``tid`` the chrome trace gives host events) and its attributes.
  ``spans()`` returns the buffer and ``clear_spans()`` empties it; a full
  buffer counts what it drops (``dropped_spans()``) instead of growing.

The buffer's clock is not the trace's: the chrome trace's ``ts`` is the
profiler's own clock.  ``on_trace_clock`` places records on the trace's
clock from one moment known on both.

The vocoder's spans (``synth/generator.py``, ``ops/wavenet_gen.py``), one
tree per ``WaveNetGenerator.generate`` call:

- ``generate`` (``streams``, ``frames``, ``steps`` = max frames x hop,
  ``samples`` = sum of frames x hop, ``greedy``), and inside it, in order:
- ``generate.prepare``: batching, speaker rows, seed audio, the mel's
  copy to the device;
- ``generate.condition``: the upsampler;
- ``generate.project``: the lc projection;
- ``wavenet_gen.launch`` (``streams``, ``steps``; on a card ``blocks`` and
  ``variant``): the kernel's prelude and launch, or the plain twin;
- ``generate.copy_out``: the samples' copy to the host, which waits for
  the kernel;
- ``generate.decode``: trimming and decoding.

Readers: the benchmark's ``vocoder.*`` metrics read the buffer of a
traced run.  Every chrome trace of work that runs these stages carries
their ``twvk.*`` ranges: the benchmark's traced window, and the trace that
``maybe_trace_step`` writes under the training commands'
``--store_metadata``.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

SPAN_LIMIT = 65536              # records the buffer holds
_OFF = contextlib.nullcontext()


@dataclass
class SpanRecord:
    id: int
    name: str
    start_ns: int               # time.perf_counter_ns()
    end_ns: int
    parent: Optional[int]       # id of the enclosing span, None for a root
    call: int                   # id of the outermost span open on the thread
    tid: int                    # threading.get_native_id()
    attrs: Dict[str, Any] = field(default_factory=dict)


class _SpanBuffer:
    """The records of closed spans, up to ``SPAN_LIMIT``, and the spans
    open on each thread."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self.ids = itertools.count()
        self.local = threading.local()

    def open_spans(self) -> List[SpanRecord]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, record: SpanRecord) -> None:
        if len(self.records) < SPAN_LIMIT:
            self.records.append(record)
        else:
            self.dropped += 1


_BUFFER = _SpanBuffer()


class _Span:
    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _BUFFER.open_spans()
        rid = next(_BUFFER.ids)
        self.record = SpanRecord(
            rid, self.name, 0, 0,
            stack[-1].id if stack else None,
            stack[0].id if stack else rid, threading.get_native_id(),
            self.attrs)
        stack.append(self.record)
        self.range = torch.profiler.record_function("twvk." + self.name)
        self.record.start_ns = time.perf_counter_ns()
        self.range.__enter__()

    def __exit__(self, *exc):
        try:
            self.range.__exit__(*exc)
        finally:
            self.record.end_ns = time.perf_counter_ns()
            _BUFFER.open_spans().pop()
            _BUFFER.add(self.record)


def span(name: str, **attrs):
    """A context manager marking one stage of a call (see the module's
    docstring); it records only while a ``torch.profiler`` records."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name, attrs)


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost span open on this thread (nothing
    when none is open, as when no profiler records)."""
    stack = _BUFFER.open_spans()
    if stack:
        stack[-1].attrs.update(attrs)


def spans() -> List[SpanRecord]:
    """The records of the spans closed since the last ``clear_spans``, in
    the order they closed."""
    return list(_BUFFER.records)


def dropped_spans() -> int:
    """Spans closed while the buffer was full, since the last
    ``clear_spans``."""
    return _BUFFER.dropped


def clear_spans() -> None:
    _BUFFER.records.clear()
    _BUFFER.dropped = 0


def on_trace_clock(records: List[SpanRecord], clock_ns: int,
                   trace_us: float
                   ) -> List[Tuple[SpanRecord, float, float]]:
    """Each record with its start and end in µs on a chrome trace's clock,
    given one moment known on both: ``clock_ns`` on
    ``time.perf_counter_ns()`` and ``trace_us`` on the trace's clock.

    Take the moment at the end of a ``record_function`` range, with
    ``perf_counter`` read just inside it (the benchmark's ``window`` span,
    for one): a process's first range stamps its start up to ~1 ms before
    the code inside it runs, while an end is stamped within microseconds.
    """
    offset = trace_us - clock_ns / 1e3
    return [(r, r.start_ns / 1e3 + offset, r.end_ns / 1e3 + offset)
            for r in records]


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


def maybe_trace_step(step: int, log_dir: str, store_metadata: bool,
                     every: int = 50, span: int = 3):
    """A context manager that traces steps [k * every, k * every + span)
    when ``store_metadata`` is set, and does nothing otherwise."""
    active = store_metadata and step % every < span
    return trace_window(log_dir, enabled=active)
