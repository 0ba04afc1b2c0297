"""The readers of the port's own spans (``program_spans.py`` and the four
``vocoder.*`` metrics built on it): their values on a made-up trace and a
made-up span buffer, with kernels launched outside every program span or
on another thread left out; None without spans; and the stream fill of a
tiny traced vocode run on the CPU against its traffic's hand value."""
import pytest
import torch

from benchmark import harness, program_spans
from benchmark.tests import tiny
from tacotron_wavenet_vocoder_korean_tpu_torch.utils import profiling

READERS = ["vocoder.kernel_us_per_step", "vocoder.condition_ms_per_call",
           "vocoder.host_idle_ms_per_call", "vocoder.stream_fill_pct"]
WINDOW_END_S = 2.0          # the window's end on the recorder's clock


def read(name, trace):
    return harness.load_module("metrics", name).read(trace)


def ns(t_us):
    """The perf_counter_ns that lands on ``t_us`` of the made-up trace."""
    return round((WINDOW_END_S * 1e6 - 1000 + t_us) * 1e3)


def record(id, name, ts, te, attrs=None):
    return profiling.SpanRecord(id, name, ns(ts), ns(te),
                                None if id == 0 else 0, 0, 1, attrs or {})


# One call on thread 1 (µs): generate 20-890 and its stages in order.
SPANS = [
    record(0, "generate", 20, 890, {"streams": 2, "frames": [3, 2],
                                     "steps": 30, "samples": 50,
                                     "greedy": True}),
    record(1, "generate.prepare", 30, 100),
    record(2, "generate.condition", 100, 200),
    record(3, "generate.project", 200, 260),
    record(4, "wavenet_gen.launch", 260, 300, {"streams": 2, "steps": 30}),
    record(5, "generate.copy_out", 300, 850),
    record(6, "generate.decode", 850, 880),
]


def launched(corr, tid, at, name, ts, te, cat="kernel"):
    return [{"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at,
             "dur": 1, "tid": tid, "args": {"correlation": corr}},
            {"cat": cat, "name": name, "ts": ts, "dur": te - ts, "tid": 7,
             "args": {"correlation": corr}}]


def made_up_trace():
    ev = [{"cat": "user_annotation", "name": "bench.window", "ts": 0,
           "dur": 1000, "tid": 1},
          {"cat": "user_annotation", "name": "bench.generate", "ts": 10,
           "dur": 890, "tid": 1}]
    ev += launched(1, 1, 110, "upsample", 120, 160)     # in condition
    ev += launched(2, 2, 120, "other_thread", 165, 170)
    ev += launched(3, 1, 210, "project", 215, 255)      # in project
    ev += launched(4, 1, 280, "k1", 285, 785)           # in launch
    ev += launched(5, 1, 310, "copy", 800, 810, cat="gpu_memcpy")
    ev += launched(6, 1, 950, "outside", 955, 975)      # in no span
    rec = harness.Recorder()
    rec.spans = [harness.Span("window", 1.0, WINDOW_END_S, {}),
                 harness.Span("generate", 1.0, 1.5, {})]
    chrome = {"traceEvents": [dict(ph="X", **e) for e in ev]}
    return harness.parse_trace(chrome, rec, {})


@pytest.fixture
def buffer(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))


def test_spans_placed_on_the_trace_clock(buffer):
    spans = program_spans.placed(made_up_trace())
    got = [(s["name"], s["ts"], s["te"]) for s in spans]
    want = [(r.name, t0, t1) for r, (t0, t1) in zip(SPANS, [
        (20, 890), (30, 100), (100, 200), (200, 260), (260, 300),
        (300, 850), (850, 880)])]
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    for (_, a, b), (_, c, d) in zip(got, want):
        assert a == pytest.approx(c, abs=1e-3) and b == pytest.approx(
            d, abs=1e-3)


def test_readers_on_a_made_up_trace(buffer):
    t = made_up_trace()
    assert read("vocoder.kernel_us_per_step", t) == pytest.approx(500 / 30)
    assert read("vocoder.condition_ms_per_call", t) == pytest.approx(0.080)
    # idle inside generate: 20-120, 160-165, 170-215, 255-285, 785-800,
    # 810-890
    assert read("vocoder.host_idle_ms_per_call", t) == pytest.approx(0.275)
    assert read("vocoder.stream_fill_pct", t) == pytest.approx(100 * 50 / 60)


def test_idle_split_by_the_innermost_stage(buffer):
    t = made_up_trace()
    split = program_spans.idle_by_stage(t, program_spans.placed(t))
    want = {"generate": 20, "generate.prepare": 70, "generate.condition": 55,
            "generate.project": 20, "wavenet_gen.launch": 25,
            "generate.copy_out": 55, "generate.decode": 30}
    assert split == pytest.approx(want, abs=1e-3)
    assert program_spans.clock_check(t, program_spans.placed(t)) == (
        pytest.approx(10, abs=1e-3), pytest.approx(10, abs=1e-3), True)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_nothing_without_spans(monkeypatch, name):
    t = made_up_trace()
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(name, t) is None
    # a program older than the spans
    monkeypatch.delattr(profiling, "spans")
    assert read(name, t) is None


def test_tiny_traced_vocode_reads_its_traffic_fill(monkeypatch):
    """Frames 2-5, 4 a round, 2 a call: the traced window's 2 calls hold
    [3, 5] (the longest first) and [2, 4].  The traced window's device
    synchronisations are no-ops on the CPU."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    conf = tiny.tiny_config("wn_moon")
    wl = tiny.tiny_workload("wn_moon.vocode_b8", frames=[2, 5],
                            per_round=4, batch=2)
    ctx = tiny.context("wn_moon.vocode_b8", conf, wl, traced=True)
    profiling.clear_spans()
    try:
        out = harness.load_module("entries", "vocode").run(ctx)
        assert out.correct
        assert read("vocoder.stream_fill_pct", out.trace) == pytest.approx(
            100 * (8 + 6) / (2 * 5 + 2 * 4))
        for name in READERS[:3]:          # no device on the CPU
            assert read(name, out.trace) is None
    finally:
        profiling.clear_spans()
