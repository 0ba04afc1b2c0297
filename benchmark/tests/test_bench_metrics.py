"""The metric arithmetic: a rate is all the work over the whole window; the
p95 is over all requests; the call in flight at ``--seconds`` ends the
window; the trace's busy time, idle gaps and the attribution of kernels
to spans; the per-layer readers on a made-up trace."""
import pytest

from benchmark import harness, work
from benchmark.tests import tiny


def test_percentile_is_nearest_rank_over_all_values():
    values = list(range(1, 101))
    assert harness.percentile(values, 95) == 95
    assert harness.percentile([3.0], 95) == 3.0
    assert harness.percentile([5, 1, 4, 2, 3], 95) == 5
    assert harness.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10] * 2, 95) == 10


def test_window_ends_with_the_unit_in_flight(monkeypatch):
    clock = iter([0.0, 4.0, 8.0, 12.5, 12.5])
    monkeypatch.setattr(harness.time, "perf_counter", lambda: next(clock))
    w = harness.Window(10.0)
    w.open()                       # t = 0
    assert not w.due()             # a unit returned at 4
    assert not w.due()             # at 8
    assert w.due()                 # the unit in flight at 10 returned at 12.5
    assert w.close() == 12.5 and w.units == 3


def test_traced_window_runs_its_units():
    w = harness.Window(1000.0, trace_units=2)
    w.open()
    assert not w.due() and w.due()


def test_vocode_rate_and_tail_cover_every_request():
    conf = tiny.tiny_config("wn_moon")
    wl = tiny.tiny_workload("wn_moon.vocode_b8", frames=[2, 4],
                            per_round=8, batch=4)
    ctx = tiny.context("wn_moon.vocode_b8", conf, wl, seconds=0.3)
    out = harness.load_module("entries", "vocode").run(ctx)
    spans = ctx.recorder.of("generate")
    hop, sr = conf["audio"]["hop_size"], conf["audio"]["sample_rate"]
    frames = [n for s in spans for n in s.attrs["frames"]]
    assert out.attempted == len(frames) >= 4
    window = spans[-1].end - spans[0].start
    # the window opens before the first call and closes after the last
    rate = sum(frames) * hop / sr / out.e2e["audio_s_per_s"]
    assert window <= rate <= window + 0.05
    latencies = sorted(s.end - s.start for s in spans for _ in
                       s.attrs["frames"])
    assert out.e2e["request_p95_s"] == pytest.approx(
        harness.percentile(latencies, 95), abs=0.01)


def chrome(events):
    return {"traceEvents": [dict(ph="X", **e) for e in events]}


def made_up_trace(info=None):
    ev = [
        {"cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100,
         "tid": 1},
        {"cat": "user_annotation", "name": "bench.generate", "ts": 10,
         "dur": 40, "tid": 1},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 60, "dur": 20, "tid": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12,
         "dur": 1, "tid": 1, "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k1", "ts": 20, "dur": 30, "tid": 7,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 61,
         "dur": 1, "tid": 1, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "k2", "ts": 65, "dur": 10, "tid": 7,
         "args": {"correlation": 2}},
        {"cat": "gpu_memcpy", "name": "copy", "ts": 45, "dur": 10, "tid": 7,
         "args": {"correlation": 3}},
    ]
    return harness.parse_trace(chrome(ev), harness.Recorder(), info or {})


def test_busy_idle_and_attribution():
    t = made_up_trace()
    assert t.window == (0.0, 100.0)
    assert t.busy_us() == pytest.approx(45.0)      # [20, 55] and [65, 75]
    assert t.idle_gaps() == [(0.0, 20.0), (55.0, 65.0), (75.0, 100.0)]
    assert [o["name"] for o in t.ops_in("generate")] == ["k1"]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    assert b["idle_gaps"][0][1] == pytest.approx(25e-6)
    assert [g[0] for g in b["idle_gaps"]] == ["window", "generate",
                                              "window / aten::mm"]


def test_serving_readers_on_a_made_up_trace():
    w = harness.load_config("wn_moon")["wavenet"]
    frames, hop = [10], 300
    flops = work.mel_to_wav_flops(w, frames, hop)
    nbytes = work.mel_to_wav_bytes(w, frames, hop, "bfloat16")
    t = made_up_trace({"generate_steps": 3000, "vocoder_flops": flops,
                       "vocoder_bytes": nbytes,
                       "served_flops": flops, "serve_dtype": "bfloat16"})
    read = lambda name: harness.load_module("metrics", name).read(t)
    assert read("vocoder.device_us_per_step") == pytest.approx(30 / 3000)
    least, _ = work.least_time(flops, nbytes, "bfloat16")
    assert read("vocoder.roofline_pct") == pytest.approx(
        100 * least / 30e-6)
    assert read("serve.mfu_pct") == pytest.approx(
        100 * flops / (100e-6 * 989e12))
    assert read("serve.idle_pct") == pytest.approx(55.0)


def test_readers_return_nothing_without_their_spans():
    t = made_up_trace({"steps": 0})
    for name in ("train.kernels_per_step", "train.mfu_pct",
                 "train.feeder_wait_pct"):
        assert harness.load_module("metrics", name).read(t) is None


def test_training_readers_on_a_made_up_trace():
    t = made_up_trace({"steps": 2, "plain_step_s": 100e-6,
                       "step_flops": 67e12 * 50e-6,
                       "compute_dtype": "float32"})
    read = lambda name: harness.load_module("metrics", name).read(t)
    assert read("train.device_ms_per_step") == pytest.approx(45e-3 / 2)
    assert read("train.mfu_pct") == pytest.approx(50.0)
    assert read("train.idle_pct") == pytest.approx(100 * (1 - 22.5 / 100))
