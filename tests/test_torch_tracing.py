"""The port's spans (``utils/profiling``) on the vocoder path, on the CPU:
nothing recorded without a profiler; under one, one tree per
``WaveNetGenerator.generate`` call with its stages in order and its counts;
the ``twvk.*`` ranges in the chrome trace, where ``on_trace_clock`` places
the buffered spans; the buffer's bound."""
import gc
import json
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch.convert import seeded_params
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
    WaveNetGenerator)
from tacotron_wavenet_vocoder_korean_tpu_torch.utils import profiling

HOP = 10
STAGES = ["generate.prepare", "generate.condition", "generate.project",
          "wavenet_gen.launch", "generate.copy_out", "generate.decode"]


@pytest.fixture(scope="module")
def generator():
    w = PC.WaveNetConfig(
        dilations=(1, 2, 1, 2), residual_channels=4, dilation_channels=4,
        skip_channels=8, out_channels=12, initial_filter_width=4,
        upsample_factor=(2, 5))
    cfg = PC.Config(audio=PC.AudioConfig(hop_size=HOP), wavenet=w)
    return WaveNetGenerator(cfg, seeded_params(w, 0), device="cpu")


def mels(frames):
    rng = np.random.default_rng(len(frames))
    return [rng.standard_normal((f, 80)).astype(np.float32) for f in frames]


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def test_nothing_recorded_without_a_profiler(generator):
    generator.generate(mels([3, 2]), deterministic=True)
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def traced_calls(generator, calls, path=None):
    """Run ``calls`` (lists of frame counts) under a CPU profiler, inside
    an ``anchor`` range as the benchmark runs its calls inside its window;
    return perf_counter_ns just inside the anchor's end, and the chrome
    trace's events when ``path`` is given."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("anchor"):
            for i, frames in enumerate(calls):
                generator.generate(mels(frames), seed=i,
                                   deterministic=i % 2 == 0)
            anchor_ns = time.perf_counter_ns()
    if path is None:
        return anchor_ns, None
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        return anchor_ns, json.load(f)["traceEvents"]


def test_each_call_is_one_tree_of_its_stages(generator):
    calls = [[3, 2, 4], [2]]
    traced_calls(generator, calls)
    records = sorted(profiling.spans(), key=lambda r: r.start_ns)
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["generate", "generate"]
    for root, frames in zip(roots, calls):
        kids = [r for r in records if r.parent == root.id]
        assert [r.name for r in kids] == STAGES
        assert all(r.call == root.id for r in records
                   if root.start_ns <= r.start_ns <= root.end_ns)
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
        assert all(root.start_ns <= k.start_ns <= k.end_ns <= root.end_ns
                   for k in kids)
        assert root.attrs == {
            "streams": len(frames), "frames": frames,
            "steps": max(frames) * HOP, "samples": sum(frames) * HOP,
            "greedy": root is roots[0]}
        launch = kids[STAGES.index("wavenet_gen.launch")]
        assert launch.attrs == {"streams": len(frames),
                                "steps": max(frames) * HOP}
    assert len({r.tid for r in records}) == 1
    assert len(records) == 2 * (1 + len(STAGES))


def placement_errors(generator, path):
    """One profiled run of two calls: the twvk.* ranges of the chrome
    trace, in order, each beside its buffered span placed on the trace's
    clock, as (range, record, |start error|, |end error|) in µs."""
    profiling.clear_spans()
    gc.disable()        # a collection between two stamps is not the clock
    try:
        anchor_ns, events = traced_calls(generator, [[3, 2], [2, 4]], path)
    finally:
        gc.enable()
    ranges = sorted((e for e in events if e.get("ph") == "X"
                     and str(e.get("name")).startswith("twvk.")),
                    key=lambda e: e["ts"])
    anchor = next(e for e in events if e.get("name") == "anchor")
    placed = sorted(profiling.on_trace_clock(
        profiling.spans(), anchor_ns, anchor["ts"] + anchor["dur"]),
        key=lambda p: p[1])
    assert [e["name"] for e in ranges] == ["twvk." + r.name
                                           for r, _, _ in placed]
    return [(e, r, abs(ts - e["ts"]), abs(te - (e["ts"] + e["dur"])))
            for e, (r, ts, te) in zip(ranges, placed)]


def test_trace_holds_the_ranges_where_the_clock_places_them(generator,
                                                            tmp_path):
    """Every span within 50 µs of its range at both ends, in the best of
    three profiled runs: on a loaded host the scheduler can take the thread
    away between a span's stamp and the profiler's."""
    traced_calls(generator, [[2]])      # the profiler's first ranges
    runs = [placement_errors(generator, str(tmp_path / f"{i}.json"))
            for i in range(3)]
    best = min(runs, key=lambda s: max(max(a, b) for _, _, a, b in s))
    for e, r, start, end in best:
        assert e["tid"] == r.tid
        assert start <= 50 and end <= 50, (e["name"], start, end)


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LIMIT", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 3 and profiling.dropped_spans() == 2
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
