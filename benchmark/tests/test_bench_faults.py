"""The comparison that decides ``correct``, at tiny sizes on the CPU: each
entry runs the rest of a run (the look for a card skipped), comes out
correct on the program as it is, and incorrect with the timed path broken
underneath, once for each fault the cell can have; and the control, the
reference one precision below, reads above the program.  The same
readings at the cells' own sizes are taken on the card by ``control.py``
and by the ``cuda`` tests below."""
import numpy as np
import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny

VOCODE = "wn_moon.vocode_b8"
TRAIN = "wn_moon.train_b8"


def vocode_ctx(seed=3, **traffic):
    conf = tiny.tiny_config("wn_moon")
    wl = tiny.tiny_workload(VOCODE, **dict(dict(frames=[2, 4], per_round=8,
                                                batch=4), **traffic))
    return tiny.context(VOCODE, conf, wl, seed=seed, seconds=0.3)


def train_ctx(seed=3):
    conf = tiny.tiny_config("wn_moon")
    wl = tiny.tiny_workload(TRAIN, max_clips=4)
    return tiny.context(TRAIN, conf, wl, seed=seed, seconds=0.3)


def generator_class():
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
        WaveNetGenerator)
    return WaveNetGenerator


def task_class():
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
        WaveNetTask)
    return WaveNetTask


def run(ctx):
    return harness.load_module("entries", ctx.workload["entry"]).run(ctx)


def test_vocode_sound_run_is_correct():
    out = run(vocode_ctx())
    assert out.correct, [(c.name, c.value) for c in out.checks]


@pytest.mark.parametrize("fault", ["token", "half_batch"])
def test_vocode_fault_is_caught(monkeypatch, fault):
    cls = generator_class()
    plant = {"token": control.token_fault,
             "half_batch": control.half_batch_fault}[fault]
    real = cls.generate
    monkeypatch.setattr(cls, "generate", lambda self, mels, **kw: plant(
        lambda m, **k: real(self, m, **k))(mels, **kw))
    out = run(vocode_ctx())
    assert not out.correct


def test_vocode_control_reads_above_the_program():
    ctx = vocode_ctx()
    out = control.vocode_readings(ctx, None)
    assert out["greedy_checked"] >= 1
    assert out["control"] > 3 * out["program"]


def test_train_sound_run_is_correct():
    out = run(train_ctx())
    assert out.correct, [(c.name, c.value) for c in out.checks]


def unchanged_state(real):
    def step(self, state, batch):
        _, metrics = real(self, state, batch)
        return state, metrics
    return step


def half_batch(real):
    def step(self, state, batch):
        return real(self, state, {k: v[:len(v) // 2] for k, v in
                                  batch.items()})
    return step


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_train_fault_is_caught(monkeypatch, fault):
    cls = task_class()
    monkeypatch.setattr(cls, "train_step", fault(cls.train_step))
    out = run(train_ctx())
    assert not out.correct


def test_train_control_reads_above_the_program():
    """The CPU has no TF32 products: here the control rounds every
    product's inputs to TF32's mantissa by hand (``reference.tf32``)."""
    from benchmark.reference import wavenet as ref
    ctx = train_ctx()
    entry = harness.load_module("entries", "train")
    cell = entry.TrainCell(ctx)
    prog = cell.first_steps(3)
    cell.stop()
    refr = entry.reference_readings(ctx, cell.w, prog["batches"])
    ctl = entry.reference_readings(ctx, cell.w, prog["batches"], rnd=ref.tf32)
    sound, low = entry.compare(prog, refr), entry.compare(ctl, refr)
    assert any(low[k] > 3 * sound[k] for k in sound), (sound, low)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


def card_ctx(cell, seed, seconds):
    wl = harness.load_workload(cell)
    return harness.Context(
        cell=cell, seed=seed, seconds=seconds, traced=False, workload=wl,
        config=harness.load_config(wl["config"]),
        device=torch.device("cuda", 0), run_dir=str(seed),
        setup_start=0.0, recorder=harness.Recorder())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_card_vocode_control_fails_its_limit(card, seed):
    ctx = card_ctx(VOCODE, seed, 1.0)
    out = control.vocode_readings(ctx, None)
    limit = ctx.workload["check"]["greedy_gap"]
    assert out["program"] <= limit < out["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_card_train_control_fails_a_limit(card, seed, tmp_path):
    ctx = card_ctx(TRAIN, seed, 1.0)
    ctx.run_dir = str(tmp_path)
    out, _ = control.train_readings(ctx, None, None)
    check = ctx.workload["check"]
    assert all(v <= check[k] for k, v in out["program"].items())
    assert any(v > check[k] for k, v in out["control"].items())
