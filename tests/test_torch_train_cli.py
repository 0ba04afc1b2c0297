"""PyTorch port: the ``train_vocoder`` and ``preprocess`` CLIs, the hang
watchdog and the step tracer (CPU).

The port's ``train_vocoder`` on ``--device cpu`` against the JAX package's
``train_vocoder.train`` (the root script, called in-process on JAX's CPU
backend) at a TINY width, both resuming copies of one run dir: two steps
the port took from seeded weights and saved with its
``CheckpointManager``, so both start with Adam moments (from fresh moments
Adam's first step turns rounding noise into full updates).  The corpus is
the committed ``samples/wn_moon_260k`` clips, preprocessed by the port.
"""
import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.train import wavenet_task as JT
from tacotron_wavenet_vocoder_korean_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpointManager)
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import preprocess as PP
from tacotron_wavenet_vocoder_korean_tpu_torch import train_vocoder as PTV
from tacotron_wavenet_vocoder_korean_tpu_torch.data import WaveNetBatcher
from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
    CheckpointManager, prepare_run_dir)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
    WaveNetTask, batch_to_device)
from tacotron_wavenet_vocoder_korean_tpu_torch.utils import infolog
from tacotron_wavenet_vocoder_korean_tpu_torch.utils.profiling import (
    maybe_trace_step)
from torch_port_util import plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVS = os.path.join(REPO, "samples", "wn_moon_260k")
TINY = {"dilations": [1, 2, 4, 1, 2, 4], "residual_channels": 8,
        "dilation_channels": 8, "skip_channels": 16, "out_channels": 12,
        "initial_filter_width": 8, "sample_size": 1500, "batch_size": 2}
BOUNDARIES = "train.sync_every=2,train.summary_interval=2,train.test_interval=2"
START = 2
# Port vs JAX over 6 resumed steps, relative (measured: loss 4.9e-7,
# test_loss 8.1e-8, grad_norm 5.6e-6, learning_rate equal; the final
# params 1.2e-4 of a leaf's largest, on the gate biases).
FIRST_LOSS_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_NORM_TOL = 1e-4
PARAM_TOL = 1e-3     # final params, relative to each leaf's largest


def load_jax_train_vocoder():
    spec = importlib.util.spec_from_file_location(
        "root_train_vocoder", os.path.join(REPO, "train_vocoder.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_corpus")
    (root / "in" / "audio").mkdir(parents=True)
    table = {}
    for f in sorted(os.listdir(WAVS)):
        shutil.copy(os.path.join(WAVS, f), root / "in" / "audio" / f)
        table[f"audio/{f}"] = "존경하는 국민 여러분, 안녕하십니까."
    with open(root / "in" / "moon-recognition-All.json", "w",
              encoding="utf-8") as f:
        json.dump(table, f, ensure_ascii=False)
    PP.main(["--name", "moon", "--in_dir", str(root / "in"), "--out_dir",
             str(root / "data"), "--num_workers", "2", "--device", "cpu"])
    return str(root / "data")


@pytest.fixture(scope="module")
def base_run(corpus, tmp_path_factory):
    """A TINY run dir at step 2: two port steps from seeded weights."""
    cfg = PC.overlay(PC.Config(), wavenet=TINY)
    run = str(tmp_path_factory.mktemp("base") / "run")
    prepare_run_dir(run, cfg)
    task = WaveNetTask(cfg, device="cpu")
    state = task.init_state(0)
    batches = iter(WaveNetBatcher([corpus], cfg, seed=99))
    for _ in range(START):
        state, _ = task.train_step(state, batch_to_device(next(batches),
                                                          "cpu"))
    CheckpointManager(run).save(START, state)
    return run


def copy_run(base_run, dest):
    shutil.copytree(base_run, dest)
    return str(dest)


def port_train(corpus, run, *extra):
    PTV.main(["--data_dir", corpus, "--log_dir", run, "--load_path", run,
              "--hparams", BOUNDARIES, "--device", "cpu", *extra])


def metrics(run):
    with open(os.path.join(run, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def first_loss(run):
    with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
        lines = [ln for ln in f if "first loss fetched:" in ln]
    assert len(lines) == 1
    return float(lines[0].rsplit(":", 1)[1])


@pytest.mark.parametrize("store", [True, False], ids=["store", "host"])
def test_cli_trajectory_matches_jax(corpus, base_run, tmp_path, store):
    """6 resumed steps with every boundary at 2, the batches from the
    device store or through the prefetcher from the host (as
    train.device_resident_data says): the same metrics.jsonl
    lines (steps and keys), the first loss within 1e-5 relative, the
    later losses and test losses within LOSS_TOL, grad_norm within
    GRAD_NORM_TOL, the learning rate equal; the same log lines but times;
    the final step-8 checkpoint of each restored by the other package,
    params within PARAM_TOL of each leaf's largest."""
    jrun = copy_run(base_run, tmp_path / "jax")
    prun = copy_run(base_run, tmp_path / "port")
    hparams = f"{BOUNDARIES},train.device_resident_data={str(store).lower()}"
    PTV.main(["--data_dir", corpus, "--log_dir", prun, "--load_path", prun,
              "--hparams", hparams, "--device", "cpu", "--num_steps", "8"])
    load_jax_train_vocoder().train(argparse.Namespace(
        data_dir=[corpus], log_dir=jrun, load_path=jrun,
        initialize_path=None, batch_size=None, num_steps=8, sample_size=None,
        use_mesh=False, hparams=hparams, slack_url=None,
        max_host_rss_gb=None))
    assert PC.load_config(prun).train.device_resident_data is store

    assert abs(first_loss(prun) / first_loss(jrun) - 1) <= FIRST_LOSS_TOL
    got, want = metrics(prun), metrics(jrun)
    assert [(m["step"], sorted(m)) for m in got] == [
        (m["step"], sorted(m)) for m in want]
    assert [m["step"] for m in got] == [4, 4, 6, 6, 8, 8]
    for g, w in zip(got, want):
        for k, tol in (("loss", LOSS_TOL), ("test_loss", LOSS_TOL),
                       ("grad_norm", GRAD_NORM_TOL)):
            if k in w:
                assert abs(g[k] / w[k] - 1) <= tol, (g, w)
        if "learning_rate" in w:
            assert g["learning_rate"] == pytest.approx(w["learning_rate"],
                                                       rel=1e-7)

    def log_lines(run):     # the messages, numbers masked
        with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
            return [re.sub(r"\d[\d.,]*", "#", ln.split("]  ", 1)[1])
                    for ln in f if "]  " in ln]
    assert log_lines(prun) == log_lines(jrun)

    for run in (prun, jrun):
        assert sorted(os.listdir(os.path.join(run, "ckpt")))[-1] == "8"
    pcfg = PC.overlay(PC.Config(), wavenet=TINY)
    template = WaveNetTask(pcfg, device="cpu").init_state(0)
    from_jax = CheckpointManager(jrun).restore(template)
    from_port = CheckpointManager(prun).restore(template)
    jcfg = JC.overlay(JC.Config(), wavenet=TINY)
    example = {"input_wav": np.zeros((1, 1500, 1), np.float32),
               "local_condition": np.zeros((1, 5, 80), np.float32),
               "speaker_id": np.zeros(1, np.int32)}
    jtemplate = jax.tree.map(np.zeros_like, JT.WaveNetTask(jcfg).init_state(
        jax.random.PRNGKey(0), example))
    jax_reads_port = JaxCheckpointManager(prun).restore(jtemplate)
    assert int(from_jax.step) == int(from_port.step) == 8
    assert int(jax_reads_port.step) == 8
    for k, v in from_port.params.items():
        scale = float(v.abs().max())
        assert float((from_jax.params[k] - v).abs().max()) <= PARAM_TOL * scale
    flat = dict(plain(jax_reads_port.params))

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v
    jleaves = dict(leaves(flat))
    assert set(jleaves) == set(from_port.params)
    for k, v in jleaves.items():
        np.testing.assert_array_equal(v, from_port.params[k].numpy())


def test_stop_file_mid_run_saves_and_exits_cleanly(corpus, base_run,
                                                   tmp_path, monkeypatch):
    """``touch LOG_DIR/STOP`` after the third step: the run saves at the
    next boundary (step 6) and returns; the feeder's thread is gone."""
    run = copy_run(base_run, tmp_path / "run")
    real = PTV.WaveNetTask.train_step
    calls = []

    def step(self, state, batch):
        calls.append(1)
        if len(calls) == 3:
            open(os.path.join(run, "STOP"), "w").close()
        return real(self, state, batch)
    monkeypatch.setattr(PTV.WaveNetTask, "train_step", step)
    port_train(corpus, run, "--num_steps", "100")
    assert len(calls) == 4
    assert CheckpointManager(run).all_steps() == [2, 6]
    with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
        assert "STOP file found; saving checkpoint at step 6" in f.read()
    assert not any(t.name == "device-prefetcher" and t.is_alive()
                   for t in threading.enumerate())


def test_stale_stop_is_removed_at_start(corpus, base_run, tmp_path):
    run = copy_run(base_run, tmp_path / "run")
    open(os.path.join(run, "STOP"), "w").close()
    port_train(corpus, run, "--num_steps", "4")
    assert not os.path.exists(os.path.join(run, "STOP"))
    assert CheckpointManager(run).all_steps() == [2, 4]


def test_nan_loss_raises(corpus, base_run, tmp_path, monkeypatch):
    run = copy_run(base_run, tmp_path / "run")
    real = PTV.WaveNetTask.train_step

    def step(self, state, batch):
        state, m = real(self, state, batch)
        return state, dict(m, loss=torch.tensor(float("nan")))
    monkeypatch.setattr(PTV.WaveNetTask, "train_step", step)
    with pytest.raises(RuntimeError, match="loss is NaN"):
        port_train(corpus, run, "--num_steps", "8")
    assert not any(t.name == "device-prefetcher" and t.is_alive()
                   for t in threading.enumerate())


def test_initialize_path_starts_a_new_run_at_step_0(corpus, base_run,
                                                    tmp_path):
    """--initialize_path: the config is the default one with the CLI's
    overrides (here TINY's through --hparams), the weights and optimizer
    state the run's, the step 0."""
    run = str(tmp_path / "new")
    hp = ",".join(f"wavenet.{k}={json.dumps(v)}" for k, v in TINY.items())
    PTV.main(["--data_dir", corpus, "--log_dir", run, "--initialize_path",
              base_run, "--num_steps", "2", "--hparams",
              f"{hp},{BOUNDARIES}", "--device", "cpu"])
    assert CheckpointManager(run).all_steps() == [2]
    with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
        assert "Resuming from step" not in f.read()


def test_load_and_initialize_paths_are_exclusive(corpus, base_run):
    with pytest.raises(SystemExit) as e:
        PTV.main(["--data_dir", corpus, "--load_path", base_run,
                  "--initialize_path", base_run, "--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("cli", ["train_vocoder", "preprocess"])
def test_clis_refuse_to_run_on_cpu_silently(corpus, base_run, tmp_path,
                                            monkeypatch, cli):
    """With no GPU and no --device cpu both commands raise, before they
    write anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA"):
        if cli == "train_vocoder":
            PTV.main(["--data_dir", corpus, "--log_dir", str(out),
                      "--load_path", base_run])
        else:
            PP.main(["--name", "moon", "--in_dir", str(tmp_path),
                     "--out_dir", str(out)])
    assert not out.exists()


def test_max_host_rss_gb_is_recorded(corpus, base_run, tmp_path):
    run = copy_run(base_run, tmp_path / "run")
    port_train(corpus, run, "--num_steps", "3", "--max_host_rss_gb", "12.5")
    assert PC.load_config(run).train.max_host_rss_gb == 12.5


# ---------------------------------------------------------------------------
# HangWatchdog, in subprocesses (it ends its process)
# ---------------------------------------------------------------------------

WATCHDOG = """
import sys, time
from tacotron_wavenet_vocoder_korean_tpu_torch.train.watchdog import HangWatchdog
case = sys.argv[1]
if case == "stall":
    HangWatchdog(0.4)
    time.sleep(5)
elif case == "beat":
    w = HangWatchdog(0.4)
    for _ in range(15):
        time.sleep(0.1)
        w.beat()
elif case == "stop":
    w = HangWatchdog(0.4)
    w.stop()
    time.sleep(1.5)
elif case == "grace":
    w = HangWatchdog(0.4, first_timeout_s=3.0)
    time.sleep(1.2)
    print("grace held", flush=True)
    w.beat()
    time.sleep(5)
print("ended", flush=True)
"""


@pytest.mark.parametrize("case,rc", [("stall", 42), ("beat", 0),
                                     ("stop", 0), ("grace", 42)])
def test_hang_watchdog(case, rc):
    """A stall past timeout_s exits 42 (a stall of 5 s against 0.4);
    beats every 0.1 s keep the process alive; stop() disarms; before the
    first beat the grace (3 s) holds over a 1.2 s wait, and after that
    beat the steady-state timeout applies again."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", WATCHDOG, case], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == rc, proc.stdout + proc.stderr
    assert ("ended" in proc.stdout) == (rc == 0)
    if case == "grace":
        assert "grace held" in proc.stdout
        assert "no train-loop progress" in proc.stdout
        assert time.monotonic() - t0 < 5
    if case == "stall":
        assert "no train-loop progress" in proc.stdout


# ---------------------------------------------------------------------------
# Profiling and logging
# ---------------------------------------------------------------------------

def test_maybe_trace_step_traces_only_its_window(tmp_path):
    """store_metadata on: steps 0-2 and 50-52 write a Chrome trace into
    log_dir/trace/, step 3 and 49 do not; off: nothing."""
    written = {}
    for step, on in ((0, True), (2, True), (3, True), (49, True),
                     (50, True), (0, False)):
        d = tmp_path / f"{step}_{on}"
        with maybe_trace_step(step, str(d), on):
            torch.ones(4).add_(1)
        trace = d / "trace"
        written[(step, on)] = sorted(os.listdir(trace)) if trace.exists() \
            else []
    for key, files in written.items():
        assert len(files) == (1 if key in ((0, True), (2, True), (50, True))
                              else 0), written
    with open(tmp_path / "0_True" / "trace" / written[(0, True)][0]) as f:
        assert "traceEvents" in json.load(f)


def test_infolog_value_window_and_step_timer(tmp_path, capsys):
    path = tmp_path / "train.log"
    infolog.init(str(path))
    infolog.log("hello")
    infolog.close()
    infolog.log("after close")
    text = path.read_text(encoding="utf-8")
    assert "Starting new training run" in text and "]  hello" in text
    assert "after close" not in text
    assert capsys.readouterr().out == "hello\nafter close\n"
    w = infolog.ValueWindow(3)
    for x in (1, 2, 3, 4):
        w.append(x)
    assert (w.count, w.sum, w.average) == (3, 9.0, 3.0)
    w.reset()
    assert w.average == 0.0
