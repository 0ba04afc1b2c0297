"""PyTorch port: ``train_vocoder --use_mesh`` and ``train_tacotron
--use_mesh`` on two gloo ranks on the CPU, against the same command in one
process.

Each command resumes a copy of a TINY run dir at step 2 (the base runs of
tests/test_torch_train_cli.py and tests/test_torch_tacotron_cli.py, built
the same way) with every boundary at 2 steps.  The two-rank run has rank 0
write ``STOP`` during its fifth step, so it saves and ends at step 8, and
so does the one-process run (the same file written by the same step).
Both ranks are spawned with
``torch_mesh_workers.Ranks`` (each call with its own join timeout).
"""
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.data.loader import (
    TacotronBatcher as JaxTacotronBatcher)
from tacotron_wavenet_vocoder_korean_tpu.train import tacotron_task as JTT
from tacotron_wavenet_vocoder_korean_tpu.train import wavenet_task as JWT
from tacotron_wavenet_vocoder_korean_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpointManager)
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import preprocess as PP
from tacotron_wavenet_vocoder_korean_tpu_torch import train_tacotron as PTT
from tacotron_wavenet_vocoder_korean_tpu_torch import train_vocoder as PTV
from tacotron_wavenet_vocoder_korean_tpu_torch.data import WaveNetBatcher
from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
    CheckpointManager, CheckpointReader, prepare_run_dir, restore_into_state)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.tacotron_task import (
    TacotronTask)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
    WaveNetTask, batch_to_device)
from test_torch_tacotron_cli import (
    BOUNDARIES as TACO_BOUNDARIES, CFG as TACO_CFG, make_base_run)
from test_torch_tacotron_train import write_corpus
from test_torch_train_cli import BOUNDARIES, TINY, WAVS
from torch_mesh_workers import Ranks, train_cli
from torch_port_util import plain

END = 8
# Two ranks against one process, relative: the same arithmetic but the
# order of the gradient's sums.
METRIC_TOL = 1e-5
# The params at step 8, of each leaf's largest |value|: the bounds of the
# port-vs-JAX CLI tests.  Adam's normalised updates carry the gradients'
# rounding into leaves that start at 0 (the biases).
WN_PARAM_TOL = 1e-3
TACO_PARAM_TOL = 1e-4


def copy_run(src, dest):
    shutil.copytree(src, dest)
    return str(dest)


def metrics(run):
    with open(os.path.join(run, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def log_text(run):
    with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
        return f.read()


def log_lines(run):
    """train.log's messages, the run dir's path and the numbers masked, the
    store's per-rank note dropped."""
    text = log_text(run).replace(run, "RUN").replace(" (whole on each rank)",
                                                     "")
    return [re.sub(r"\d[\d.,]*", "#", ln.split("]  ", 1)[1])
            for ln in text.splitlines() if "]  " in ln]


def same_metrics(got_run, want_run):
    """The same lines and keys; each value within METRIC_TOL relative, the
    train-test gap (a difference of two losses) within METRIC_TOL of the
    test loss."""
    got, want = metrics(got_run), metrics(want_run)
    assert [sorted(g) for g in got] == [sorted(w) for w in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k == "time":
                continue
            tol = (dict(abs=METRIC_TOL * abs(w["test_loss"]))
                   if k == "gap_test_train" else dict(rel=METRIC_TOL))
            assert g[k] == pytest.approx(v, **tol), (k, g, w)


def stop_in_fifth_step(monkeypatch, cls, run):
    """The one-process run's STOP: written during its fifth step, as
    ``torch_mesh_workers.train_cli`` writes it on rank 0."""
    real, calls = cls.train_step, []

    def step(self, *a, **kw):
        calls.append(1)
        if len(calls) == 5:
            open(os.path.join(run, "STOP"), "w").close()
        return real(self, *a, **kw)
    monkeypatch.setattr(cls, "train_step", step)


def check_mesh_run(run, one):
    """The two-rank run's files against the one-process run's: one
    writer (the same log lines but the mesh's, the same metrics lines),
    the STOP at step 8 on both ranks, the same checkpoints."""
    same_metrics(run, one)
    mesh_lines = log_lines(run)
    assert "STOP file found; saving checkpoint at step 8" in log_text(run)
    assert sum(ln.startswith("mesh (") for ln in mesh_lines) == 1
    assert [ln for ln in mesh_lines if not ln.startswith("mesh (")
            ] == log_lines(one)
    assert CheckpointReader(run).latest_step() == END


# ---------------------------------------------------------------------------
# train_vocoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wn_corpus(tmp_path_factory):
    """The committed wn_moon_260k clips preprocessed by the port."""
    root = tmp_path_factory.mktemp("mesh_cli_corpus")
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
def wn_base(wn_corpus, tmp_path_factory):
    """A TINY run dir at step 2: two port steps from seeded weights."""
    cfg = PC.overlay(PC.Config(), wavenet=TINY)
    run = str(tmp_path_factory.mktemp("wn_base") / "run")
    prepare_run_dir(run, cfg)
    task = WaveNetTask(cfg, device="cpu")
    state = task.init_state(0)
    batches = iter(WaveNetBatcher([wn_corpus], cfg, seed=99))
    for _ in range(2):
        state, _ = task.train_step(state, batch_to_device(next(batches),
                                                          "cpu"))
    CheckpointManager(run).save(2, state)
    return run


def test_train_vocoder_use_mesh_two_ranks(wn_corpus, wn_base, tmp_path,
                                         monkeypatch):
    """Two ranks (B = 2: one row each) against one process, both from step
    2 to 8: metrics.jsonl within 1e-5 relative, written once (as
    train.log); STOP, read by rank 0, ends both ranks at step 8; the
    checkpoint holds the one-process run's params within 1e-3 of each
    leaf's largest, is restored by the JAX package's CheckpointManager,
    and the port's one-process command resumes it."""
    one = copy_run(wn_base, tmp_path / "one")
    run = copy_run(wn_base, tmp_path / "mesh")
    argv = lambda r, n: ["--data_dir", wn_corpus, "--log_dir", r,
                         "--load_path", r, "--hparams", BOUNDARIES,
                         "--device", "cpu", "--num_steps", str(n)]
    mesh = Ranks(train_cli, 2, "train_vocoder", [*argv(run, 12),
                                                 "--use_mesh"], 5,
                 os.path.join(run, "STOP"))
    stop_in_fifth_step(monkeypatch, WaveNetTask, one)
    PTV.main(argv(one, 12))
    monkeypatch.undo()
    mesh.results()
    check_mesh_run(run, one)

    pcfg = PC.overlay(PC.Config(), wavenet=TINY)
    template = WaveNetTask(pcfg, device="cpu").init_state(0)
    got = CheckpointManager(run).restore(template)
    want = CheckpointManager(one).restore(template)
    for part in ("params", "ema_params"):
        for k, v in getattr(want, part).items():
            err = float((getattr(got, part)[k] - v).abs().max())
            assert err <= WN_PARAM_TOL * float(v.abs().max()), (part, k,
                                                                err)
    jcfg = JC.overlay(JC.Config(), wavenet=TINY)
    example = {"input_wav": np.zeros((1, 1500, 1), np.float32),
               "local_condition": np.zeros((1, 5, 80), np.float32),
               "speaker_id": np.zeros(1, np.int32)}
    jtemplate = jax.tree.map(np.zeros_like, JWT.WaveNetTask(jcfg).init_state(
        jax.random.PRNGKey(0), example))
    restored = JaxCheckpointManager(run).restore(jtemplate)
    assert int(restored.step) == END
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v for path, v
            in jax.tree_util.tree_flatten_with_path(plain(restored.params))[0]}
    assert set(flat) == set(got.params)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, got.params[k].numpy())

    PTV.main(argv(run, END + 2))
    assert "Resuming from step 8" in log_text(run)
    assert CheckpointReader(run).latest_step() == END + 2


# ---------------------------------------------------------------------------
# train_tacotron
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def taco(tmp_path_factory):
    """Two speaker dirs of synthetic examples and a TINY run dir at step
    2 (tests/test_torch_tacotron_cli.py's)."""
    root = str(tmp_path_factory.mktemp("mesh_taco"))
    corpus = [write_corpus(root, name, 6, seed, frames=(16, 45),
                           tokens=(8, 16))
              for seed, name in enumerate(("spk_a", "spk_b"))]
    return corpus, make_base_run(corpus, os.path.join(root, "base"),
                                 TACO_CFG)


def test_train_tacotron_use_mesh_two_ranks(taco, tmp_path, monkeypatch):
    """Two ranks (B = 2: one row each, batch norm over both) against one
    process, from step 2 to 8 with the free-running eval, its wav and PNG
    and best-heldout retention every 2 steps: metrics.jsonl within 1e-5
    relative, written once (as train.log, the wavs and PNGs, best/);
    STOP ends both ranks at step 8; the checkpoint holds the one-process
    run's params within 1e-4 of each leaf's largest (the conv bias that
    feeds a batch norm, 1e-6 absolute), is restored by the JAX package's
    task, and the port's one-process command resumes it."""
    corpus, base = taco
    one = copy_run(base, tmp_path / "one")
    run = copy_run(base, tmp_path / "mesh")
    argv = lambda r, n: ["--data_paths", ",".join(corpus), "--log_dir", r,
                         "--load_path", r, "--hparams", TACO_BOUNDARIES,
                         "--device", "cpu", "--num_steps", str(n)]
    mesh = Ranks(train_cli, 2, "train_tacotron", [*argv(run, 12),
                                                  "--use_mesh"], 5,
                 os.path.join(run, "STOP"))
    stop_in_fifth_step(monkeypatch, TacotronTask, one)
    PTT.main(argv(one, 12))
    monkeypatch.undo()
    mesh.results()
    check_mesh_run(run, one)
    assert sorted(f for f in os.listdir(run) if f.startswith("step-")) == \
        sorted(f for f in os.listdir(one) if f.startswith("step-"))
    with open(os.path.join(run, "best", "best.json"), encoding="utf-8") as f:
        best = json.load(f)
    with open(os.path.join(one, "best", "best.json"), encoding="utf-8") as f:
        assert best["step"] == json.load(f)["step"]

    task = TacotronTask(PC.load_config(run), is_randomly_initialized=True,
                        device="cpu")
    got, start = restore_into_state(task.init_state(0), run, None,
                                    task.from_jax_tree)
    want, _ = restore_into_state(task.init_state(0), one, None,
                                 task.from_jax_tree)
    assert start == END
    for k, v in want.params.items():
        err = float((got.params[k] - v).abs().max())
        if k.endswith("proj_2.conv.bias"):   # a zero gradient but rounding
            assert err <= 1e-6, k
        else:
            assert err <= TACO_PARAM_TOL * float(v.abs().max()), (k, err)
    cfg = JC.load_config(run)
    example = JTT.batch_to_dict(next(iter(JaxTacotronBatcher(corpus, cfg,
                                                             "test"))))
    abstract = JTT.TacotronTask(cfg).abstract_state(jax.random.PRNGKey(0),
                                                    example)
    template = jax.tree.map(lambda x: np.empty(x.shape, x.dtype), abstract)
    mgr = JaxCheckpointManager(run)
    restored = plain(mgr.restore(template))
    mgr.close()
    assert int(restored["step"]) == END
    ours = task.to_jax_tree(got)["params"]
    for (path, v), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(restored["params"])[0],
            jax.tree_util.tree_flatten_with_path(ours)[0]):
        np.testing.assert_array_equal(v, w, err_msg=str(path))

    PTT.main(argv(run, END + 2))
    assert "Resuming from step 8" in log_text(run)
    assert CheckpointReader(run).latest_step() == END + 2
