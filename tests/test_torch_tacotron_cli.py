"""PyTorch port: the ``train_tacotron`` CLI (CPU).

The port's ``train_tacotron`` on ``--device cpu`` against the JAX
package's ``train_tacotron.train`` (the root script, called in-process on
JAX's CPU backend) at a TINY width with ``dropout_prob=0``, both resuming
copies of one run dir: two steps the port took from seeded weights and
saved with its ``CheckpointManager``, so both start with Adam moments.
The corpus is synthetic: two speaker dirs of npz examples whose batches
all fall in one bucket (T_in 16, T_out 50, 10 decoder steps).
"""
import argparse
import dataclasses
import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.train import tacotron_task as JTT
from tacotron_wavenet_vocoder_korean_tpu.train.checkpoints import (
    CheckpointManager as JaxCheckpointManager)
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import train_tacotron as PTT
from tacotron_wavenet_vocoder_korean_tpu_torch.data import TacotronBatcher
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.e2e import TTSPipeline
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.synthesizer import (
    Synthesizer)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
    CheckpointManager, CheckpointReader, prepare_run_dir)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.tacotron_task import (
    TacotronTask, batch_to_device)
from test_torch_tacotron import TINY
from test_torch_tacotron_train import write_corpus
from torch_port_util import plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(TINY, dropout_prob=0.0, batch_size=2,
                          min_iters=2, min_tokens=4)
BOUNDARIES = ("train.sync_every=2,train.summary_interval=2,"
              "train.test_interval=2,train.checkpoint_interval=4")
# CFG as --hparams, for the runs that start without a run's params.json.
TINY_HPARAMS = ",".join(
    f"tacotron.{k}={json.dumps(v)}"
    for k, v in dataclasses.asdict(CFG).items()
    if v != getattr(PC.TacotronConfig(), k)
    and k not in ("num_speakers", "model_type"))
START = 2
END = 6
# Port vs JAX over 4 resumed steps, relative (measured: losses <= 5.0e-7,
# grad_norm 5.7e-7, learning_rate equal, test losses <= 2.4e-7,
# gap_test_train 1.6e-6, best_eval_loss 1.7e-7).
METRIC_TOL = 1e-5


def load_jax_train_tacotron():
    spec = importlib.util.spec_from_file_location(
        "root_train_tacotron", os.path.join(REPO, "train_tacotron.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_corpus"))
    return [write_corpus(root, name, 6, seed, frames=(16, 45),
                         tokens=(8, 16))
            for seed, name in enumerate(("spk_a", "spk_b"))]


def make_base_run(corpus, run, t_cfg):
    """A run dir at step 2 of ``t_cfg``: two port steps from seeded
    weights."""
    cfg = PC.Config(tacotron=t_cfg, train=PC.TrainConfig(
        num_test_per_speaker=1, best_eval_batches=1))
    prepare_run_dir(run, cfg)
    task = TacotronTask(cfg, is_randomly_initialized=True, device="cpu")
    state = task.init_state(0)
    batches = iter(TacotronBatcher(corpus, cfg, seed=99))
    for _ in range(START):
        state, _ = task.train_step(state, batch_to_device(next(batches),
                                                          "cpu"))
    CheckpointManager(run).save(START, task.to_jax_tree(state))
    return run


@pytest.fixture(scope="module")
def base_run(corpus, tmp_path_factory):
    """A TINY run dir at step 2."""
    return make_base_run(corpus, str(tmp_path_factory.mktemp("base") / "run"),
                         CFG)


def copy_run(base_run, dest):
    shutil.copytree(base_run, dest)
    return str(dest)


def port_train(corpus, run, *extra):
    PTT.main(["--data_paths", ",".join(corpus), "--log_dir", run,
              "--hparams", BOUNDARIES, "--device", "cpu", *extra])


def jax_args(corpus, run, **kw):
    args = dict(data_paths=corpus, log_dir=run, load_path=run,
                initialize_path=None, batch_size=None, num_steps=END,
                model_type=None, skip_path_filter=False, hparams=BOUNDARIES,
                use_mesh=False, slack_url=None, max_host_rss_gb=None)
    args.update(kw)
    return argparse.Namespace(**args)


def metrics(run):
    with open(os.path.join(run, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def log_text(run):
    with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(corpus, base_run, tmp_path_factory):
    """Both CLIs resumed from step 2 to step 6 (every boundary at 2, a
    checkpoint at 4 and at the end)."""
    root = tmp_path_factory.mktemp("runs")
    jrun = copy_run(base_run, root / "jax")
    prun = copy_run(base_run, root / "port")
    port_train(corpus, prun, "--load_path", prun, "--num_steps", str(END))
    load_jax_train_tacotron().train(jax_args(corpus, jrun))
    return jrun, prun


def test_cli_metrics_match_jax(runs):
    """The same metrics.jsonl lines (steps and keys, ``time`` aside), every
    value within 1e-5 relative; the first loss equal in the log."""
    jrun, prun = runs
    got, want = metrics(prun), metrics(jrun)
    assert [(m["step"], sorted(m)) for m in got] == [
        (m["step"], sorted(m)) for m in want]
    assert {m["step"] for m in got} == {4, 6}
    for g, w in zip(got, want):
        for k in w:
            if k not in ("step", "time"):
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_TOL,
                                           atol=1e-7, err_msg=k)
    for run in (jrun, prun):
        assert "Resuming from step 2" in log_text(run)
    first = [float(log_text(r).split("first loss fetched: ")[1].split()[0])
             for r in (prun, jrun)]
    np.testing.assert_allclose(first[0], first[1], rtol=METRIC_TOL)


def test_cli_files_and_best_retention(runs):
    """Checkpoints at 4 and 6, the wav and PNG of each test interval, and
    best/ with best.json at the step of the lowest held-out loss, as JAX
    chose it; the port's best checkpoint serves through its Synthesizer."""
    jrun, prun = runs
    assert CheckpointReader(prun).latest_step() == END
    for step in (4, 6):
        for suffix in ("audio.wav", "align.png"):
            assert os.path.exists(os.path.join(prun, f"step-{step}-{suffix}"))
    with open(os.path.join(prun, "best", "best.json")) as f:
        best = json.load(f)
    with open(os.path.join(jrun, "best", "best.json")) as f:
        jbest = json.load(f)
    assert best["step"] == jbest["step"]
    np.testing.assert_allclose(best["eval_loss"], jbest["eval_loss"],
                               rtol=METRIC_TOL)
    synth = Synthesizer.from_checkpoint(os.path.join(prun, "best"),
                                        device="cpu")
    out = synth.synthesize(["존경하는 국민 여러분"], speaker_ids=[1],
                           max_iters=3, attention_trim=False)
    assert np.isfinite(out[0]["mel"]).all()


def test_cli_checkpoints_cross_restore(corpus, runs):
    """Each package's step-6 checkpoint restored by the other (JAX into
    its task's abstract_state, the port through restore_into_state): the
    params within 1e-4 of each leaf's largest of the other's own run (4
    steps of two implementations; observed ~1e-6).  The last projection's
    conv bias feeds a training-mode batch norm directly, so its gradient
    is 0 but for rounding and Adam moves it by noise: held to 1e-6
    absolute (observed 3.2e-7)."""
    from tacotron_wavenet_vocoder_korean_tpu.data.loader import (
        TacotronBatcher as JaxBatcher)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        restore_into_state)
    jrun, prun = runs
    cfg = JC.load_config(prun)
    example = JTT.batch_to_dict(next(iter(JaxBatcher(corpus, cfg, "test"))))
    abstract = JTT.TacotronTask(cfg).abstract_state(jax.random.PRNGKey(0),
                                                    example)
    template = jax.tree.map(lambda x: np.empty(x.shape, x.dtype), abstract)
    mgrs = [JaxCheckpointManager(r) for r in (prun, jrun)]
    from_port, own = (plain(m.restore(template)) for m in mgrs)
    for m in mgrs:
        m.close()
    task = TacotronTask(PC.load_config(prun), is_randomly_initialized=True,
                        device="cpu")
    from_jax, start = restore_into_state(task.init_state(0), jrun, None,
                                         task.from_jax_tree)
    port_own, _ = restore_into_state(task.init_state(0), prun, None,
                                     task.from_jax_tree)
    assert start == int(from_port["step"]) == END
    pairs = [(from_port["params"], own["params"]),
             (task.to_jax_tree(from_jax)["params"],
              task.to_jax_tree(port_own)["params"])]
    for got, want in pairs:
        flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert set(flat_g) == set(flat_w)
        for k, w in flat_w.items():
            err = float(np.abs(flat_g[k] - w).max())
            if "proj_2" in str(k) and "'conv'" in str(k) and "bias" in str(k):
                assert err <= 1e-6, k
            else:
                assert err <= 1e-4 * float(np.abs(w).max()), k


def test_cli_resumes_its_own_run(corpus, runs, tmp_path):
    """A second call on the port's run dir continues from step 6 to 8, and
    the best tracker is read back."""
    _, prun = runs
    run = copy_run(prun, tmp_path / "again")
    port_train(corpus, run, "--load_path", run, "--num_steps", "8")
    text = log_text(run)
    assert "Resuming from step 6" in text
    assert "best-checkpoint tracker resumed" in text
    assert CheckpointReader(run).latest_step() == 8


def test_cli_stop_file_saves_and_exits(corpus, base_run, tmp_path,
                                       monkeypatch):
    """``STOP`` in the run dir (written once the loop runs) saves the step
    of the next boundary and ends the run cleanly."""
    run = copy_run(base_run, tmp_path / "stop")
    real = TacotronTask.train_step

    def step_then_stop(self, *a, **kw):
        open(os.path.join(run, "STOP"), "w").close()
        return real(self, *a, **kw)
    monkeypatch.setattr(TacotronTask, "train_step", step_then_stop)
    port_train(*[corpus], run, "--load_path", run, "--num_steps", "20")
    assert "STOP file found; saving checkpoint at step 4" in log_text(run)
    assert CheckpointReader(run).latest_step() == 4


def test_cli_loss_explosion_raises(corpus, base_run, tmp_path):
    run = copy_run(base_run, tmp_path / "boom")
    with pytest.raises(RuntimeError, match="loss exploded at step 4"):
        port_train(corpus, run, "--load_path", run, "--num_steps", "8",
                   "--hparams",
                   BOUNDARIES + ",train.loss_explosion_threshold=1e-3")


def test_cli_initialize_path_restarts_the_step(corpus, base_run, tmp_path):
    """``--initialize_path``: step 0, Adam's counts kept (the learning
    rate goes on from them, on the 40,000-step warmup), the weights
    restored."""
    run = str(tmp_path / "init")
    port_train(corpus, run, "--initialize_path", base_run, "--num_steps",
               "2", "--hparams", f"{BOUNDARIES},{TINY_HPARAMS},"
               "train.num_test_per_speaker=1,train.best_eval_batches=1")
    assert "Resuming from step" not in log_text(run)
    with CheckpointReader(run) as reader:
        tree = reader.restore(items=None)
    assert int(tree["step"]) == 2
    assert int(tree["opt_state"][1][0]["count"]) == START + 2
    cfg = PC.load_config(run)
    from tacotron_wavenet_vocoder_korean_tpu_torch.models.tacotron import (
        learning_rate_schedule)
    lr = learning_rate_schedule(cfg.tacotron, False)(
        torch.tensor(1, dtype=torch.int32))
    m = metrics(run)[0]
    np.testing.assert_allclose(m["learning_rate"], float(lr), rtol=1e-6)


@pytest.mark.parametrize("argv,error", [
    (["--load_path", "a", "--initialize_path", "b"], SystemExit),
], ids=["exclusive-paths"])
def test_cli_refuses(corpus, tmp_path, argv, error):
    with pytest.raises(error):
        PTT.main(["--data_paths", ",".join(corpus), "--log_dir",
                  str(tmp_path / "r"), "--device", "cpu", *argv])


def test_cli_model_type_simple_matches_jax(corpus, tmp_path):
    """``--model_type simple`` on both CLIs, resuming copies of one TINY
    simple-speaker run dir from step 2 to 4: the same metrics.jsonl
    within 1e-5 relative (as test_cli_metrics_match_jax; observed <=
    1.1e-6), the run served by TTSPipeline with both speaker ids, and
    the port's step-4 checkpoint restored by the JAX task's
    abstract_state, its params within 1e-4 of each leaf's largest of
    JAX's own run (observed <= 2.7e-6); the biases, which start at 0, hold
    Adam's first four updates alone, which carry the gradient's rounding
    at ~1e-4 relative: 1e-3 of their largest (observed 3.9e-4); the conv
    biases that feed a training-mode batch norm directly move by rounding
    noise alone: 1e-6 absolute."""
    from tacotron_wavenet_vocoder_korean_tpu.data.loader import (
        TacotronBatcher as JaxBatcher)
    base = make_base_run(corpus, str(tmp_path / "base"),
                         dataclasses.replace(CFG, model_type="simple"))
    jrun = copy_run(base, tmp_path / "jax")
    prun = copy_run(base, tmp_path / "port")
    port_train(corpus, prun, "--load_path", prun, "--num_steps", "4",
               "--model_type", "simple")
    load_jax_train_tacotron().train(jax_args(corpus, jrun, num_steps=4,
                                             model_type="simple"))
    got, want = metrics(prun), metrics(jrun)
    assert [(m["step"], sorted(m)) for m in got] == [
        (m["step"], sorted(m)) for m in want]
    assert {m["step"] for m in got} == {4}
    for g, w in zip(got, want):
        for k in w:
            if k not in ("step", "time"):
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_TOL,
                                           atol=1e-7, err_msg=k)
    served = TTSPipeline.from_checkpoint(prun, device="cpu").tts(
        ["존경하는 국민 여러분", "존경하는 국민 여러분"], speaker_ids=[0, 1])
    assert all(np.isfinite(r["mel"]).all() and r["wav"].size
               for r in served)
    cfg = JC.load_config(prun)
    assert cfg.tacotron.model_type == "simple"
    example = JTT.batch_to_dict(next(iter(JaxBatcher(corpus, cfg, "test"))))
    abstract = JTT.TacotronTask(cfg).abstract_state(jax.random.PRNGKey(0),
                                                    example)
    template = jax.tree.map(lambda x: np.empty(x.shape, x.dtype), abstract)
    mgrs = [JaxCheckpointManager(r) for r in (prun, jrun)]
    from_port, own = (plain(m.restore(template))["params"] for m in mgrs)
    for m in mgrs:
        m.close()
    flat_g = dict(jax.tree_util.tree_flatten_with_path(from_port)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(own)[0])
    assert set(flat_g) == set(flat_w)
    assert "speaker_embedding" in from_port
    assert not any(k.startswith("sp_") for k in from_port)
    for k, w in flat_w.items():
        err = float(np.abs(flat_g[k] - w).max())
        bias = k[-1].key == "bias"
        if bias and "proj_2" in str(k) and "'conv'" in str(k):
            assert err <= 1e-6, k
        else:
            assert err <= (1e-3 if bias else 1e-4) * float(
                np.abs(w).max()), k


def test_cli_single_speaker_seeded_run(corpus, tmp_path):
    """``--model_type single`` on one dir from seeded weights: two steps,
    finite losses, a checkpoint JAX's single-speaker task restores."""
    run = str(tmp_path / "single")
    port_train(corpus[:1], run, "--model_type", "single", "--num_steps", "2",
               "--hparams", f"{BOUNDARIES},{TINY_HPARAMS},"
               "tacotron.dropout_prob=0.5,train.num_test_per_speaker=1")
    assert all(np.isfinite(m.get("loss", 0.0)) for m in metrics(run))
    cfg = JC.load_config(run)
    assert cfg.tacotron.num_speakers == 1
    with CheckpointReader(run) as reader:
        tree = reader.restore(items=("params",))
    assert "speaker_embedding" not in tree["params"]


def test_cli_refuses_to_run_on_cpu_silently(corpus, tmp_path, monkeypatch):
    """With no GPU, the command, the task and the batcher's store raise
    unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        PTT.main(["--data_paths", ",".join(corpus), "--log_dir",
                  str(tmp_path / "r")])
    cfg = PC.Config(tacotron=CFG)
    with pytest.raises(RuntimeError, match="no CUDA"):
        TacotronTask(cfg)
    with pytest.raises(RuntimeError, match="no CUDA"):
        TacotronBatcher(corpus, cfg, device_store=True)
