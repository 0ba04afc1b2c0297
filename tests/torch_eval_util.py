"""Shared fixtures of the evaluation commands' parity tests
(tests/test_torch_{vocoder_eval,quality_eval,wavenet_diagnose}.py): a
small corpus of committed clips preprocessed by the port and split into a
moon and a son (``NB*``) speaker dir, TINY WaveNet and Tacotron run dirs
written from seeded weights by the port's checkpoint writer (the JAX
package restores them), the JAX scripts loaded from ``scripts/``, and a
runner that calls a JAX script's ``main()`` under a patched ``sys.argv``
and returns its JSON line."""
import importlib.util
import json
import os
import shutil
import sys
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import preprocess as PP
from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
    CheckpointManager, prepare_run_dir)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.tacotron_task import (
    TacotronTask)
from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
    WaveNetTask)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVS = os.path.join(REPO, "samples", "wn_moon_260k")
TEXT0 = "존경하는 국민 여러분, 안녕하십니까."
# Committed clips of 113 to 240 frames once trimmed: five moon, four son.
MOON_CLIPS = ("003.0000", "003.0013", "006.0015", "006.0041", "006.0115")
SON_CLIPS = ("NB10584578.0012", "NB10584578.0024", "NB10585784.0001",
             "NB10585784.0007")
# The tiny stack of tests/test_torch_train_cli.py at hop 300 (rf = 22).
TINY_WN = {"dilations": [1, 2, 4, 1, 2, 4], "residual_channels": 8,
           "dilation_channels": 8, "skip_channels": 16, "out_channels": 12,
           "initial_filter_width": 8, "sample_size": 1500, "batch_size": 2}
# tests/test_torch_e2e.py's TINY Tacotron, 12 decoder steps (at most 60
# frames: one 100-frame Griffin-Lim bucket), prenet dropout on, as served;
# its run trains without the length filter, as both_r2 did.
TINY_TACO = PC.TacotronConfig(
    enc_bank_size=4, enc_bank_channel_size=32, enc_rnn_size=32,
    enc_prenet_sizes=(64, 32), enc_proj_sizes=(32, 32),
    attention_size=32, attention_state_size=32,
    dec_rnn_size=32, dec_prenet_sizes=(64, 32),
    post_bank_size=2, post_bank_channel_size=32, post_rnn_size=32,
    post_proj_sizes=(64, 80), embedding_size=32, max_iters=12,
    num_speakers=2, model_type="deepvoice", fused_rnn=True,
    dec_prenet_dropout_inference=True)
STEP = 7


def crop_clips(data: str, rows: list, frames: int) -> list:
    """Cut every clip of ``data`` to its first ``frames`` frames (audio,
    mel and linear; the counts in the npz and in ``rows`` with them)."""
    out = []
    for row in rows:
        name, _, _, *rest = row.split("|")
        path = os.path.join(data, name)
        with np.load(path) as d:
            arrays = {k: d[k] for k in d.files}
        hop = len(arrays["audio"]) // len(arrays["mel"])
        arrays.update(audio=arrays["audio"][:frames * hop],
                      mel=arrays["mel"][:frames],
                      linear=arrays["linear"][:frames],
                      time_steps=np.asarray(frames * hop),
                      mel_frames=np.asarray(frames))
        np.savez(path, **arrays)
        out.append("|".join([name, str(frames * hop), str(frames), *rest]))
    return out


def make_corpus(root: str, frames: Optional[int] = None) -> list:
    """MOON_CLIPS and SON_CLIPS preprocessed by the port (moon layout,
    TEXT0 for every clip), each cut to ``frames`` frames when given (one
    length, so the JAX side compiles each shape once), and split into
    ``[moon dir, son dir]``, each with its own ``train.txt``."""
    src = os.path.join(root, "in")
    os.makedirs(os.path.join(src, "audio"))
    table = {}
    for c in MOON_CLIPS + SON_CLIPS:
        shutil.copy(os.path.join(WAVS, f"{c}.wn.wav"),
                    os.path.join(src, "audio", f"{c}.wn.wav"))
        table[f"audio/{c}.wn.wav"] = TEXT0
    with open(os.path.join(src, "moon-recognition-All.json"), "w",
              encoding="utf-8") as f:
        json.dump(table, f, ensure_ascii=False)
    data = os.path.join(root, "data")
    PP.main(["--name", "moon", "--in_dir", src, "--out_dir", data,
             "--num_workers", "2", "--device", "cpu"])
    with open(os.path.join(data, "train.txt"), encoding="utf-8") as f:
        rows = f.read().splitlines()
    if frames is not None:
        rows = crop_clips(data, rows, frames)
    dirs = []
    for name, son in (("moon", False), ("son", True)):
        d = os.path.join(root, name, "data")
        os.makedirs(d)
        sel = [r for r in rows if r.startswith("NB") == son]
        for r in sel:
            shutil.copy(os.path.join(data, r.split("|")[0]), d)
        with open(os.path.join(d, "train.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(sel) + "\n")
        dirs.append(d)
    return dirs


def wavenet_run(run: str) -> str:
    """A TINY WaveNet run dir at step STEP from seeded weights (the EMA
    equal to the params), written by the port's CheckpointManager."""
    cfg = PC.overlay(PC.Config(), wavenet=TINY_WN)
    prepare_run_dir(run, cfg)
    state = WaveNetTask(cfg, device="cpu").init_state(3)
    CheckpointManager(run).save(STEP, state._replace(
        step=torch.tensor(STEP, dtype=torch.int32)))
    return run


def tacotron_run(run: str) -> str:
    """A TINY Tacotron run dir (two speakers) at step STEP from seeded
    weights, written by the port's CheckpointManager."""
    cfg = PC.Config(tacotron=TINY_TACO,
                    train=PC.TrainConfig(skip_path_filter=True))
    prepare_run_dir(run, cfg)
    task = TacotronTask(cfg, is_randomly_initialized=True, device="cpu")
    state = task.init_state(4)
    state = state._replace(step=torch.tensor(STEP, dtype=torch.int32))
    CheckpointManager(run).save(STEP, task.to_jax_tree(state))
    return run


def shape_only_templates(monkeypatch) -> None:
    """JAX's loaders build their restore template with the tasks'
    ``init_state`` (an eager flax init, ~45 s at TINY on a CPU); give them
    zeros of the same tree from ``jax.eval_shape`` instead.  Orbax reads
    only the template's structure, shapes and types."""
    from tacotron_wavenet_vocoder_korean_tpu.train.tacotron_task import (
        TacotronTask as JaxTacotronTask)
    from tacotron_wavenet_vocoder_korean_tpu.train.wavenet_task import (
        WaveNetTask as JaxWaveNetTask)
    for cls in (JaxTacotronTask, JaxWaveNetTask):
        def zeros(self, rng, batch, init=cls.init_state):
            tree = jax.eval_shape(lambda r: init(self, r, batch), rng)
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tree)
        monkeypatch.setattr(cls, "init_state", zeros)


def load_jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(mod, args: list, monkeypatch, capsys) -> dict:
    """The JAX script's ``main()`` with ``args`` as its command line (no
    XLA compile cache written, restore templates by shape), returning its
    JSON line."""
    monkeypatch.setenv("TWVK_NO_COMPILE_CACHE", "1")
    shape_only_templates(monkeypatch)
    monkeypatch.setattr(sys, "argv", [mod.__file__, *args])
    capsys.readouterr()
    mod.main()
    return last_json(capsys)


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def jax_phase(shape, seed, device):
    """JAX's Griffin-Lim initial phase, for the port's ``initial_phase``."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
        maxval=2 * jnp.pi))).to(device)


def fake_vocoder(mel, hop: int = 300) -> np.ndarray:
    """One deterministic function of a mel in place of WaveNet generation
    on both sides: a 200 Hz tone whose level follows each frame's mean."""
    mel = np.asarray(mel, np.float32)
    level = np.repeat((mel.mean(axis=1) + 4.0) / 8.0, hop)
    t = np.arange(len(level)) / 24000.0
    return (0.5 * level * np.sin(2 * np.pi * 200.0 * t)).astype(np.float32)


def same_keys(got: dict, want: dict) -> None:
    assert set(got) == set(want), (sorted(got), sorted(want))


def close_db(got, want, tol: float = 0.01) -> None:
    """Two printed MCDs (rounded to 0.01 dB on both sides) within
    ``tol``, or both None."""
    if want is None:
        assert got is None
        return
    assert abs(got - want) <= tol + 1e-9, (got, want)


def without(d: dict, *keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


