"""PyTorch port: ``scripts/vocoder_eval.py`` (CPU).

The port's command on ``--device cpu`` against the JAX system's
``scripts/vocoder_eval.py`` (loaded with importlib, ``main()`` under a
patched ``sys.argv``) on one TINY WaveNet run dir and a small corpus of
committed clips preprocessed by the port: a moon dir (``--data``) and a son
dir (``--unseen_data``).  WaveNet generation is replaced on both sides by
one function of the mel (the generators are held against JAX in
tests/test_torch_generator.py and tests/test_torch_trained.py), and the
Griffin-Lim oracle's initial phase is JAX's draw on both sides.  Both sides
print MCDs rounded to 0.01 dB, so they are held within 0.01 dB (observed:
equal); path selection and held-out accounting are held equal.
"""
import json
import os
import shutil
import tarfile

import numpy as np
import pytest

from tacotron_wavenet_vocoder_korean_tpu.synth import (
    WaveNetGenerator as JaxGenerator)
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp import griffin_lim as PG
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import load_wav
from tacotron_wavenet_vocoder_korean_tpu_torch.scripts import (
    vocoder_eval as PV)
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
    WaveNetGenerator)
from torch_eval_util import (STEP, close_db, fake_vocoder, jax_phase,
                             last_json, load_jax_script, make_corpus,
                             run_jax, same_keys, wavenet_run, without)

JV = load_jax_script("vocoder_eval")
MCD_KEYS = ("wavenet_mcd_db", "gl_oracle_mcd_db", "heldout_wavenet_mcd_db",
            "heldout_same_speaker_mcd_db", "unseen_speaker_mcd_db",
            "unseen_speaker_gl_oracle_mcd_db")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vocoder_eval"))
    moon, son = make_corpus(root)
    return {"moon": moon, "son": son,
            "run": wavenet_run(os.path.join(root, "wn"))}


@pytest.fixture
def fake_generation(monkeypatch):
    monkeypatch.setattr(PG, "initial_phase", jax_phase)
    for cls in (JaxGenerator, WaveNetGenerator):
        monkeypatch.setattr(cls, "generate",
                            lambda self, mel, *a, **k: fake_vocoder(mel))


def hold_result(got: dict, want: dict) -> None:
    """The port's result against JAX's: the same keys, MCDs within 0.01
    dB, the selection and held-out accounting equal."""
    same_keys(got, want)
    for k in MCD_KEYS:
        close_db(got[k], want[k])
    for k in ("metric", "n_utterances", "n_heldout", "checkpoint_step"):
        assert got[k] == want[k], k
    assert len(got["per_utt"]) == len(want["per_utt"])
    for g, w in zip(got["per_utt"], want["per_utt"]):
        same_keys(g, w)
        assert without(g, "wavenet_mcd_db", "gl_mcd_db") == without(
            w, "wavenet_mcd_db", "gl_mcd_db")
        close_db(g["wavenet_mcd_db"], w["wavenet_mcd_db"])
        close_db(g["gl_mcd_db"], w["gl_mcd_db"])


def read_persisted(run: str) -> tuple:
    with open(os.path.join(run, "eval.json")) as f:
        saved = json.load(f)
    with open(os.path.join(run, "eval_history.jsonl")) as f:
        history = [json.loads(line) for line in f]
    return saved, history


@pytest.mark.parametrize("n_paths,n,n_test", [
    (0, 3, 1), (1, 3, 1), (3, 3, 2), (4, 3, 2), (5, 1, 2), (5, 2, 2),
    (9, 3, 2), (10, 10, 2), (18, 5, 2), (18, 30, 4), (7, 0, 2), (6, 4, 3)])
def test_select_eval_paths_matches_jax(n_paths, n, n_test):
    paths = [f"d/{i:04d}.npz" for i in range(n_paths)]
    got = PV.select_eval_paths(paths, n, n_test)
    assert got == JV.select_eval_paths(paths, n, n_test)


def test_vocoder_eval_matches_jax(setup, fake_generation, tmp_path,
                                  monkeypatch, capsys):
    """--n 3 over the moon dir (its 2 held-out clips and one more) and
    --unseen_data son with --n_unseen 2, 40 frames each; each side
    persists into its own copy of the run dir and writes its wavs."""
    runs = {k: shutil.copytree(setup["run"], str(tmp_path / k))
            for k in ("jax", "port")}
    args = ["--data", setup["moon"], "--unseen_data", setup["son"],
            "--n", "3", "--n_unseen", "2", "--max_frames", "40"]
    want = run_jax(JV, ["--wavenet", runs["jax"], *args, "--out_dir",
                        str(tmp_path / "jax_wavs")], monkeypatch, capsys)
    got = PV.main(["--wavenet", runs["port"], *args, "--out_dir",
                   str(tmp_path / "port_wavs"), "--device", "cpu"])
    assert last_json(capsys) == got
    assert set(got) == PV.RESULT_KEYS
    hold_result(got, want)
    assert (got["n_utterances"], got["n_heldout"]) == (5, 4)
    assert got["checkpoint_step"] == STEP
    assert sum(u.get("unseen_speaker", False) for u in got["per_utt"]) == 2

    for side, result in (("port", got), ("jax", want)):
        saved, history = read_persisted(runs[side])
        assert saved == result and history == [result]
    hold_result(*(without(read_persisted(runs[k])[0], "gen_realtime_factor")
                  for k in ("port", "jax")))

    names = sorted(os.listdir(tmp_path / "port_wavs"))
    assert names == sorted(os.listdir(tmp_path / "jax_wavs"))
    assert names == sorted(u["utt"] + ".wn.wav" for u in got["per_utt"])
    for name in names:
        a = load_wav(str(tmp_path / "port_wavs" / name), 24000)
        b = load_wav(str(tmp_path / "jax_wavs" / name), 24000)
        np.testing.assert_allclose(a, b, rtol=0, atol=2 / 32768)


def test_vocoder_eval_with_the_plain_twin_on_cpu(setup, tmp_path):
    """The real generator (the kernel's plain twin on the CPU) over 4
    frames per clip: finite MCDs, one finite wav per clip."""
    out = str(tmp_path / "wavs")
    got = PV.main(["--wavenet", setup["run"], "--data", setup["moon"],
                   "--unseen_data", setup["son"], "--n", "2", "--n_unseen",
                   "1", "--max_frames", "4", "--out_dir", out,
                   "--no_persist", "--device", "cpu"])
    assert got["n_utterances"] == 3 and got["n_heldout"] == 3
    for k in MCD_KEYS:
        assert np.isfinite(got[k]), k
    assert got["gen_realtime_factor"] > 0
    assert not os.path.exists(os.path.join(setup["run"], "eval.json"))
    for u in got["per_utt"]:
        wav = load_wav(os.path.join(out, u["utt"] + ".wn.wav"), 24000)
        assert wav.shape == (4 * 300,) and np.isfinite(wav).all()


def test_vocoder_eval_persists_only_into_a_run_dir(setup, fake_generation,
                                                   tmp_path, capsys):
    """Given a tarball, the command raises before any work unless
    --no_persist; with it, it scores the tarball's checkpoint."""
    tar = str(tmp_path / "wn.ckpt.tar.gz")
    with tarfile.open(tar, "w:gz") as t:
        for name in ("params.json", "ckpt"):
            t.add(os.path.join(setup["run"], name), arcname=name)
    args = ["--wavenet", tar, "--data", setup["moon"], "--n", "2",
            "--max_frames", "8", "--device", "cpu"]
    out = str(tmp_path / "wavs")
    with pytest.raises(ValueError, match="--no_persist"):
        PV.main([*args, "--out_dir", out])
    assert not os.path.exists(out)
    got = PV.main([*args, "--no_persist"])
    assert got["checkpoint_step"] == STEP and got["n_utterances"] == 2
    assert sorted(os.listdir(tmp_path)) == ["wn.ckpt.tar.gz"]
