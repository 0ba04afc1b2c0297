"""PyTorch port: ``scripts/quality_eval.py`` (CPU).

The port's command on ``--device cpu`` against the JAX system's
``scripts/quality_eval.py`` (loaded with importlib, ``main()`` under a
patched ``sys.argv``) on one TINY two-speaker Tacotron run dir, one TINY
WaveNet run dir and a small corpus of committed clips preprocessed by the
port, split into a moon and a son dir.  Both sides decode without prenet
dropout (``--inference_dropout off``), Griffin-Lim starts from JAX's
initial phase, and WaveNet generation is replaced on both sides by one
function of the mel.  Both sides print MCDs rounded to 0.01 dB, so they
are held within 0.01 dB (observed: equal); the utterances picked, the
held-out split and the per-speaker keys are held equal.
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
from tacotron_wavenet_vocoder_korean_tpu_torch.scripts import (
    quality_eval as PQ)
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
    WaveNetGenerator)
from torch_eval_util import (STEP, close_db, fake_vocoder, jax_phase,
                             last_json, load_jax_script, make_corpus,
                             run_jax, same_keys, tacotron_run, wavenet_run,
                             without)

JQ = load_jax_script("quality_eval")
MCD_KEYS = ("synth_mcd_db", "oracle_mcd_db", "gap_db", "e2e_mcd_db")
LIST_KEYS = ("per_utt_synth", "per_utt_oracle", "per_utt_e2e")
# Every clip cut to 100 frames: the oracle's Griffin-Lim then has the shape
# of the synthesized wavs' (one bucket), so JAX compiles it once.
CLIP_FRAMES = 100


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("quality_eval"))
    return {"data": make_corpus(root, frames=CLIP_FRAMES),
            "taco": tacotron_run(os.path.join(root, "taco")),
            "wn": wavenet_run(os.path.join(root, "wn"))}


@pytest.fixture(autouse=True)
def same_draws(monkeypatch):
    monkeypatch.setattr(PG, "initial_phase", jax_phase)
    for cls in (JaxGenerator, WaveNetGenerator):
        monkeypatch.setattr(cls, "generate",
                            lambda self, mel, *a, **k: fake_vocoder(mel))


def hold_scores(got: dict, want: dict) -> None:
    """One level of a result (the top or a speaker's entry): the same
    keys, MCDs within 0.01 dB, everything else equal."""
    same_keys(got, want)
    for k, w in want.items():
        if k in MCD_KEYS:
            close_db(got[k], w)
        elif k in LIST_KEYS:
            assert len(got[k]) == len(w), k
            for g1, w1 in zip(got[k], w):
                close_db(g1, w1)
        elif k != "per_speaker":
            assert got[k] == w, k


def hold_result(got: dict, want: dict) -> None:
    hold_scores(got, want)
    assert list(got["per_speaker"]) == list(want["per_speaker"])
    for key, entry in want["per_speaker"].items():
        hold_scores(got["per_speaker"][key], entry)


def persisted(run: str) -> tuple:
    with open(os.path.join(run, "eval.json")) as f:
        saved = json.load(f)
    with open(os.path.join(run, "eval_history.jsonl")) as f:
        return saved, [json.loads(line) for line in f]


@pytest.mark.parametrize("mode", ["heldout_e2e", "spread"])
def test_quality_eval_matches_jax(setup, mode, tmp_path, monkeypatch,
                                  capsys):
    """``heldout_e2e``: --heldout over both dirs, --wavenet with
    --e2e_max_frames 30, each side persisting into its own copy of the
    Tacotron run and writing its wavs.  ``spread``: --n 2 spread over each
    whole dir, --no_persist."""
    moon, son = setup["data"]
    args = ["--data", f"{moon},{son}", "--n", "2", "--inference_dropout",
            "off"]
    runs = {k: setup["taco"] for k in ("jax", "port")}
    if mode == "heldout_e2e":
        runs = {k: shutil.copytree(setup["taco"], str(tmp_path / k))
                for k in runs}
        args += ["--heldout", "--wavenet", setup["wn"], "--e2e_max_frames",
                 "30"]
    else:
        args += ["--no_persist"]
    extra = {k: (["--out_dir", str(tmp_path / f"{k}_wavs")]
                 if mode == "heldout_e2e" else []) for k in runs}
    want = run_jax(JQ, ["--tacotron", runs["jax"], *args, *extra["jax"]],
                   monkeypatch, capsys)
    got = PQ.main(["--tacotron", runs["port"], *args, *extra["port"],
                   "--device", "cpu"])
    assert last_json(capsys) == got
    hold_result(got, want)
    keys = PQ.RESULT_KEYS | (PQ.E2E_KEYS if mode == "heldout_e2e" else set())
    assert set(got) == keys
    assert list(got["per_speaker"]) == ["0:moon", "1:son"]
    for entry in got["per_speaker"].values():
        assert set(entry) == PQ.SPEAKER_KEYS | (
            PQ.SPEAKER_E2E_KEYS if mode == "heldout_e2e" else set())
        assert entry["n"] == 2 and np.isfinite(entry["synth_mcd_db"])
    assert got["n_utterances"] == 4 and got["checkpoint_step"] == STEP
    assert got["heldout_only"] == (mode == "heldout_e2e")
    if mode == "spread":
        assert not os.path.exists(os.path.join(setup["taco"], "eval.json"))
        return
    assert got["e2e_vocoder_step"] == STEP
    assert np.isfinite(got["e2e_mcd_db"])
    for side, result in (("port", got), ("jax", want)):
        saved, history = persisted(runs[side])
        assert saved == result and history == [result]
    hold_result(persisted(runs["port"])[0], persisted(runs["jax"])[0])
    names = sorted(os.listdir(tmp_path / "port_wavs"))
    assert names == sorted(os.listdir(tmp_path / "jax_wavs"))
    assert len(names) == 8 and sum(n.endswith(".e2e.wav")
                                   for n in names) == 4


def test_quality_eval_persists_only_into_a_run_dir(setup, tmp_path):
    """Given a tarball, the command raises before any work unless
    --no_persist; with it (and --fused_rnn, which changes nothing), it
    scores the tarball's checkpoint."""
    tar = str(tmp_path / "taco.ckpt.tar.gz")
    with tarfile.open(tar, "w:gz") as t:
        for name in ("params.json", "ckpt"):
            t.add(os.path.join(setup["taco"], name), arcname=name)
    moon, _ = setup["data"]
    args = ["--tacotron", tar, "--data", moon, "--n", "1", "--device", "cpu",
            "--inference_dropout", "off"]
    with pytest.raises(ValueError, match="--no_persist"):
        PQ.main([*args, "--out_dir", str(tmp_path / "wavs")])
    assert sorted(os.listdir(tmp_path)) == ["taco.ckpt.tar.gz"]
    got = PQ.main([*args, "--no_persist", "--fused_rnn"])
    plain = PQ.main([*args, "--no_persist"])
    assert got == plain
    assert got["checkpoint_step"] == STEP and got["n_utterances"] == 1
    assert without(got["per_speaker"]["0:moon"], "per_utt_synth",
                   "per_utt_oracle")["n"] == 1
