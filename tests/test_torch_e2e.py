"""PyTorch port: the rest of ``synth/synthesizer.py`` (Griffin-Lim wavs,
manual-attention modes, file output, ``synthesize_long``), ``synth/e2e.py``
``TTSPipeline`` and the ``synthesizer`` / ``tts`` CLIs, against the JAX
package's on TINY widths with the same seeded weights.

The JAX ``Synthesizer`` is built by hand (``cfg``, ``model``,
``variables``, ``codec``, ``inference_dropout``: all that its
``synthesize`` reads) instead of ``load``, whose restore template costs an
eager flax init.  Griffin-Lim's initial phase is JAX's own draw, injected
through the port's ``initial_phase``.  Prenet dropout is off, so both
decodes are deterministic.  Tolerances are stated per test (float32 on a
CPU on both sides).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu.models.tacotron import (
    Tacotron as JTacotron)
from tacotron_wavenet_vocoder_korean_tpu.synth import synthesizer as JSyn
from tacotron_wavenet_vocoder_korean_tpu.synth.e2e import (
    TTSPipeline as JaxTTSPipeline)
from tacotron_wavenet_vocoder_korean_tpu.text import TextCodec as JaxCodec
from tacotron_wavenet_vocoder_korean_tpu.train.checkpoints import (
    CheckpointManager)
from tacotron_wavenet_vocoder_korean_tpu_torch import (
    config as PC, convert, synthesizer as synth_cli, tts as tts_cli)
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp import griffin_lim as PG
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import load_wav
from tacotron_wavenet_vocoder_korean_tpu_torch.synth import synthesizer as PSyn
from tacotron_wavenet_vocoder_korean_tpu_torch.synth.e2e import TTSPipeline
from tacotron_wavenet_vocoder_korean_tpu_torch.utils import plot

# tests/test_torch_tacotron.py's TINY widths, dropout off at inference.
TINY = PC.TacotronConfig(
    enc_bank_size=4, enc_bank_channel_size=32, enc_rnn_size=32,
    enc_prenet_sizes=(64, 32), enc_proj_sizes=(32, 32),
    attention_size=32, attention_state_size=32,
    dec_rnn_size=32, dec_prenet_sizes=(64, 32),
    post_bank_size=2, post_bank_channel_size=32, post_rnn_size=32,
    post_proj_sizes=(64, 80), embedding_size=32, max_iters=30,
    num_speakers=2, model_type="deepvoice", fused_rnn=True,
    dec_prenet_dropout_inference=False)
TEXTS = ["존경하는 국민 여러분", "오늘 3,600마리 강아지가 KIA에 왔다"]
SPEAKERS = [1, 0]
WAV_TOL = 1e-4
HOP = 300


def jax_phase(shape, seed, device):
    return torch.from_numpy(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
        maxval=2 * jnp.pi))).to(device)


@pytest.fixture(autouse=True)
def same_phase(monkeypatch):
    monkeypatch.setattr(PG, "initial_phase", jax_phase)


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


def close_wav(got, want):
    """Within WAV_TOL, and within 1e-3 of the wav's peak: seeded TINY
    weights make quiet wavs (peaks ~5e-3; observed errors <= ~5e-7)."""
    close(got, want, WAV_TOL, "wav")
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


@pytest.fixture(scope="module")
def synths():
    """(JAX Synthesizer, port Synthesizer) on the same seeded TINY
    weights."""
    params, stats = convert.seeded_tacotron_tree(TINY, 4)
    jax_synth = JSyn.Synthesizer()
    jax_synth.cfg = JC.Config(tacotron=JC.TacotronConfig(
        **dataclasses.asdict(TINY)))
    jax_synth.codec = JaxCodec(TINY.cleaners)
    jax_synth.model = JTacotron(cfg=jax_synth.cfg.tacotron,
                                audio=jax_synth.cfg.audio,
                                vocab_size=jax_synth.codec.vocab_size)
    jax_synth.variables = jax.tree.map(jnp.asarray, {
        "params": convert._nest(params), "batch_stats": convert._nest(stats)})
    jax_synth.inference_dropout = False
    port = PSyn.Synthesizer(PC.Config(tacotron=TINY),
                            convert.tacotron_params_from_jax(TINY, params,
                                                             stats),
                            device="cpu")
    return jax_synth, port


@pytest.fixture(scope="module")
def synthesized(synths, tmp_path_factory):
    """Both synthesizers on TEXTS with file output: (jax results, port
    results, jax dir, port dir)."""
    jax_synth, port = synths
    jdir, pdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "port"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PG, "initial_phase", jax_phase)
        want = jax_synth.synthesize(TEXTS, base_path=jdir,
                                    speaker_ids=SPEAKERS)
        got = port.synthesize(TEXTS, base_path=pdir, speaker_ids=SPEAKERS)
    return want, got, jdir, pdir


def test_synthesizer_wav_matches_jax(synthesized):
    """Each text's trimmed length, mel and Griffin-Lim wav (rendered from
    the linear frames padded to 100 frames): the same lengths, mel and wav
    within 1e-4 (observed <= ~8e-7 and ~1e-7)."""
    want, got, _, _ = synthesized
    assert [sorted(g) for g in got] == [sorted(set(w) | {"linear"})
                                        for w in want]
    for w, g in zip(want, got):
        n = w["mel"].shape[0]
        assert g["mel"].shape == w["mel"].shape
        assert g["linear"].shape == (n, 1025)
        assert g["wav"].shape == w["wav"].shape == (n * HOP,)
        assert g["wav"].dtype == np.float32 and g["text"] == w["text"]
        close(g["mel"], w["mel"], 1e-4, "mel")
        close_wav(g["wav"], w["wav"])
        assert np.abs(g["wav"]).max() > 1e-3


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_manual_attention_modes_match_jax(synths, mode):
    """The second decode with the first's alignments made one-hot (1),
    squared (2) or pruned (3): mel and wav within 1e-4 of JAX's, the
    alignments the injected ones."""
    jax_synth, port = synths
    want = jax_synth.synthesize(TEXTS, speaker_ids=SPEAKERS,
                                manual_attention_mode=mode)
    got = port.synthesize(TEXTS, speaker_ids=SPEAKERS,
                          manual_attention_mode=mode)
    for w, g in zip(want, got):
        assert g["mel"].shape == w["mel"].shape
        close(g["mel"], w["mel"], 1e-4, "mel")
        close_wav(g["wav"], w["wav"])
        close(g["alignment"], w["alignment"], 1e-5, "alignment")
    if mode == 1:
        assert set(np.unique(got[0]["alignment"])) <= {0.0, 1.0}


def test_manual_attention_mode_out_of_range_raises(synths):
    with pytest.raises(ValueError):
        synths[1].manual_alignments(np.zeros((1, 4, 3)), 4)


def test_file_output_names_mel_and_png(synthesized):
    """The JAX synthesizer's file names; the ``.mel.npy`` round trip
    (no pickle); the wav at the sample rate; a PNG that matplotlib reads
    at ``image_size`` of the alignment cut to the text."""
    from matplotlib import image
    want, got, jdir, pdir = synthesized
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for i, (w, g) in enumerate(zip(want, got)):
        for key, name in (("wav_path", f"{i}.wav"),
                          ("mel_path", f"{i}.mel.npy"),
                          ("alignment_path", f"{i}.png")):
            assert g[key] == os.path.join(pdir, name)
            assert os.path.basename(w[key]) == name
        mel = np.load(g["mel_path"], allow_pickle=False)
        assert mel.dtype == np.float32
        np.testing.assert_array_equal(mel, g["mel"])
        wav = load_wav(g["wav_path"], 24000)
        assert wav.shape == g["wav"].shape
        close(wav, g["wav"] / max(0.01, np.abs(g["wav"]).max()), 1e-4)
        n_text = len(port_codec().encode(TEXTS[i]))
        img = image.imread(g["alignment_path"])
        assert img.shape == (*plot.image_size(n_text, TINY.max_iters), 3)


def port_codec():
    from tacotron_wavenet_vocoder_korean_tpu_torch.text import TextCodec
    return TextCodec(TINY.cleaners)


def test_save_flags_and_manual_suffix(synths, tmp_path):
    """``save_mel`` / ``save_alignment`` off write the wav alone; a manual
    mode writes ``{i}_manual.*``."""
    port = synths[1]
    port.synthesize(TEXTS[:1], base_path=str(tmp_path / "a"), max_iters=4,
                    save_mel=False, save_alignment=False)
    assert os.listdir(tmp_path / "a") == ["0.wav"]
    r = port.synthesize(TEXTS[:1], base_path=str(tmp_path / "b"),
                        max_iters=4, manual_attention_mode=2)[0]
    assert sorted(os.listdir(tmp_path / "b")) == [
        "0_manual.mel.npy", "0_manual.png", "0_manual.wav"]
    assert r["wav_path"].endswith("0_manual.wav")


def test_synthesize_long_matches_jax(synths, tmp_path):
    """Sentences synthesized as one batch, joined by 150 ms of silence:
    wav and mel within 1e-4 of JAX's, ``long.wav`` and ``long.mel.npy``."""
    jax_synth, port = synths
    text = f"{TEXTS[0]}. {TEXTS[1]}!"
    want = jax_synth.synthesize_long(text, base_path=str(tmp_path / "j"),
                                     speaker_id=1)
    got = port.synthesize_long(text, base_path=str(tmp_path / "p"),
                               speaker_id=1)
    assert got["pieces"] == want["pieces"] == 2 and got["text"] == text
    assert got["wav"].shape == want["wav"].shape
    assert got["mel"].shape == want["mel"].shape
    close(got["mel"], want["mel"], 1e-4, "mel")
    close_wav(got["wav"], want["wav"])
    assert sorted(os.listdir(tmp_path / "p")) == ["long.mel.npy", "long.wav"]
    np.testing.assert_array_equal(np.load(got["mel_path"]), got["mel"])


class SpyVocoder:
    """Records what ``generate`` is handed and returns a recognisable wav
    of ``frames * HOP`` samples per mel (``drop`` wavs fewer)."""

    def __init__(self, drop: int = 0):
        self.calls, self.drop = [], drop

    def generate(self, mel, speaker_id=None, **kw):
        mels = [np.array(m) for m in mel]
        self.calls.append((mels, speaker_id))
        wavs = [np.full(m.shape[0] * HOP, 0.01 * (len(self.calls) + k),
                        np.float32) for k, m in enumerate(mels)]
        return wavs[:len(wavs) - self.drop]


TEN = ["가", "나라", "다리 밑", "라디오", "마음이 좋다", "바다", "사랑해",
       "아침 7시", "자전거", "차 한 잔"]


def test_tts_pipeline_vocodes_the_trimmed_mels_in_chunks_as_jax(
        synths, tmp_path):
    """10 texts: both pipelines hand the vocoder chunks of 8 and 2 with the
    matching speaker ids and the same trimmed mels (within 1e-4); the
    port writes ``{i}.wavenet.wav`` beside the Griffin-Lim files."""
    jax_synth, port = synths
    ids = [i % 2 for i in range(10)]
    jax_pipe = JaxTTSPipeline()
    jax_pipe.synth, jax_pipe.vocoder = jax_synth, SpyVocoder()
    pipe = TTSPipeline(port, SpyVocoder())
    want = jax_pipe.tts(TEN, base_path=str(tmp_path / "j"), speaker_ids=ids)
    got = pipe.tts(TEN, base_path=str(tmp_path / "p"), speaker_ids=ids)
    jcalls, pcalls = jax_pipe.vocoder.calls, pipe.vocoder.calls
    assert [len(m) for m, _ in pcalls] == [len(m) for m, _ in jcalls] == [8, 2]
    assert [s for _, s in pcalls] == [s for _, s in jcalls] == [ids[:8],
                                                                ids[8:]]
    for (pm, _), (jm, _) in zip(pcalls, jcalls):
        for a, b in zip(pm, jm):
            assert a.shape == b.shape
            close(a, b, 1e-4)
    for i, (r, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(r["mel"], pcalls[i // 8][0][i % 8])
        np.testing.assert_array_equal(r["wavenet_wav"], w["wavenet_wav"])
        assert r["wavenet_wav_path"] == str(tmp_path / "p" / f"{i}.wavenet.wav")
        assert os.path.exists(r["wav_path"])
    assert sorted(os.listdir(tmp_path / "p")) == sorted(
        os.listdir(tmp_path / "j"))


def test_tts_pipeline_without_vocoder_and_length_check(synths):
    port = synths[1]
    r = TTSPipeline(port).tts(TEXTS[:1], speaker_ids=[0])
    assert "wavenet_wav" not in r[0] and r[0]["wav"].size
    spy = SpyVocoder()
    r = TTSPipeline(port, spy).tts(TEXTS[:1], use_wavenet=False)
    assert spy.calls == [] and "wavenet_wav" not in r[0]
    with pytest.raises(RuntimeError, match="1 mels"):
        TTSPipeline(port, SpyVocoder(drop=1)).tts(TEXTS[:1])


# ---------------------------------------------------------------------------
# The CLIs, on run dirs of seeded TINY weights written by the JAX package
# ---------------------------------------------------------------------------

TINY_WN = dict(dilations=(1, 2, 4, 1, 2, 4), residual_channels=8,
               dilation_channels=8, skip_channels=16, out_channels=12,
               initial_filter_width=8, upsample_factor=(5, 5, 12))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A Tacotron run (TINY, 3 decoder steps, prenet dropout on as served)
    and a WaveNet run (tiny stack, hop 300) in the JAX run-dir layout."""
    taco = dataclasses.replace(TINY, max_iters=3,
                               dec_prenet_dropout_inference=True)
    wn = dataclasses.replace(PC.WaveNetConfig(), **TINY_WN)
    out = {}
    for name in ("taco", "wn"):
        d = str(tmp_path_factory.mktemp(name))
        cfg = JC.Config(tacotron=JC.TacotronConfig(**dataclasses.asdict(taco)),
                        wavenet=dataclasses.replace(JC.WaveNetConfig(),
                                                    **TINY_WN))
        JC.save_config(cfg, d)
        if name == "taco":
            params, stats = convert.seeded_tacotron_tree(taco, 5)
            state = {"params": convert._nest(params),
                     "batch_stats": convert._nest(stats)}
        else:
            state = {"ema_params": convert._nest(convert.seeded_tree(wn, 6))}
        mgr = CheckpointManager(d)
        mgr.save(7, {**state, "step": np.asarray(7, np.int32)})
        mgr.close()
        out[name] = d
    return out


def test_synthesizer_cli_on_cpu(runs, tmp_path, capsys):
    out = str(tmp_path / "out")
    synth_cli.main(["--load_path", runs["taco"], "--text", TEXTS[0],
                    "--text", TEXTS[1], "--speaker_id", "1",
                    "--speaker_id", "0", "--base_path", out,
                    "--manual_attention_mode", "1", "--max_iters", "2",
                    "--fused_rnn", "--device", "cpu"])
    assert sorted(os.listdir(out)) == sorted(
        f"{i}_manual.{ext}" for i in range(2) for ext in ("mel.npy", "png",
                                                          "wav"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and "0_manual.wav" in lines[0]
    mel = np.load(os.path.join(out, "1_manual.mel.npy"))
    assert mel.shape[1] == 80 and 0 < mel.shape[0] <= 10


def test_tts_cli_on_cpu(runs, tmp_path, capsys):
    """Both runs: 0.wav (Griffin-Lim), 0.wavenet.wav, 0.mel.npy and 0.png;
    the WaveNet wav spans the mel."""
    out = str(tmp_path / "out")
    tts_cli.main(["--tacotron", runs["taco"], "--wavenet", runs["wn"],
                  "--text", TEXTS[0], "--speaker_id", "1", "--out_dir", out,
                  "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["0.mel.npy", "0.png", "0.wav",
                                       "0.wavenet.wav"]
    frames = np.load(os.path.join(out, "0.mel.npy")).shape[0]
    assert load_wav(os.path.join(out, "0.wavenet.wav"), 24000).shape == (
        frames * HOP,)
    line = capsys.readouterr().out.strip()
    assert "GL:" in line and "0.wavenet.wav" in line
    gl_only = str(tmp_path / "gl")
    tts_cli.main(["--tacotron", runs["taco"], "--text", TEXTS[0],
                  "--out_dir", gl_only, "--device", "cpu"])
    assert sorted(os.listdir(gl_only)) == ["0.mel.npy", "0.png", "0.wav"]


def test_pipeline_and_clis_refuse_to_run_on_cpu_silently(runs, monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        TTSPipeline.from_checkpoint(runs["taco"], runs["wn"])
    with pytest.raises(RuntimeError, match="no CUDA"):
        synth_cli.main(["--load_path", runs["taco"], "--text", "가",
                        "--base_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA"):
        tts_cli.main(["--tacotron", runs["taco"], "--text", "가",
                      "--out_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
    pipe = TTSPipeline.from_checkpoint(runs["taco"], runs["wn"], "cpu")
    assert pipe.synth.step == pipe.vocoder.step == 7
    assert pipe.vocoder.cfg.audio.hop_size == HOP
