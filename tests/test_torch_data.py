"""PyTorch port: the data pipeline against the JAX package's (CPU).

The preprocessing helpers (``dsp/audio_io.py`` rescale and trimming,
``dsp/mulaw.py`` encode / decode, ``dsp/stft.py`` ``extract_features``),
the corpus builders (``data/corpus.py``), ``WaveNetBatcher``
(``data/loader.py``) and ``DevicePrefetcher`` (``data/feeder.py``).  The
corpus stands in for the absent one: the 18 committed
``samples/wn_moon_260k`` wavs (10 of moon's clips, 8 of son's; two are
shorter than a 15,000-sample crop) in the moon layout, every clip with
text 0 of ``samples/README.md``, built by JAX's ``preprocess_corpus`` and
by the port's (``device='cpu'``).  Tolerances are stated per test.
"""
import dataclasses
import json
import os
import shutil
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import config as JC
from tacotron_wavenet_vocoder_korean_tpu import data as JD
from tacotron_wavenet_vocoder_korean_tpu import dsp as JDSP
from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
from tacotron_wavenet_vocoder_korean_tpu_torch import data as PD
from tacotron_wavenet_vocoder_korean_tpu_torch import dsp as PDSP
from chip_smoke import features_f64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVS = os.path.join(REPO, "samples", "wn_moon_260k")
TEXT0 = "존경하는 국민 여러분, 안녕하십니까."
INPUT_TYPES = ("raw", "mulaw", "mulaw-quantize")
KEYS = ("audio", "mel", "linear", "time_steps", "mel_frames", "text",
        "tokens", "loss_coeff")
MEL_TOL = 1e-5            # extract_features' mel, port vs JAX
LIN_F64_RATIO = 2.0       # linear: distance from float64, against JAX's
LIN_MEAN_TOL = 1e-5       # linear: mean |port - JAX|
F16_ATOL, F16_RTOL = 4e-3, 2e-3   # the f16 store's mel (tests/test_data.py)


def overrides(input_type):
    if input_type == "mulaw-quantize":
        return {"input_type": input_type, "scalar_input": False}
    return {"input_type": input_type}


def configs(wavenet=None, train=None):
    """The JAX and the port's Config with the same overrides."""
    groups = {k: v for k, v in (("wavenet", wavenet), ("train", train)) if v}
    return (JC.overlay(JC.Config(), **groups),
            PC.overlay(PC.Config(), **groups))


@pytest.fixture(scope="module")
def moon_in(tmp_path_factory):
    """The committed clips in the moon layout."""
    root = tmp_path_factory.mktemp("moon_in")
    (root / "audio").mkdir()
    table = {}
    for f in sorted(os.listdir(WAVS)):
        shutil.copy(os.path.join(WAVS, f), root / "audio" / f)
        table[f"audio/{f}"] = TEXT0
    with open(root / "moon-recognition-All.json", "w", encoding="utf-8") as f:
        json.dump(table, f, ensure_ascii=False)
    return str(root)


@pytest.fixture(scope="module")
def corpora(moon_in, tmp_path_factory):
    """input_type -> (JAX's out dir, the port's out dir)."""
    out = {}
    for it in INPUT_TYPES:
        jcfg, pcfg = configs(wavenet=overrides(it))
        root = tmp_path_factory.mktemp(f"corpus_{it}")
        JD.preprocess_corpus(jcfg, "moon", moon_in, str(root / "jax"))
        PD.preprocess_corpus(pcfg, "moon", moon_in, str(root / "port"),
                             num_workers=4, device="cpu")
        out[it] = (str(root / "jax"), str(root / "port"))
    return out


def clip(name):
    return PDSP.load_wav(os.path.join(WAVS, name), 24000)


# ---------------------------------------------------------------------------
# dsp: rescale, trimming, mu-law, extract_features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["003.0000.wn.wav", "006.0116.wn.wav",
                                  "NB10584578.0018.wn.wav"])
def test_rescale_trim_and_silence_indices_equal_jax(name):
    """Exact: rescale, trim_silence (and with trimming off), and the
    mulaw-quantize silence crop's indices at thresholds 0 and 2."""
    jcfg, pcfg = configs()
    wav = clip(name)
    r = PDSP.rescale(wav, pcfg.audio)
    np.testing.assert_array_equal(r, JDSP.rescale(wav, jcfg.audio))
    np.testing.assert_array_equal(PDSP.trim_silence(r, pcfg.audio),
                                  JDSP.trim_silence(r, jcfg.audio))
    off = dataclasses.replace(pcfg.audio, trim_silence=False)
    assert PDSP.trim_silence(r, off) is r
    q = np.asarray(JDSP.mulaw_quantize(r, 256))
    for threshold in (0, 2):
        assert (PDSP.start_and_end_indices(q, threshold)
                == JDSP.start_and_end_indices(q, threshold))
    assert PDSP.start_and_end_indices(np.full(9, 127), 2) == (0, 9)


def test_mulaw_encode_decode_equal_jax():
    """10^5 seeded values in [-1.2, 1.2] (clipped): ids exact; decoded
    ids within 1e-6."""
    x = np.random.default_rng(0).uniform(-1.2, 1.2, 100_000).astype(
        np.float32)
    ids = PDSP.mulaw_encode(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(JDSP.mulaw_encode(jnp.asarray(x), 256)))
    np.testing.assert_allclose(
        PDSP.mulaw_decode(ids, 256).numpy(),
        np.asarray(JDSP.mulaw_decode(jnp.asarray(ids.numpy()), 256)),
        rtol=0, atol=1e-6)


def features(name):
    """(port's, JAX's, float64) (mel, linear) of a rescaled, trimmed clip."""
    jcfg, pcfg = configs()
    wav = PDSP.trim_silence(PDSP.rescale(clip(name), pcfg.audio),
                            pcfg.audio)
    port = PDSP.extract_features(wav, pcfg.audio, "cpu")
    assert port[0].shape[1] == 1 + len(wav) // pcfg.audio.hop_size
    return port, JDSP.extract_features(wav, jcfg.audio), features_f64(
        wav, pcfg.audio)


@pytest.mark.parametrize("name", ["003.0013.wn.wav", "006.0028.wn.wav",
                                  "NB10584578.0000.wn.wav",
                                  "NB10584578.0018.wn.wav"])
def test_extract_features_matches_jax(name):
    """Mel within 1e-5 of JAX's.  Linear: near the -100 dB floor a bin's
    dB value keeps few digits in float32, and which few bins come out
    worst differs between two float32 FFTs; per clip, the 99.9th
    percentile of the port's distance from float64 is at most
    LIN_F64_RATIO times JAX's, and its mean distance from JAX's at most
    1e-5.  (The largest distance is held over the whole corpus, below.)"""
    (mel, lin), (jmel, jlin), (_, lin64) = features(name)
    assert mel.dtype == lin.dtype == np.float32
    assert mel.shape == jmel.shape and lin.shape == jlin.shape
    np.testing.assert_allclose(mel, jmel, rtol=0, atol=MEL_TOL)
    assert (np.quantile(np.abs(lin - lin64), 0.999)
            <= LIN_F64_RATIO * np.quantile(np.abs(jlin - lin64), 0.999))
    assert np.abs(lin - jlin).mean() <= LIN_MEAN_TOL


def test_extract_features_largest_linear_error_over_the_corpus():
    """Over all 18 clips, the port's largest linear distance from float64
    is at most LIN_F64_RATIO times JAX's largest.  (Per clip the ratio of
    the two largest reaches 3.1, on one bin of 006.0028 at -3.03: the
    outlier bins of two float32 FFTs are different bins.)"""
    worst_port = worst_jax = 0.0
    for name in sorted(os.listdir(WAVS)):
        (_, lin), (_, jlin), (_, lin64) = features(name)
        worst_port = max(worst_port, float(np.abs(lin - lin64).max()))
        worst_jax = max(worst_jax, float(np.abs(jlin - lin64).max()))
    assert worst_port <= LIN_F64_RATIO * worst_jax


def test_extract_features_refuses_to_run_on_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        PDSP.extract_features(clip("003.0000.wn.wav"), PC.AudioConfig())


# ---------------------------------------------------------------------------
# corpus: npz files and train.txt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("input_type", INPUT_TYPES)
def test_npz_fields_match_jax(corpora, input_type):
    """The same files with the same 8 keys (JAX's also hold a stray
    ``allow_pickle`` array, see data/corpus.py), dtypes and shapes; audio exact
    (raw), within 1e-6 (mulaw), classes exact but where float32 rounding
    crosses a class edge (mulaw-quantize: each flip off by one, at most
    1e-4 of the samples, the same silence crop); time_steps, mel_frames,
    text, tokens and loss_coeff exact; mel within 1e-5; linear's mean
    distance within 1e-5 (its largest is held in
    test_extract_features_matches_jax).  The npz invariants of
    tests/test_data.py hold."""
    jdir, pdir = corpora[input_type]
    names = sorted(f for f in os.listdir(jdir) if f.endswith(".npz"))
    assert names == sorted(f for f in os.listdir(pdir) if f.endswith(".npz"))
    assert len(names) == 18
    flips = total = 0
    for name in names:
        with np.load(os.path.join(jdir, name)) as j, \
                np.load(os.path.join(pdir, name)) as p:
            assert sorted(p.files) == sorted(KEYS)
            assert sorted(j.files) == sorted(KEYS + ("allow_pickle",))
            for k in KEYS:
                assert p[k].dtype == j[k].dtype and p[k].shape == j[k].shape
            for k in ("time_steps", "mel_frames", "text", "tokens",
                      "loss_coeff"):
                np.testing.assert_array_equal(p[k], j[k])
            np.testing.assert_allclose(p["mel"], j["mel"], rtol=0,
                                       atol=MEL_TOL)
            assert np.abs(p["linear"] - j["linear"]).mean() <= LIN_MEAN_TOL
            a, b = p["audio"], j["audio"]
            if input_type == "raw":
                np.testing.assert_array_equal(a, b)
            elif input_type == "mulaw":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            else:
                assert a.dtype == np.int16
                diff = np.abs(a.astype(np.int64) - b)
                assert diff.max() <= 1
                flips += int(diff.sum())
                total += a.size
            assert len(a) == int(p["mel_frames"]) * 300
            assert p["mel"].shape == (int(p["mel_frames"]), 80)
            assert p["linear"].shape[1] == 1025
            assert p["tokens"][-1] == 1
    assert flips <= 1e-4 * total


@pytest.mark.parametrize("input_type", INPUT_TYPES)
def test_train_txt_byte_equal_and_config_written(corpora, input_type):
    jdir, pdir = corpora[input_type]
    read = lambda d: open(os.path.join(d, "train.txt"), "rb").read()
    assert read(pdir) == read(jdir)
    assert len(read(pdir).decode("utf-8").splitlines()) == 18


def _english_layouts(root, name):
    """Two committed clips in the LJSpeech or CMU ARCTIC layout
    (tests/test_data.py's builders' fixtures)."""
    src = sorted(os.listdir(WAVS))[:2]
    if name == "ljspeech":
        (root / "wavs").mkdir(parents=True)
        rows = []
        for i, f in enumerate(src):
            shutil.copy(os.path.join(WAVS, f), root / "wavs" / f"LJ001-{i:04d}.wav")
            rows.append(f"LJ001-{i:04d}|Printing number {i}|"
                        f"Printing, in the only sense number {i}.")
        (root / "metadata.csv").write_text("\n".join(rows) + "\n",
                                           encoding="utf-8")
        return "LJ001-0000.npz", "number"
    (root / "wav").mkdir(parents=True)
    (root / "etc").mkdir()
    rows = []
    for i, f in enumerate(src):
        shutil.copy(os.path.join(WAVS, f), root / "wav" / f"arctic_a{i:04d}.wav")
        rows.append(f'( arctic_a{i:04d} "Author of the danger trail '
                    f'number {i}." )')
    rows.append(";; festival comment line")
    (root / "etc" / "txt.done.data").write_text("\n".join(rows) + "\n",
                                                encoding="utf-8")
    return "arctic_a0000.npz", "danger trail"


@pytest.mark.parametrize("name", ["ljspeech", "cmu_arctic"])
def test_english_layouts_match_jax(tmp_path, name):
    """LJSpeech and CMU ARCTIC with english_cleaners: two examples, the
    same train.txt, tokens and audio as JAX's, English EOS, the upsampler
    invariant."""
    first, phrase = _english_layouts(tmp_path / "in", name)
    english = {"cleaners": "english_cleaners"}
    jcfg = JC.overlay(JC.Config(), tacotron=english)
    pcfg = PC.overlay(PC.Config(), tacotron=english)
    jex = JD.preprocess_corpus(jcfg, name, str(tmp_path / "in"),
                               str(tmp_path / "jax"))
    pex = PD.preprocess_corpus(pcfg, name, str(tmp_path / "in"),
                               str(tmp_path / "port"), device="cpu")
    assert pex == jex and len(pex) == 2
    read = lambda d: open(tmp_path / d / "train.txt", "rb").read()
    assert read("port") == read("jax")
    with np.load(tmp_path / "port" / first) as p, \
            np.load(tmp_path / "jax" / first) as j:
        assert phrase in str(p["text"])
        assert p["tokens"][-1] == 1
        np.testing.assert_array_equal(p["tokens"], j["tokens"])
        np.testing.assert_array_equal(p["audio"], j["audio"])
        assert len(p["audio"]) == int(p["mel_frames"]) * 300


def test_unknown_corpus_raises(tmp_path):
    with pytest.raises(KeyError, match="unknown corpus"):
        PD.preprocess_corpus(PC.Config(), "vctk", str(tmp_path),
                             str(tmp_path / "out"), device="cpu")


# ---------------------------------------------------------------------------
# WaveNetBatcher
# ---------------------------------------------------------------------------

def split_dirs(src, root, with_txt):
    """The corpus at ``src`` as two speaker dirs, moon's clips and son's,
    each with its own rows of train.txt (or none)."""
    rows = open(os.path.join(src, "train.txt"), encoding="utf-8").read(
        ).splitlines()
    dirs = []
    for speaker, keep in (("moon", lambda f: not f.startswith("NB")),
                          ("son", lambda f: f.startswith("NB"))):
        d = os.path.join(root, speaker)
        os.makedirs(d)
        mine = [r for r in rows if keep(r.split("|")[0])]
        for r in mine:
            shutil.copy(os.path.join(src, r.split("|")[0]), d)
        if with_txt:
            with open(os.path.join(d, "train.txt"), "w",
                      encoding="utf-8") as f:
                f.write("\n".join(mine) + "\n")
        dirs.append(d)
    return dirs


def corpus_dirs(corpora, tmp_path, n_dirs, with_txt, input_type="raw"):
    src = corpora[input_type][1]
    if n_dirs == 2:
        return split_dirs(src, str(tmp_path), with_txt)
    d = str(tmp_path / "one")
    shutil.copytree(src, d)
    if not with_txt:
        os.remove(os.path.join(d, "train.txt"))
    return [d]


def assert_host_batches_equal(pb, jb):
    for k in ("input_wav", "local_condition", "speaker_id"):
        a, b = getattr(pb, k), getattr(jb, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("data_type,n_dirs,with_txt", [
    ("train", 1, True), ("test", 1, True), ("train", 1, False),
    ("train", 2, True), ("test", 2, False), ("train", 2, False)])
def test_wavenet_batcher_host_batches_equal_jax(corpora, tmp_path, data_type,
                                                n_dirs, with_txt):
    """Host batches of B = 3 crops of 15,000 samples (the default config:
    the two clips shorter than a crop are left out) from the train and the
    test stream, one dir and two (speaker ids), from train.txt and from the
    npz files: equal to JAX's, draw for draw, over 12 batches (several
    groups), and the rng streams end equal."""
    dirs = corpus_dirs(corpora, tmp_path, n_dirs, with_txt)
    jcfg, pcfg = configs()
    kw = dict(batch_size=3, gc_enable=n_dirs > 1, seed=5,
              batches_per_group=2, data_type=data_type)
    j = JD.WaveNetBatcher(dirs, jcfg, **kw)
    p = PD.WaveNetBatcher(dirs, pcfg, **kw)
    assert p.path_dict == j.path_dict
    assert sum(map(len, p.path_dict.values())) == (
        16 - 2 * n_dirs if data_type == "train" else 2 * n_dirs)
    jit, pit = iter(j), iter(p)
    for _ in range(12):
        assert_host_batches_equal(next(pit), next(jit))
    assert all(np.array_equal(a, b) for a, b in zip(
        p.rng.get_state(), j.rng.get_state()))


@pytest.mark.parametrize("n_test,warns", [(8, False), (9, True)])
def test_held_out_split_at_exactly_twice_and_below(corpora, tmp_path, n_test,
                                                   warns):
    """16 usable clips: num_test_per_speaker = 8 (exactly 2x) splits them 8
    / 8; 9 (< 2x) keeps all 16 in both streams and the test stream warns,
    in both packages.  The streams equal JAX's."""
    dirs = corpus_dirs(corpora, tmp_path, 1, True)
    jcfg, pcfg = configs(train={"num_test_per_speaker": n_test})
    for data_type in ("train", "test"):
        kw = dict(batch_size=2, seed=1, batches_per_group=2,
                  data_type=data_type)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            j = JD.WaveNetBatcher(dirs, jcfg, **kw)
            p = PD.WaveNetBatcher(dirs, pcfg, **kw)
        said = [str(w.message) for w in caught if "2x" in str(w.message)]
        assert len(said) == (2 if warns and data_type == "test" else 0)
        assert p.path_dict == j.path_dict
        assert len(p.path_dict[dirs[0]]) == (16 if warns else 8)
        jit, pit = iter(j), iter(p)
        for _ in range(3):
            assert_host_batches_equal(next(pit), next(jit))


def test_wavenet_batcher_refuses_a_group_smaller_than_a_batch(corpora,
                                                             tmp_path):
    """B = 1 with one batch per group over two dirs draws 0 clips from each
    (JAX's batcher then loops for ever without yielding); the port raises.
    B = 2 draws one from each, and yields."""
    dirs = corpus_dirs(corpora, tmp_path, 2, True)
    pcfg = configs()[1]
    with pytest.raises(ValueError, match="draws no full batch"):
        PD.WaveNetBatcher(dirs, pcfg, batch_size=1, batches_per_group=1)
    b = next(iter(PD.WaveNetBatcher(dirs, pcfg, batch_size=2,
                                    batches_per_group=1, gc_enable=True)))
    assert sorted(b.speaker_id) == [0, 1]


@pytest.mark.parametrize("case", ["raw_as_quantized", "quantized_as_raw",
                                  "no_usable_clip"])
def test_wavenet_batcher_refusals_equal_jax(corpora, tmp_path, case):
    """A corpus whose audio dtype disagrees with wavenet.input_type, and a
    dir with no clip longer than a crop, raise ValueError in both."""
    if case == "raw_as_quantized":
        dirs = corpus_dirs(corpora, tmp_path, 1, True, "raw")
        jcfg, pcfg = configs(wavenet=overrides("mulaw-quantize"))
        match = "does not match"
    elif case == "quantized_as_raw":
        dirs = corpus_dirs(corpora, tmp_path, 1, True, "mulaw-quantize")
        jcfg, pcfg = configs()
        match = "does not match"
    else:
        dirs = corpus_dirs(corpora, tmp_path, 1, False)
        jcfg, pcfg = configs(wavenet={"sample_size": 80_000})
        match = "no npz with time_steps"
    with pytest.raises(ValueError, match=match):
        JD.WaveNetBatcher(dirs, jcfg)
    with pytest.raises(ValueError, match=match):
        PD.WaveNetBatcher(dirs, pcfg)


def test_quantized_corpus_batches_equal_jax(corpora, tmp_path):
    """A mulaw-quantize corpus: class ids as float32 crops, equal to
    JAX's."""
    dirs = corpus_dirs(corpora, tmp_path, 1, True, "mulaw-quantize")
    jcfg, pcfg = configs(wavenet=overrides("mulaw-quantize"))
    kw = dict(batch_size=2, seed=3, batches_per_group=2)
    jit = iter(JD.WaveNetBatcher(dirs, jcfg, **kw))
    pit = iter(PD.WaveNetBatcher(dirs, pcfg, **kw))
    for _ in range(3):
        pb = next(pit)
        assert_host_batches_equal(pb, next(jit))
        assert np.array_equal(pb.input_wav, np.round(pb.input_wav))


@pytest.mark.parametrize("n_dirs", [1, 2])
def test_device_store_crops_equal_jax_and_the_host_path(corpora, tmp_path,
                                                        n_dirs):
    """device_store=True on CPU tensors: every batch equal to JAX's
    device-store batch exactly (the same f16 store), and to the port's
    host path (the same seed) exactly in audio and speaker ids and within
    f16 in mel (atol 4e-3, rtol 2e-3, as tests/test_data.py), with
    batch_to_device's keys and dtypes; store_bytes as JAX's."""
    dirs = corpus_dirs(corpora, tmp_path, n_dirs, True)
    jcfg, pcfg = configs()
    kw = dict(batch_size=4, gc_enable=n_dirs > 1, seed=11,
              batches_per_group=2)
    j = JD.WaveNetBatcher(dirs, jcfg, device_store=True, **kw)
    p = PD.WaveNetBatcher(dirs, pcfg, device_store=True, device="cpu", **kw)
    host = PD.WaveNetBatcher(dirs, pcfg, **kw)
    # JAX stores speaker ids as int32, the port as int64
    assert p.store_bytes == j.store_bytes + 4 * len(p.store_frames)
    jit, pit, hit = iter(j), iter(p), iter(host)
    for _ in range(6):
        pb, jb, hb = next(pit), next(jit), next(hit)
        assert {k: (v.dtype, v.device.type) for k, v in pb.items()} == {
            "input_wav": (torch.float32, "cpu"),
            "local_condition": (torch.float32, "cpu"),
            "speaker_id": (torch.int64, "cpu")}
        for k in pb:
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(pb["input_wav"].numpy(), hb.input_wav)
        np.testing.assert_array_equal(pb["speaker_id"].numpy(),
                                      hb.speaker_id)
        np.testing.assert_allclose(pb["local_condition"].numpy(),
                                   hb.local_condition, atol=F16_ATOL,
                                   rtol=F16_RTOL)


# ---------------------------------------------------------------------------
# DevicePrefetcher
# ---------------------------------------------------------------------------

def test_prefetcher_keeps_the_batchers_order(corpora, tmp_path):
    """Host batches through the prefetcher (CPU): tensors with
    batch_to_device's keys, in the batcher's order; device-store batches
    pass through as they are; stop ends the thread."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
        batch_to_device)
    dirs = corpus_dirs(corpora, tmp_path, 2, True)
    pcfg = configs()[1]
    kw = dict(batch_size=2, gc_enable=True, seed=4, batches_per_group=2)
    want = iter(PD.WaveNetBatcher(dirs, pcfg, **kw))
    feeder = PD.DevicePrefetcher(PD.WaveNetBatcher(dirs, pcfg, **kw),
                                 device="cpu")
    try:
        for _ in range(7):
            got, ref = next(feeder), batch_to_device(next(want), "cpu")
            assert got.keys() == ref.keys()
            for k in ref:
                assert got[k].dtype == ref[k].dtype
                assert torch.equal(got[k], ref[k]), k
        assert feeder.pinned_batches == 0
    finally:
        feeder.stop()
    assert not feeder._thread.is_alive()

    store = PD.WaveNetBatcher(dirs, pcfg, device_store=True, device="cpu",
                              **kw)
    first = next(iter(PD.WaveNetBatcher(dirs, pcfg, device_store=True,
                                        device="cpu", **kw)))
    seen = []
    feeder = PD.DevicePrefetcher(store, put_fn=lambda b: seen.append(b),
                                 device="cpu")
    try:
        got = next(feeder)
    finally:
        feeder.stop()
    assert not seen and all(torch.equal(got[k], first[k]) for k in first)


def test_prefetcher_raises_the_producers_error_and_stops():
    """An error raised by the batcher after two batches reaches the
    consumer after those two; stop() on a blocked producer (buffer full)
    returns and ends its thread."""
    def failing():
        for i in range(2):
            yield {"input_wav": np.full((1, 4, 1), i, np.float32),
                   "local_condition": np.zeros((1, 1, 2), np.float32)}
        raise OSError("disk gone")

    feeder = PD.DevicePrefetcher(failing(), device="cpu")
    assert [float(next(feeder)["input_wav"][0, 0, 0]) for _ in range(2)] == [
        0.0, 1.0]
    with pytest.raises(OSError, match="disk gone"):
        next(feeder)
    feeder.stop()

    produced = threading.Event()

    def endless():
        while True:
            produced.set()
            yield {"input_wav": np.zeros((1, 4, 1), np.float32),
                   "local_condition": np.zeros((1, 1, 2), np.float32)}

    feeder = PD.DevicePrefetcher(endless(), buffer_size=1, device="cpu")
    assert produced.wait(10)
    feeder.stop()
    assert not feeder._thread.is_alive()
    assert feeder._queue.empty()


def test_device_store_and_prefetcher_refuse_to_run_on_cpu_silently(
        corpora, tmp_path, monkeypatch):
    dirs = corpus_dirs(corpora, tmp_path, 1, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        PD.WaveNetBatcher(dirs, PC.Config(), device_store=True)
    with pytest.raises(RuntimeError, match="no CUDA"):
        PD.DevicePrefetcher(iter([]))
