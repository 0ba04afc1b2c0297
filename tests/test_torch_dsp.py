"""PyTorch port: the mel analysis (``dsp/stft.py``, analysis half) and the
MCD / DTW metrics (``utils/metrics.py``) against the JAX package's, on
committed wavs and numpy-seeded signals.  Tolerances are stated per test
(float32 on a CPU on both sides)."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import dsp as JD
from tacotron_wavenet_vocoder_korean_tpu.config import AudioConfig as JAudio
from tacotron_wavenet_vocoder_korean_tpu.utils import metrics as JM
from tacotron_wavenet_vocoder_korean_tpu_torch.config import (
    AudioConfig as PAudio)
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp import stft as PS
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import load_wav
from tacotron_wavenet_vocoder_korean_tpu_torch.utils import metrics as PM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E = os.path.join(REPO, "samples", "e2e_both_r2_wn_moon")
WAVS = [os.path.join(E2E, "0.wavenet.wav"),
        os.path.join(REPO, "samples", "wn_moon_260k", "003.0026.wn.wav"),
        os.path.join(REPO, "samples", "wn_moon_260k",
                     "NB10584578.0018.wn.wav")]
GL_WAVS = [os.path.join(REPO, "samples", "both_r2", f"{i}.wav")
           for i in range(4)]

def wav(path):
    return load_wav(path, 24000)


def test_audio_config_fields_equal_jax():
    """The port's AudioConfig carries the JAX analysis fields with the
    same defaults."""
    port = dataclasses.asdict(PAudio())
    assert port == {k: getattr(JAudio(), k) for k in port}


@pytest.mark.parametrize("sizes", [(1200, 2048), (512, 512), (400, 1024)])
def test_hann_window_and_mel_basis_equal_jax(sizes):
    win, fft = sizes
    np.testing.assert_array_equal(PS.hann_window(win, fft),
                                  JD.hann_window(win, fft))
    np.testing.assert_array_equal(PS.mel_basis(24000, fft, 80),
                                  JD.mel_basis(24000, fft, 80))
    np.testing.assert_array_equal(PS.mel_basis(16000, fft, 40, 50.0, 7000.0),
                                  JD.mel_basis(16000, fft, 40, 50.0, 7000.0))


def test_preemphasis_and_stft_match_jax():
    """Pre-emphasis <= 1e-7; the complex STFT within 1e-5 of the largest
    bin (float32 FFTs of 2,048 points)."""
    x = np.random.default_rng(0).uniform(-0.5, 0.5, 7_000).astype(np.float32)
    a = JAudio()
    pre = PS.preemphasis(torch.from_numpy(x), a.preemphasis).numpy()
    np.testing.assert_allclose(
        pre, np.asarray(JD.preemphasis(jnp.asarray(x), a.preemphasis)),
        rtol=0, atol=1e-7)
    assert torch.equal(PS.preemphasis(torch.from_numpy(x), 0.97, False),
                       torch.from_numpy(x))
    got = PS.stft(torch.from_numpy(x), PAudio()).numpy()
    want = np.asarray(JD.stft(jnp.asarray(x), a))
    assert got.shape == want.shape == (1025, 1 + 7_000 // 300)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", [1, 2, 300, 900, 1024, 1025, 3000])
def test_stft_reflects_short_signals_as_jax(n):
    """Signals up to the pad's length (a Griffin-Lim of a few frames)
    reflect again, as ``jnp.pad`` does: within 1e-5 of the largest bin."""
    x = np.random.default_rng(n).uniform(-0.5, 0.5, n).astype(np.float32)
    got = PS.stft(torch.from_numpy(x), PAudio()).numpy()
    want = np.asarray(JD.stft(jnp.asarray(x), JAudio()))
    assert got.shape == want.shape == (1025, 1 + n // 300)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("path", WAVS, ids=lambda p: os.path.basename(p))
def test_mel_spectrogram_matches_jax_on_committed_wavs(path):
    """Normalized mel of a committed WaveNet wav: <= 1e-5 (observed
    1e-6 to 3e-6)."""
    x = wav(path)
    got = PS.mel_spectrogram(torch.from_numpy(x), PAudio()).numpy()
    want = np.asarray(JD.mel_spectrogram(jnp.asarray(x), JAudio()))
    assert got.shape == want.shape == (80, 1 + len(x) // 300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("path", GL_WAVS, ids=lambda p: os.path.basename(p))
def test_mel_spectrogram_float32_rounding_as_jax_on_griffin_lim_wavs(path):
    """On the Griffin-Lim renderings the lowest mel band sits near the
    -100 dB floor, where float32 FFT rounding shows through the log: both
    float32 programs part from the float64 mel by up to ~7e-5 there.  The
    port's float32 mel stays within twice JAX's own distance from it, and
    within 1e-4 of JAX's."""
    x = wav(path)
    got = PS.mel_spectrogram(torch.from_numpy(x), PAudio()).numpy()
    want = np.asarray(JD.mel_spectrogram(jnp.asarray(x), JAudio()))
    exact = PS.mel_spectrogram(torch.from_numpy(x.astype(np.float64)),
                               PAudio()).numpy()
    assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("change", [
    {}, {"symmetric_mels": False}, {"allow_clipping_in_normalization": False},
    {"signal_normalization": False},
    {"symmetric_mels": False, "allow_clipping_in_normalization": False}])
def test_normalize_and_denormalize_match_jax(change):
    S = np.random.default_rng(1).uniform(-130, 30, (80, 50)).astype(
        np.float32)
    p, j = PAudio(**change), JAudio(**change)
    norm = PS.normalize(torch.from_numpy(S), p).numpy()
    np.testing.assert_allclose(norm, np.asarray(JD.normalize(jnp.asarray(S),
                                                             j)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        PS.denormalize(torch.from_numpy(norm), p).numpy(),
        np.asarray(JD.denormalize(jnp.asarray(norm), j)), rtol=0, atol=1e-4)
    amp = np.abs(S) * 1e-3
    np.testing.assert_allclose(
        PS.amp_to_db(torch.from_numpy(amp), p).numpy(),
        np.asarray(JD.amp_to_db(jnp.asarray(amp), j)), rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(30, 13, 40), (57, 13, 21), (1, 3, 9),
                                   (12, 2, 12)])
def test_dtw_path_equals_jax(shape):
    """The anti-diagonal fill gives the JAX cell-by-cell path exactly, ties
    (small integer features) included."""
    nx, d, ny = shape
    rng = np.random.default_rng(nx)
    for x, y in ((rng.standard_normal((nx, d)), rng.standard_normal((ny, d))),
                 (rng.integers(0, 2, (nx, d)).astype(float),
                  rng.integers(0, 2, (ny, d)).astype(float))):
        got, want = PM.dtw_path(x, y), JM.dtw_path(x, y)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_mel_cepstra_match_jax():
    x = wav(WAVS[0])
    np.testing.assert_allclose(PM.mel_cepstra(x, PAudio()),
                               JM.mel_cepstra(x, JAudio()), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("use_dtw", [True, False])
def test_mcd_matches_jax_on_the_committed_e2e_wavs(use_dtw):
    """MCD of samples/e2e_both_r2_wn_moon/0.wavenet.wav to 0.wav (the same
    mel through Griffin-Lim): within 1e-3 dB of JAX's (observed ~1e-6)."""
    a, b = wav(os.path.join(E2E, "0.wavenet.wav")), wav(
        os.path.join(E2E, "0.wav"))
    got = PM.mcd(a, b, PAudio(), use_dtw=use_dtw)
    want = JM.mcd(a, b, JAudio(), use_dtw=use_dtw)
    assert abs(got - want) <= 1e-3
    assert got > 0 and PM.mcd(a, a, PAudio()) == 0.0
