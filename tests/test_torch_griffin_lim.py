"""PyTorch port: the synthesis half of ``dsp/stft.py`` (``istft``,
``inv_preemphasis``, ``db_to_amp``, ``mel_to_linear``,
``linear_spectrogram``), ``dsp/griffin_lim.py`` and the PNG writer of
``utils/plot.py`` against the JAX package's, on committed wavs and mels and
numpy-seeded signals.  Griffin-Lim's initial phase is JAX's own draw,
injected through ``initial_phase`` (or ``phase=``), so both sides start
from the same uniforms.  Tolerances are stated per test (float32 on a CPU
on both sides)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron_wavenet_vocoder_korean_tpu import dsp as JD
from tacotron_wavenet_vocoder_korean_tpu.config import AudioConfig as JAudio
from tacotron_wavenet_vocoder_korean_tpu_torch.config import (
    AudioConfig as PAudio)
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp import griffin_lim as PG
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp import stft as PS
from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import load_wav
from tacotron_wavenet_vocoder_korean_tpu_torch.utils import plot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GL_WAV = os.path.join(REPO, "samples", "both_r2", "0.wav")
WN_WAV = os.path.join(REPO, "samples", "e2e_both_r2_wn_moon",
                      "0.wavenet.wav")
E2E_MEL = os.path.join(REPO, "samples", "e2e_both_r2_wn_moon", "0.mel.npy")
JA, PA = JAudio(), PAudio()


def jax_phase(shape, seed, device):
    """The initial phase JAX's griffin_lim draws for ``seed``."""
    return torch.from_numpy(np.asarray(jax.random.uniform(
        jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
        maxval=2 * jnp.pi))).to(device)


@pytest.fixture
def same_phase(monkeypatch):
    monkeypatch.setattr(PG, "initial_phase", jax_phase)


@pytest.fixture(scope="module")
def gl_magnitude():
    """Griffin-Lim's input as the JAX synthesizer makes it, from the linear
    spectrogram of a committed Griffin-Lim wav (1,025 x 174)."""
    lin = JD.linear_spectrogram(jnp.asarray(load_wav(GL_WAV, 24000)), JA)
    return np.asarray(JD.db_to_amp(JD.denormalize(lin, JA)
                                   + JA.ref_level_db) ** JA.power)


@pytest.mark.parametrize("length", [None, 20_000])
def test_istft_matches_jax(length):
    """<= 1e-5 (observed ~2e-7): the overlap-add by fold, divided by the
    overlap-added squared window, against JAX's scatter-adds."""
    x = load_wav(GL_WAV, 24000)
    spec = np.asarray(JD.stft(jnp.asarray(x), JA))
    want = np.asarray(JD.istft(jnp.asarray(spec), JA, length))
    got = PS.istft(torch.from_numpy(spec), PA, length).numpy()
    assert got.shape == want.shape == ((length or 300 * (spec.shape[1] - 1)),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got[1000:-1000] - x[1000:len(got) - 1000]).max() < 1e-5


@pytest.mark.parametrize("k,enabled", [(0.97, True), (0.5, True),
                                       (0.97, False)])
def test_inv_preemphasis_matches_jax(k, enabled):
    """104,400 samples: <= 1e-5 x the peak (observed ~6e-7 x); and it
    inverts ``preemphasis``."""
    x = np.random.default_rng(0).uniform(-0.5, 0.5, 104_400).astype(
        np.float32)
    want = np.asarray(JD.inv_preemphasis(jnp.asarray(x), k, enabled))
    got = PS.inv_preemphasis(torch.from_numpy(x), k, enabled).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    back = PS.preemphasis(torch.from_numpy(got), k, enabled).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5)


def test_db_to_amp_and_mel_to_linear_match_jax():
    """The committed mel's amplitudes and their pseudo-inverse: <= 1e-5
    (observed ~2e-6 on values up to ~12); the same pseudo-inverse
    (numpy on both sides) exactly."""
    mel = np.load(E2E_MEL).T.astype(np.float32)
    amp_j = JD.db_to_amp(JD.denormalize(jnp.asarray(mel), JA)
                         + JA.ref_level_db)
    amp_p = PS.db_to_amp(PS.denormalize(torch.from_numpy(mel), PA)
                         + PA.ref_level_db)
    np.testing.assert_allclose(amp_p.numpy(), np.asarray(amp_j), rtol=0,
                               atol=1e-5)
    from tacotron_wavenet_vocoder_korean_tpu.dsp.stft import inv_mel_basis
    np.testing.assert_array_equal(PS.inv_mel_basis(24000, 2048, 80),
                                  inv_mel_basis(24000, 2048, 80))
    want = np.asarray(JD.mel_to_linear(amp_j, JA))
    got = PS.mel_to_linear(amp_p, PA).numpy()
    assert got.shape == want.shape == (1025, mel.shape[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got.min() >= 1e-10


@pytest.mark.parametrize("source", ["noise", "griffin_lim", "wavenet"])
def test_linear_spectrogram_matches_jax(source):
    """The normalized dB linear spectrogram.  Bins far below the others
    (near the -100 dB floor, or a noise spectrum's near-zeros) carry the
    float32 FFT's rounding through the log, so both float32 programs part
    from the float64 result there (up to ~2e-3): the port stays within
    twice JAX's own distance from it, and its mean distance from JAX's is
    at most 1e-5 (observed 2e-7 to 1.1e-6)."""
    x = {"noise": np.random.default_rng(1).uniform(-0.5, 0.5, 24_000),
         "griffin_lim": load_wav(GL_WAV, 24000),
         "wavenet": load_wav(WN_WAV, 24000)}[source].astype(np.float32)
    want = np.asarray(JD.linear_spectrogram(jnp.asarray(x), JA))
    got = PS.linear_spectrogram(torch.from_numpy(x), PA).numpy()
    exact = PS.linear_spectrogram(torch.from_numpy(x.astype(np.float64)),
                                  PA).numpy()
    assert got.shape == want.shape == (1025, 1 + len(x) // 300)
    assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max()
    assert np.abs(got - want).mean() <= 1e-5


@pytest.mark.parametrize("n_iters", [0, 1, 5, 60])
def test_griffin_lim_matches_jax(gl_magnitude, same_phase, n_iters):
    """The same initial phase on both sides: <= 1e-4 (observed 4e-8 at 0
    iterations, 1.3e-6 at 60; the wav's peak is ~0.45)."""
    want = np.asarray(JD.griffin_lim(jnp.asarray(gl_magnitude), JA,
                                     n_iters=n_iters))
    got = PG.griffin_lim(torch.from_numpy(gl_magnitude), PA,
                         n_iters=n_iters).numpy()
    assert got.shape == want.shape == (300 * 173,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_griffin_lim_takes_the_phase_or_draws_it(gl_magnitude):
    """``phase=`` is used as given; without it the phase comes from
    ``initial_phase``: uniform in [0, 2 pi), float32, the same for the
    same seed."""
    mag = torch.from_numpy(gl_magnitude)
    phase = jax_phase(mag.shape, 3, "cpu")
    a = PG.griffin_lim(mag, PA, n_iters=2, phase=phase)
    b = np.asarray(JD.griffin_lim(jnp.asarray(gl_magnitude), JA, n_iters=2,
                                  seed=3))
    np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4)
    p = PG.initial_phase((1025, 50), 7, torch.device("cpu"))
    assert p.dtype == torch.float32 and p.shape == (1025, 50)
    assert 0 <= float(p.min()) and float(p.max()) < 2 * np.pi
    assert abs(float(p.mean()) - np.pi) < 0.05
    assert torch.equal(p, PG.initial_phase((1025, 50), 7, torch.device(
        "cpu")))
    assert not torch.equal(p, PG.initial_phase((1025, 50), 8,
                                               torch.device("cpu")))
    np.testing.assert_array_equal(
        PG.griffin_lim(mag, PA, n_iters=2, seed=7).numpy(),
        PG.griffin_lim(mag, PA, n_iters=2,
                       phase=PG.initial_phase(mag.shape, 7,
                                              torch.device("cpu"))).numpy())


def test_inv_mel_spectrogram_of_the_committed_mel_matches_jax(same_phase):
    """samples/e2e_both_r2_wn_moon/0.mel.npy through the pseudo-inverse,
    60 iterations and the inverse pre-emphasis: <= 1e-4 (observed ~6e-6;
    the wav's peak is ~2.3: Griffin-Lim's output is not normalised)."""
    mel = np.load(E2E_MEL).T.astype(np.float32)
    want = np.asarray(JD.inv_mel_spectrogram(jnp.asarray(mel), JA))
    got = PG.inv_mel_spectrogram(torch.from_numpy(mel), PA).numpy()
    assert got.shape == want.shape == (300 * (mel.shape[1] - 1),)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_inv_linear_spectrogram_casts_bf16_up_and_matches_jax(same_phase):
    """A bf16 linear spectrogram is cast to float32 first (JAX's
    ``astype(complex64)``): the same wav as its float32 values, exactly,
    and <= 1e-4 of JAX's on those values."""
    rng = np.random.default_rng(2)
    lin = np.clip(rng.normal(-1.5, 1.2, (1025, 100)), -4, 4)
    lin16 = torch.from_numpy(lin).to(torch.bfloat16)
    lin32 = lin16.float()
    got = PG.inv_linear_spectrogram(lin16, PA)
    assert got.dtype == torch.float32
    assert torch.equal(got, PG.inv_linear_spectrogram(lin32, PA))
    want = np.asarray(JD.inv_linear_spectrogram(jnp.asarray(lin32.numpy()),
                                                JA))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# PNG writer: read back by matplotlib where the tests run (the serving
# machine has none, which is why the port writes its own)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(45, 200), (7, 3), (900, 1500)])
def test_alignment_png_reads_back_in_matplotlib(tmp_path, shape):
    """Size ``image_size``, each cell a block of one colour, row 0 at the
    bottom, the minimum viridis' first colour and the maximum its last
    (within 4/255 of matplotlib's table)."""
    import matplotlib
    from matplotlib import image
    values = np.random.default_rng(3).uniform(size=shape)
    values[0, 0], values[-1, -1] = -1.0, 2.0
    path = str(tmp_path / "a.png")
    plot.plot_alignment(values, path)
    with open(path, "rb") as f:
        assert f.read(8) == plot.PNG_SIGNATURE
    img = image.imread(path)
    height, width = plot.image_size(*shape)
    assert img.shape == (height, width, 3)
    assert height % shape[0] == 0 and width % shape[1] == 0
    sy, sx = height // shape[0], width // shape[1]
    viridis = matplotlib.colormaps["viridis"]
    np.testing.assert_allclose(img[-1, 0], viridis(0)[:3], atol=4 / 255)
    np.testing.assert_allclose(img[0, -1], viridis(255)[:3], atol=4 / 255)
    row = shape[0] - 1 - shape[0] // 2        # a data row, from the top
    cell = img[row * sy:(row + 1) * sy, :sx]
    assert (cell == cell[0, 0]).all()
    level = (values[shape[0] // 2, 0] + 1.0) / 3.0
    np.testing.assert_allclose(cell[0, 0], viridis(level)[:3],
                               atol=6 / 255)


def test_spectrogram_png_puts_bins_upwards(tmp_path):
    from matplotlib import image
    spec = np.zeros((30, 80))                # [frames, bins]
    spec[:, -1] = 1.0                        # the top bin
    path = str(tmp_path / "s.png")
    plot.plot_spectrogram(spec, path)
    img = image.imread(path)
    assert img.shape[:2] == plot.image_size(80, 30)
    np.testing.assert_array_equal(img[0], img[0, :1].repeat(len(img[0]), 0))
    assert not np.array_equal(img[0, 0], img[-1, 0])
    np.testing.assert_array_equal(plot.colour_table()[255],
                                  np.rint(img[0, 0] * 255))


def test_dsp_package_exports_and_keeps_its_module_names():
    """``dsp`` re-exports the JAX package's names for what is ported, but
    ``stft``, ``griffin_lim`` and ``mulaw`` stay the modules (the tests
    import them as modules)."""
    import types

    from tacotron_wavenet_vocoder_korean_tpu_torch import dsp
    for name in ("stft", "griffin_lim", "mulaw"):
        assert isinstance(getattr(dsp, name), types.ModuleType), name
    assert dsp.istft is PS.istft
    assert dsp.inv_mel_spectrogram is PG.inv_mel_spectrogram
    assert set(dsp.__all__) <= set(JD.__all__)
