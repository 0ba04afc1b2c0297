"""The JAX package's ``dsp/stft.py`` in plain PyTorch (numpy for the
constant window, filterbank and its pseudo-inverse): waveform ->
normalized mel or linear spectrogram, and back (``istft``,
``inv_preemphasis``, ``mel_to_linear``) for Griffin-Lim.

librosa's conventions, as the reference uses them: a periodic Hann window
of ``win_size`` centred in ``fft_size``, ``center=True`` reflect padding,
the Slaney mel filterbank (fmin 0, fmax sr/2), amplitude to dB with a
``min_level_db`` floor, the ``ref_level_db`` shift and the symmetric
[-max_abs_value, max_abs_value] normalisation.  Computed in the input's
floating type (float32 as the JAX functions compute).
``extract_features`` is the preprocessing entry point: both spectrograms
of a wav from one STFT.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import AudioConfig
from ..device import no_tf32, resolve_device


@functools.lru_cache(maxsize=8)
def hann_window(win_size: int, fft_size: int) -> np.ndarray:
    """Periodic Hann of length ``win_size``, zero-padded to ``fft_size``
    around its centre (librosa's ``util.pad_center``)."""
    n = np.arange(win_size)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_size)
    lpad = (fft_size - win_size) // 2
    out = np.zeros(fft_size, dtype=np.float32)
    out[lpad:lpad + win_size] = w
    return out


def _hz_to_mel(f):
    """Slaney's mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp
                    + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=8)
def mel_basis(sample_rate: int, fft_size: int, num_mels: int,
              fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney mel filterbank [num_mels, fft_size // 2 + 1]
    (``librosa.filters.mel`` with htk=False, norm='slaney')."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freq = fft_size // 2 + 1
    fftfreqs = np.linspace(0, sample_rate / 2.0, n_freq)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                    num_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    weights = np.zeros((num_mels, n_freq), dtype=np.float64)
    for i in range(num_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    # Slaney normalisation: each filter integrates to about the same area.
    weights *= (2.0 / (hz_pts[2:num_mels + 2] - hz_pts[:num_mels]))[:, None]
    return weights.astype(np.float32)


def preemphasis(wav: torch.Tensor, k: float, enabled: bool = True
                ) -> torch.Tensor:
    """y[t] = x[t] - k x[t-1]."""
    if not enabled:
        return wav
    return torch.cat([wav[:1], wav[1:] - k * wav[:-1]])


def inv_preemphasis(wav: torch.Tensor, k: float, enabled: bool = True
                    ) -> torch.Tensor:
    """The IIR filter y[t] = x[t] + k y[t-1] over the last dim, as a
    log-depth scan (the JAX function's ``associative_scan``): after the
    step of shift s each sample holds the sum over its last 2s inputs,
    y[t] += k^s y[t-s], so ceil(log2 T) elementwise steps stay on the
    device."""
    if not enabled:
        return wav
    y = wav.clone()
    s = 1
    while s < y.shape[-1]:
        y[..., s:] += (k ** s) * y[..., :-s]
        s *= 2
    return y


def _frame(y: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[T] -> [num_frames, frame_length]."""
    return y.unfold(-1, frame_length, hop)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """[T] -> [T + 2 pad], reflected at both ends as ``jnp.pad(...,
    mode="reflect")`` pads: a pad as long as the signal or longer (a few
    frames' Griffin-Lim) reflects again, where ``F.pad`` refuses it."""
    n = y.shape[-1]
    if pad < n:
        return torch.nn.functional.pad(y[None, None], (pad, pad),
                                       mode="reflect")[0, 0]
    period = max(2 * (n - 1), 1)
    idx = torch.arange(-pad, n + pad, device=y.device).abs() % period
    return y[torch.where(idx >= n, period - idx, idx)]


def stft(y: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Complex STFT [num_freq, num_frames], with ``fft_size // 2`` reflect
    padding on both sides."""
    y = reflect_pad(y, cfg.fft_size // 2)
    frames = _frame(y, cfg.fft_size, cfg.hop_size)
    win = torch.from_numpy(hann_window(cfg.win_size, cfg.fft_size)).to(
        y.device, y.dtype)
    return torch.fft.rfft(frames * win, dim=-1).T


@functools.lru_cache(maxsize=16)
def _window_sum(win_size: int, fft_size: int, hop: int, num_frames: int,
                device: torch.device) -> torch.Tensor:
    """The overlap-added squared window of ``num_frames`` frames, clamped
    to 1e-8: ``istft``'s divisor, which depends on the frame count only."""
    win2 = hann_window(win_size, fft_size).astype(np.float64) ** 2
    total = fft_size + hop * (num_frames - 1)
    out = np.zeros(total)
    for i in range(num_frames):
        out[i * hop:i * hop + fft_size] += win2
    return torch.from_numpy(np.maximum(out, 1e-8).astype(np.float32)).to(
        device)


def istft(spec: torch.Tensor, cfg: AudioConfig,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse of ``stft`` (librosa's ``istft``, ``center=True``): irfft of
    each frame, the window, overlap-add divided by the overlap-added
    squared window, and the ``fft_size // 2`` padding cut from both ends.
    ``fft_size`` need not be a multiple of ``hop_size``: the overlap-add is
    ``fold`` (col2im), whose sums are taken in the same order each run."""
    fft, hop = cfg.fft_size, cfg.hop_size
    win = torch.from_numpy(hann_window(cfg.win_size, fft)).to(spec.device)
    frames = torch.fft.irfft(spec.T, n=fft, dim=-1) * win       # [F, fft]
    num_frames = frames.shape[0]
    total = fft + hop * (num_frames - 1)
    y = torch.nn.functional.fold(frames.T[None], (1, total), (1, fft),
                                 stride=(1, hop)).reshape(total)
    y = y / _window_sum(cfg.win_size, fft, hop, num_frames, spec.device)
    y = y[fft // 2:total - fft // 2]
    return y if length is None else y[:length]


def amp_to_db(x: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    min_level = float(np.exp(cfg.min_level_db / 20 * np.log(10)))
    return 20.0 * torch.log10(torch.clamp(x, min=min_level))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize(S: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """dB spectrogram -> [-max_abs_value, max_abs_value] (symmetric) or
    [0, max_abs_value], clipped when the config says so."""
    if not cfg.signal_normalization:
        return S
    span = -cfg.min_level_db
    m = cfg.max_abs_value
    if cfg.symmetric_mels:
        out = (2 * m) * ((S - cfg.min_level_db) / span) - m
        lo = -m
    else:
        out = m * ((S - cfg.min_level_db) / span)
        lo = 0.0
    if cfg.allow_clipping_in_normalization:
        out = torch.clamp(out, lo, m)
    return out


def denormalize(D: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    if not cfg.signal_normalization:
        return D
    span = -cfg.min_level_db
    m = cfg.max_abs_value
    if cfg.symmetric_mels:
        if cfg.allow_clipping_in_normalization:
            D = torch.clamp(D, -m, m)
        return (D + m) * span / (2 * m) + cfg.min_level_db
    if cfg.allow_clipping_in_normalization:
        D = torch.clamp(D, 0, m)
    return D * span / m + cfg.min_level_db


def mel_spectrogram(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """wav [T] -> normalized mel spectrogram [num_mels, frames]."""
    D = stft(preemphasis(wav, cfg.preemphasis, cfg.preemphasize), cfg)
    basis = torch.from_numpy(mel_basis(cfg.sample_rate, cfg.fft_size,
                                       cfg.num_mels)).to(wav.device, wav.dtype)
    S = amp_to_db(basis @ D.abs(), cfg) - cfg.ref_level_db
    return normalize(S, cfg)


def linear_spectrogram(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """wav [T] -> normalized linear spectrogram [num_freq, frames]."""
    D = stft(preemphasis(wav, cfg.preemphasis, cfg.preemphasize), cfg)
    return normalize(amp_to_db(D.abs(), cfg) - cfg.ref_level_db, cfg)


def extract_features(wav: np.ndarray, cfg: AudioConfig,
                     device: Union[str, torch.device, None] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """wav -> (mel [num_mels, frames], linear [num_freq, frames]) as
    float32 numpy, computed on ``device`` (``cuda`` unless the caller asks
    for another) from one STFT: pre-emphasis, the reflect pad, ``rfft``
    and one magnitude shared by both, each then through the dB, reference
    level and normalisation chain.  The same numbers as
    ``mel_spectrogram`` and ``linear_spectrogram``.  The JAX function
    zero-extends the signal to a 128-frame bucket for XLA's compile cache;
    no frame it keeps reads the extension, and nothing here compiles per
    shape, so the port does not pad."""
    dev = resolve_device(device)
    y = torch.from_numpy(np.asarray(wav, dtype=np.float32)).to(dev)
    with no_tf32():
        mag = stft(preemphasis(y, cfg.preemphasis, cfg.preemphasize),
                   cfg).abs()
        basis = torch.from_numpy(mel_basis(cfg.sample_rate, cfg.fft_size,
                                           cfg.num_mels)).to(dev)
        mel = normalize(amp_to_db(basis @ mag, cfg) - cfg.ref_level_db, cfg)
        lin = normalize(amp_to_db(mag, cfg) - cfg.ref_level_db, cfg)
    return mel.cpu().numpy(), lin.cpu().numpy()


@functools.lru_cache(maxsize=8)
def inv_mel_basis(sample_rate: int, fft_size: int, num_mels: int
                  ) -> np.ndarray:
    return np.linalg.pinv(
        mel_basis(sample_rate, fft_size, num_mels)).astype(np.float32)


def mel_to_linear(mel: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Mel amplitudes [num_mels, frames] -> approximate linear amplitudes
    [num_freq, frames] through the filterbank's pseudo-inverse, floored at
    1e-10."""
    inv = torch.from_numpy(inv_mel_basis(cfg.sample_rate, cfg.fft_size,
                                         cfg.num_mels)).to(mel.device,
                                                           mel.dtype)
    return torch.clamp(inv @ mel, min=1e-10)
