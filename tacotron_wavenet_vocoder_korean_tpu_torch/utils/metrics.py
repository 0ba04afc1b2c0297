"""Quality metrics: mel-cepstral distortion (MCD) between two waveforms,
frames aligned by dynamic time warping (counterpart of the JAX package's
``utils/metrics.py``, on the port's mel analysis)."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import AudioConfig
from ..dsp.stft import denormalize, mel_spectrogram


def mel_cepstra(wav: np.ndarray, cfg: AudioConfig, n_mfcc: int = 13
                ) -> np.ndarray:
    """[T] -> [frames, n_mfcc] mel cepstra: the orthonormal DCT-II of the
    natural-log mel amplitudes, c0 dropped."""
    with torch.no_grad():
        mel = mel_spectrogram(torch.from_numpy(
            np.asarray(wav, np.float32).copy()), cfg)
        db = (denormalize(mel, cfg) + cfg.ref_level_db).numpy()
    logmel = db * (math.log(10) / 20.0)           # dB -> ln(amplitude)
    n = logmel.shape[0]
    k = np.arange(n_mfcc + 1)[:, None]
    i = np.arange(n)[None, :]
    basis = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * math.sqrt(2.0 / n)
    basis[0] /= math.sqrt(2.0)
    return (basis @ logmel).T[:, 1:]


def dtw_path(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """DTW over euclidean frame distances -> aligned index pairs.  The
    accumulated cost is filled one anti-diagonal at a time (each cell
    needs only the two diagonals before it), with the same sums as a cell
    by cell fill; the backtrack breaks ties as the JAX function does."""
    nx, ny = len(x), len(y)
    dist = np.linalg.norm(x[:, None, :] - y[None, :, :], axis=-1)
    acc = np.full((nx + 1, ny + 1), np.inf)
    acc[0, 0] = 0.0
    for d in range(2, nx + ny + 1):
        i = np.arange(max(1, d - ny), min(nx, d - 1) + 1)
        j = d - i
        acc[i, j] = dist[i - 1, j - 1] + np.minimum(
            np.minimum(acc[i - 1, j], acc[i, j - 1]), acc[i - 1, j - 1])
    ii, jj = nx, ny
    path_x, path_y = [], []
    while ii > 0 and jj > 0:
        path_x.append(ii - 1)
        path_y.append(jj - 1)
        _, ii, jj = min((acc[ii - 1, jj - 1], ii - 1, jj - 1),
                        (acc[ii - 1, jj], ii - 1, jj),
                        (acc[ii, jj - 1], ii, jj - 1))
    return np.asarray(path_x[::-1]), np.asarray(path_y[::-1])


def mcd(wav_a: np.ndarray, wav_b: np.ndarray, cfg: AudioConfig,
        use_dtw: bool = True, n_mfcc: int = 13) -> float:
    """Mel-cepstral distortion in dB between two waveforms (lower is
    closer): mean over frames of (10 / ln 10) sqrt(2 sum_k (a_k - b_k)^2)."""
    ca = mel_cepstra(wav_a, cfg, n_mfcc)
    cb = mel_cepstra(wav_b, cfg, n_mfcc)
    if use_dtw:
        ia, ib = dtw_path(ca, cb)
        ca, cb = ca[ia], cb[ib]
    else:
        n = min(len(ca), len(cb))
        ca, cb = ca[:n], cb[:n]
    frame_dist = np.sqrt(2.0 * np.sum((ca - cb) ** 2, axis=-1))
    return float((10.0 / math.log(10)) * frame_dist.mean())
