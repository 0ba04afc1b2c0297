"""Wav load/save with scipy (counterpart of the JAX package's
``dsp/audio_io.py`` ``load_wav`` and ``save_wav``)."""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, sr: int) -> np.ndarray:
    """Load a wav as float32 mono in [-1, 1], resampled to ``sr``."""
    file_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if file_sr != sr:
        g = np.gcd(int(file_sr), int(sr))
        wav = resample_poly(wav, sr // g, file_sr // g).astype(np.float32)
    return wav


def save_wav(wav: np.ndarray, path: str, sr: int) -> None:
    """Peak-normalize to int16 and write."""
    wav = np.asarray(wav, dtype=np.float32)
    wav = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(path, sr, wav.astype(np.int16))
