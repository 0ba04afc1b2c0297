"""Host-side audio: wav load/save with scipy, peak rescaling and silence
trimming (counterpart of the JAX package's ``dsp/audio_io.py``; numpy
there and here)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from ..config import AudioConfig


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


def rescale(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Scale the peak to ``rescaling_max`` when ``rescaling`` is set."""
    if cfg.rescaling:
        return wav / np.abs(wav).max() * cfg.rescaling_max
    return wav


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int
               ) -> np.ndarray:
    """Centred frame-wise RMS (librosa.feature.rms's convention)."""
    pad = frame_length // 2
    y = np.pad(y, (pad, pad), mode="constant")
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    frames = y[idx]
    return np.sqrt(np.mean(frames ** 2, axis=1))


def trim_silence(wav: np.ndarray, cfg: AudioConfig) -> np.ndarray:
    """Cut the leading and trailing frames more than ``trim_top_db`` below
    the loudest frame's RMS (librosa.effects.trim)."""
    if not cfg.trim_silence or len(wav) == 0:
        return wav
    rms = _frame_rms(wav, cfg.trim_fft_size, cfg.trim_hop_size)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(rms.max(), 1e-10))
    loud = np.flatnonzero(db > -cfg.trim_top_db)
    if len(loud) == 0:
        return wav[:0]
    start = int(loud[0]) * cfg.trim_hop_size
    end = min(len(wav), int(loud[-1] + 1) * cfg.trim_hop_size)
    return wav[start:end]


def start_and_end_indices(quantized: np.ndarray,
                          silence_threshold: int = 2) -> Tuple[int, int]:
    """The first and last index where |q - 127| exceeds the threshold: the
    silence crop of ``mulaw-quantize`` preprocessing."""
    above = np.flatnonzero(np.abs(quantized.astype(np.int64) - 127)
                           > silence_threshold)
    if len(above) == 0:
        return 0, len(quantized)
    return int(above[0]), int(above[-1])
