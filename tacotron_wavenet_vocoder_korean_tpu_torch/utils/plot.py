"""Alignment and spectrogram heatmaps as PNG files (counterpart of the JAX
package's ``utils/plot.py``), written by a small encoder of its own
(``zlib``, ``struct``, ``binascii.crc32``): the serving machine has no
matplotlib.

Each cell becomes a block of pixels (integer upscaling towards a
1200 x 800 image), coloured through a 256-entry viridis table (the
default colour map of matplotlib's ``imshow``) between the data's minimum
and maximum, origin at the bottom.  The one difference from the JAX
package's figures: there are no axes, colour bar, title or jamo tick
labels, since without matplotlib there is no font renderer.
"""
from __future__ import annotations

import binascii
import functools
import struct
import zlib
from typing import Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
TARGET_WIDTH, TARGET_HEIGHT = 1200, 800

# Viridis as a degree-6 polynomial per channel, coefficients of t^0..t^6
# (within 4/255 of matplotlib's table).
_VIRIDIS = np.array([
    [0.2777273272234177, 0.005407344544966578, 0.3340998053353061],
    [0.1050930431085774, 1.404613529898575, 1.384590162594685],
    [-0.3308618287255563, 0.214847559468213, 0.09509516302823659],
    [-4.634230498983486, -5.799100973351585, -19.33244095627987],
    [6.228269936347019, 14.17993336680509, 56.69055260068105],
    [4.776384997670288, -13.74514537774601, -65.35303263337234],
    [-5.435455855934631, 4.645852612178535, 26.3124352495832]])


@functools.cache
def colour_table() -> np.ndarray:
    """[256, 3] uint8 viridis."""
    t = np.linspace(0.0, 1.0, 256)[:, None] ** np.arange(7)
    return np.clip(np.rint(255 * t @ _VIRIDIS), 0, 255).astype(np.uint8)


def image_size(rows: int, cols: int) -> Tuple[int, int]:
    """(height, width) in pixels of a [rows, cols] heatmap: each cell an
    integer block, the image as near 1200 x 800 as that allows."""
    return (rows * max(1, TARGET_HEIGHT // rows),
            cols * max(1, TARGET_WIDTH // cols))


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", binascii.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """[height, width, 3] uint8 -> an 8-bit RGB PNG (no filtering)."""
    height, width, _ = rgb.shape
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           rgb.reshape(height, width * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def heatmap(values: np.ndarray, path: str) -> None:
    """[rows, cols] values -> PNG, row 0 at the bottom."""
    v = np.asarray(values, np.float64)
    lo, hi = float(v.min()), float(v.max())
    scaled = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    idx = np.rint(scaled * 255).astype(np.intp)[::-1]
    height, width = image_size(*v.shape)
    idx = np.repeat(np.repeat(idx, height // v.shape[0], axis=0),
                    width // v.shape[1], axis=1)
    write_png(path, colour_table()[idx])


def plot_alignment(alignment: np.ndarray, path: str) -> None:
    """``alignment`` [encoder steps, decoder steps] -> PNG (encoder steps
    upwards); the caller cuts the padding off."""
    heatmap(alignment, path)


def plot_spectrogram(spec: np.ndarray, path: str) -> None:
    """[frames, bins] spectrogram -> PNG, bins upwards."""
    heatmap(np.asarray(spec).T, path)
