"""Configuration for the vocoder serving path: the audio and WaveNet groups
of ``params.json``.

A copy of what this slice needs from the JAX package's ``config.py``
(``AudioConfig``, ``WaveNetConfig`` with ``receptive_field``, ``from_dict``,
``load_config``), so the port reads the same run-dir contract without
importing the JAX package.  Unknown keys and the other groups
(``tacotron``, ``train``) are ignored.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tarfile
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """The audio parameters generation reads (sample rate, hop, mel
    normalisation for silence padding)."""

    sample_rate: int = 24000
    hop_size: int = 300
    num_mels: int = 80
    symmetric_mels: bool = True
    max_abs_value: float = 4.0


@dataclass(frozen=True)
class WaveNetConfig:
    """WaveNet vocoder hyperparameters (the JAX ``WaveNetConfig``'s
    architecture fields; training-only fields are dropped)."""

    input_type: str = "raw"           # 'raw' | 'mulaw' | 'mulaw-quantize'
    scalar_input: bool = True

    filter_width: int = 2
    initial_filter_width: int = 32
    dilations: Tuple[int, ...] = tuple([1, 2, 4, 8, 16, 32, 64, 128, 256, 512] * 5)
    residual_channels: int = 32
    dilation_channels: int = 32
    quantization_channels: int = 256
    out_channels: int = 30
    skip_channels: int = 512
    use_biases: bool = True

    gc_channels: int = 32
    num_speakers: int = 1
    local_condition_channels: int = 80
    upsample_factor: Tuple[int, ...] = (5, 5, 12)

    weight_normalization: bool = False

    @property
    def receptive_field(self) -> int:
        """Samples of context needed for one output sample:
        (fw-1)*sum(dilations)+1 plus the front causal conv's context."""
        rf = (self.filter_width - 1) * sum(self.dilations) + 1
        if self.scalar_input:
            rf += self.initial_filter_width - 1
        else:
            rf += self.filter_width - 1
        return rf


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    wavenet: WaveNetConfig = field(default_factory=WaveNetConfig)

    def __post_init__(self):
        w = self.wavenet
        if math.prod(w.upsample_factor) != self.audio.hop_size:
            raise ValueError(
                f"prod(upsample_factor)={math.prod(w.upsample_factor)} must "
                f"equal hop_size={self.audio.hop_size}")
        if w.scalar_input and w.out_channels % 3 != 0:
            raise ValueError("out_channels must be a multiple of 3 for MoL")
        if (w.input_type in ("raw", "mulaw")) != w.scalar_input:
            raise ValueError(
                f"input_type={w.input_type!r} disagrees with "
                f"scalar_input={w.scalar_input}")


def _coerce(dc_cls, data: Dict[str, Any]):
    """Build a dataclass from a dict, ignoring unknown keys and turning
    lists back into tuples."""
    names = {f.name for f in dataclasses.fields(dc_cls)}
    return dc_cls(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in data.items() if k in names})


def from_dict(data: Dict[str, Any]) -> Config:
    return Config(audio=_coerce(AudioConfig, data.get("audio", {})),
                  wavenet=_coerce(WaveNetConfig, data.get("wavenet", {})))


def load_config(path: str) -> Config:
    """Read a config from a ``params.json`` file, a run dir holding one, or
    a ``*.ckpt.tar.gz`` checkpoint tarball holding one."""
    if os.path.isdir(path):
        path = os.path.join(path, "params.json")
    if path.endswith((".tar.gz", ".tgz", ".tar")):
        return from_dict(read_params_from_tarball(path))
    with open(path, encoding="utf-8") as f:
        return from_dict(json.load(f))


def read_params_from_tarball(path: str) -> Dict[str, Any]:
    """The ``params.json`` dict inside a checkpoint tarball, read with
    ``tarfile`` alone (the Orbax arrays beside it are not touched)."""
    with tarfile.open(path, "r:*") as tar:
        for member in tar:
            if os.path.basename(member.name) == "params.json":
                f = tar.extractfile(member)
                if f is None:
                    break
                return json.loads(f.read().decode("utf-8"))
    raise FileNotFoundError(f"no params.json in {path}")
