"""Configuration for the serving paths: the audio, Tacotron and WaveNet
groups of ``params.json``.

A copy of what the port needs from the JAX package's ``config.py``
(``AudioConfig``, ``TacotronConfig``, ``WaveNetConfig`` with
``receptive_field``, ``from_dict``, ``load_config``), so the port reads the
same run-dir contract without importing the JAX package.  Unknown keys and
the ``train`` group are ignored.  ``BOTH_R2`` is the Tacotron group of the
committed ``artifacts/both_r2.ckpt.tar.gz``, for machines that do not hold
the tarball.
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
    """The audio parameters serving, the mel analysis and Griffin-Lim read
    (sample rate, hop, window, mel and linear widths, pre-emphasis, the dB
    and normalisation chain, Griffin-Lim's iterations and power)."""

    sample_rate: int = 24000
    hop_size: int = 300
    fft_size: int = 2048
    win_size: int = 1200
    num_mels: int = 80

    preemphasize: bool = True
    preemphasis: float = 0.97
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    signal_normalization: bool = True
    allow_clipping_in_normalization: bool = True
    symmetric_mels: bool = True
    max_abs_value: float = 4.0

    griffin_lim_iters: int = 60
    power: float = 1.5

    @property
    def num_freq(self) -> int:
        return self.fft_size // 2 + 1


@dataclass(frozen=True)
class TacotronConfig:
    """Tacotron-1 hyperparameters: the JAX ``TacotronConfig``'s fields and
    defaults, training fields included, so a ``params.json`` group reads
    the same in both packages."""

    cleaners: str = "korean_cleaners"

    # multi-speaker conditioning: 'single' | 'simple' | 'deepvoice'
    model_type: str = "deepvoice"
    num_speakers: int = 1
    speaker_embedding_size: int = 16

    embedding_size: int = 256
    dropout_prob: float = 0.5

    # Encoder
    enc_prenet_sizes: Tuple[int, ...] = (256, 128)
    enc_bank_size: int = 16
    enc_bank_channel_size: int = 128
    enc_maxpool_width: int = 2
    enc_highway_depth: int = 4
    enc_rnn_size: int = 128
    enc_proj_sizes: Tuple[int, ...] = (128, 128)
    enc_proj_width: int = 3

    # Attention (the port decodes with bah_mon_norm only)
    attention_type: str = "bah_mon_norm"
    attention_size: int = 256
    attention_state_size: int = 256

    # Decoder
    dec_layer_num: int = 2
    dec_rnn_size: int = 256
    dec_prenet_sizes: Tuple[int, ...] = (256, 128)
    # Decoder-prenet dropout stays live at inference when this is set and
    # the caller passes a generator.
    dec_prenet_dropout_inference: bool = True

    # Post-net CBHG
    post_bank_size: int = 8
    post_bank_channel_size: int = 128
    post_maxpool_width: int = 2
    post_highway_depth: int = 4
    post_rnn_size: int = 128
    post_proj_sizes: Tuple[int, ...] = (256, 80)
    post_proj_width: int = 3

    reduction_factor: int = 5

    # Scheduled sampling (training only)
    scheduled_sampling: bool = False
    ss_final_prob: float = 0.7
    ss_start_step: int = 10000
    ss_ramp_steps: int = 20000

    min_tokens: int = 30
    min_iters: int = 30
    max_iters: int = 200

    # 'bfloat16': modules compute in bf16 from f32 parameters, attention
    # math and returned outputs stay f32; 'float32' is exact.
    compute_dtype: str = "float32"
    scan_unroll: int = 1              # an XLA scheduling knob; unused here
    fused_rnn: bool = False
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    initial_learning_rate: float = 1e-3
    decay_learning_rate_mode: int = 0
    batch_size: int = 32
    prioritize_loss: bool = False
    initial_data_greedy: bool = True
    initial_phase_step: int = 8000
    main_data_greedy_factor: float = 0.0
    main_data: Tuple[str, ...] = ("",)


# The ``tacotron`` group of artifacts/both_r2.ckpt.tar.gz:params.json (a
# CPU test holds the two equal).
BOTH_R2 = TacotronConfig(
    model_type="deepvoice", num_speakers=2, speaker_embedding_size=16,
    attention_type="bah_mon_norm", compute_dtype="bfloat16",
    dec_prenet_dropout_inference=True, fused_rnn=True, scan_unroll=8)


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
    tacotron: TacotronConfig = field(default_factory=TacotronConfig)

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
                  wavenet=_coerce(WaveNetConfig, data.get("wavenet", {})),
                  tacotron=_coerce(TacotronConfig, data.get("tacotron", {})))


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
