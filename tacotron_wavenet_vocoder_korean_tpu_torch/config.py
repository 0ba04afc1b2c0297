"""Configuration: the four groups of ``params.json`` (audio, Tacotron,
WaveNet, train), JSON round-trippable.

A copy of the JAX package's ``config.py`` (every group and field with its
default, ``validate``, ``to_dict`` / ``from_dict``, ``save_config`` /
``load_config``, ``overlay``, the ``--hparams`` string parsing and
``debug_string``), so the port reads and writes the same run-dir contract
without importing the JAX package.  Unknown keys are ignored, as there.
``load_config`` also reads a ``*.ckpt.tar.gz``.  ``BOTH_R2`` is the Tacotron
group of the committed ``artifacts/both_r2.ckpt.tar.gz``, for machines that
do not hold the tarball.

Some fields are carried and round-tripped for a part of the port that does
not exist yet; each says which part will read it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tarfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple


@dataclass(frozen=True)
class AudioConfig:
    """The audio parameters: sample rate, hop, window, mel and linear
    widths, pre-emphasis, the dB and normalisation chain (read by serving,
    the mel analysis, Griffin-Lim and ``extract_features``), the rescaling,
    trimming and length-clipping fields (read by the corpus builders,
    ``data/corpus.py``), and Griffin-Lim's iterations and power."""

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

    rescaling: bool = True
    rescaling_max: float = 0.999

    trim_silence: bool = True
    trim_fft_size: int = 512
    trim_hop_size: int = 128
    trim_top_db: float = 23.0

    clip_mels_length: bool = True
    max_mel_frames: int = 1000

    griffin_lim_iters: int = 60
    power: float = 1.5

    @property
    def num_freq(self) -> int:
        return self.fft_size // 2 + 1

    @property
    def frame_shift_ms(self) -> float:
        return self.hop_size * 1000.0 / self.sample_rate


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
    """WaveNet vocoder hyperparameters: the JAX ``WaveNetConfig``'s
    architecture and training fields, with its defaults."""

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

    sample_size: int = 15000          # samples per training crop
    silence_threshold: int = 0        # mulaw-quantize's silence crop
    l2_regularization_strength: float = 0.0

    # Weight normalization on every stack weight: the training tree holds
    # ``<name>_v`` / ``<name>_g`` pairs (and flat ``post_N_kernel/bias``);
    # serving folds them (``models/wavenet.py`` ``materialize_wn_params``).
    weight_normalization: bool = False

    # Training.  'bfloat16' runs the dilated stack and the post layers in
    # bf16 (parameters, targets and the loss stay f32); 'float32' is exact.
    compute_dtype: str = "float32"
    batch_size: int = 8
    num_steps: int = 200000
    learning_rate: float = 1e-3
    decay_rate: float = 0.5
    decay_steps: int = 300000
    clip_gradients: bool = False
    ema_decay: float = 0.9999
    optimizer: str = "adam"           # 'adam' | 'sgd' | 'rmsprop'
    momentum: float = 0.9

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
class TrainConfig:
    """Run-level training knobs, the JAX ``TrainConfig``'s fields and
    defaults, read by ``train_vocoder.py``, ``train_tacotron.py`` and
    their batchers.

    ``best_eval_batches``, ``loss_explosion_threshold`` and
    ``transfer_dtype`` are read by the Tacotron trainer,
    ``skip_path_filter`` by ``TacotronBatcher`` (and so by
    ``scripts/quality_eval.py --heldout``), ``checkpoint_interval`` by
    the Tacotron trainer alone (the WaveNet
    trainer saves every 1,000 steps, as in JAX).  ``max_host_rss_gb``
    and ``restart_slowdown_ratio`` drive the JAX trainer's RSS and
    slowdown watchdogs, which answer a leak of the TPU client and are not
    ported: the port round-trips them and reads neither."""

    random_seed: int = 123
    checkpoint_interval: int = 2000
    test_interval: int = 500
    summary_interval: int = 100
    max_checkpoints: int = 3
    # Best-heldout retention: the Tacotron trainer keeps the checkpoint of
    # the lowest free-run loss over this many fixed heldout batches.
    best_eval_batches: int = 2
    skip_path_filter: bool = False
    num_test_per_speaker: int = 2
    loss_explosion_threshold: float = 100.0
    store_metadata: bool = False
    device_resident_data: bool = True
    transfer_dtype: str = "float16"
    sync_every: int = 30
    max_host_rss_gb: float = 60.0
    restart_slowdown_ratio: float = 1.25
    # The training loop exits if it makes no progress for this long (and
    # for first_hang_timeout_s before its first step).
    hang_timeout_s: float = 1200.0
    first_hang_timeout_s: float = 2700.0


@dataclass(frozen=True)
class Config:
    """Top-level bundle of all subsystem configs."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    tacotron: TacotronConfig = field(default_factory=TacotronConfig)
    wavenet: WaveNetConfig = field(default_factory=WaveNetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def __post_init__(self):
        validate(self)


def validate(cfg: Config) -> None:
    """Cross-field invariants: the upsampler's factors make the hop, the
    MoL head has 3 channels per component, ``scalar_input`` agrees with
    ``input_type``, and a training crop covers the receptive field."""
    w = cfg.wavenet
    if math.prod(w.upsample_factor) != cfg.audio.hop_size:
        raise ValueError(
            f"prod(upsample_factor)={math.prod(w.upsample_factor)} must "
            f"equal hop_size={cfg.audio.hop_size}")
    if w.scalar_input and w.out_channels % 3 != 0:
        raise ValueError("out_channels must be a multiple of 3 for MoL output")
    scalar = w.input_type in ("raw", "mulaw")
    if scalar != w.scalar_input:
        raise ValueError(
            f"input_type={w.input_type!r} implies scalar_input={scalar}, got "
            f"{w.scalar_input}")
    if w.sample_size < w.receptive_field:
        raise ValueError(
            f"sample_size={w.sample_size} must be >= receptive_field="
            f"{w.receptive_field}")


# ---------------------------------------------------------------------------
# JSON persistence: the params.json-in-rundir contract.
# ---------------------------------------------------------------------------

def to_dict(cfg: Config) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _coerce(dc_cls, data: Dict[str, Any]):
    """Build a dataclass from a dict, ignoring unknown keys and turning
    lists back into tuples."""
    names = {f.name for f in dataclasses.fields(dc_cls)}
    return dc_cls(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in data.items() if k in names})


def from_dict(data: Dict[str, Any]) -> Config:
    return Config(audio=_coerce(AudioConfig, data.get("audio", {})),
                  tacotron=_coerce(TacotronConfig, data.get("tacotron", {})),
                  wavenet=_coerce(WaveNetConfig, data.get("wavenet", {})),
                  train=_coerce(TrainConfig, data.get("train", {})))


def save_config(cfg: Config, log_dir: str,
                filename: str = "params.json") -> str:
    """Write the config into a run dir, as the JAX package writes it
    (sorted keys, indent 2, UTF-8)."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, filename)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_dict(cfg), f, indent=2, sort_keys=True,
                  ensure_ascii=False)
    return path


def load_config(path: str) -> Config:
    """Read a config from a ``params.json`` file, a run dir holding one, or
    a ``*.ckpt.tar.gz`` checkpoint tarball holding one."""
    if os.path.isdir(path):
        path = os.path.join(path, "params.json")
    if path.endswith((".tar.gz", ".tgz", ".tar")):
        return from_dict(read_params_from_tarball(path))
    with open(path, encoding="utf-8") as f:
        return from_dict(json.load(f))


def overlay(base: Config, **groups: Dict[str, Any]) -> Config:
    """A new Config with per-group field overrides applied:
    ``overlay(cfg, wavenet={'batch_size': 4})``."""
    current = to_dict(base)
    for group, upd in groups.items():
        if group not in current:
            raise KeyError(f"unknown config group: {group}")
        current[group].update(upd)
    return from_dict(current)


def split_overrides(spec: str) -> List[str]:
    """Split a ``--hparams`` string on commas that are not inside brackets,
    so list values survive: ``"wavenet.dilations=[1,2,4],wavenet.momentum=0.5"``
    -> ``["wavenet.dilations=[1,2,4]", "wavenet.momentum=0.5"]``."""
    parts, buf, depth = [], [], 0
    for ch in spec:
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return [p.strip() for p in parts if p.strip()]


def overlay_from_strings(base: Config, assignments) -> Config:
    """Apply ``group.key=value`` string overrides (the CLIs' ``--hparams``):
    values are JSON-parsed, Python's ``True`` / ``False`` / ``None``
    accepted, anything else kept as the raw string.  Unknown groups or
    keys raise."""
    py_lits = {"True": True, "False": False, "None": None}
    groups: Dict[str, Dict[str, Any]] = {}
    for item in assignments:
        if "=" not in item or "." not in item.split("=", 1)[0]:
            raise ValueError(
                f"bad --hparams entry {item!r}; want group.key=value")
        key, raw = item.split("=", 1)
        group, name = key.split(".", 1)
        if raw in py_lits:
            val = py_lits[raw]
        else:
            try:
                val = json.loads(raw)
            except ValueError:
                val = raw
        groups.setdefault(group, {})[name] = val
    current = to_dict(base)
    for group, upd in groups.items():
        if group not in current:
            raise KeyError(f"unknown config group: {group}")
        for name in upd:
            if name not in current[group]:
                raise KeyError(f"unknown field {group}.{name}")
    return overlay(base, **groups)


def debug_string(cfg: Config) -> str:
    """Every field, sorted by group and name, one per line."""
    lines = []
    for group, values in sorted(to_dict(cfg).items()):
        for k, v in sorted(values.items()):
            lines.append(f"  {group}.{k}: {v}")
    return "Hyperparameters:\n" + "\n".join(lines)


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
