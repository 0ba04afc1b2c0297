"""WaveNet generator: mel ``.npy`` -> waveform (counterpart of the JAX
package's ``synth/generator.py``).

Up to 8 ragged mels are silence-padded to the longest, upsampled, projected
and vocoded together in ONE launch of the generation kernel; each wav is
then trimmed back to ``frames * hop`` samples and decoded per input type
(mu-law class ids through ``inv_mulaw_quantize`` for ``mulaw-quantize``).
``wav_seed`` primes the sampler, teacher-forced, with the last receptive
field of a seed waveform; ``temperature`` scales the softmax head.  On a
CPU device the kernel's plain twin runs.

Weights are served in bf16 on the GPU and in f32 on the CPU unless the
caller picks a type, as the JAX generator serves the Pallas kernel's bf16
default on an accelerator and its f32 scan sampler on the CPU.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config, load_config
from ..convert import (gc_enabled, params_from_jax, params_from_npz,
                       seeded_params)
from ..device import no_tf32, resolve_device
from ..dsp.audio_io import save_wav
from ..dsp.mulaw import inv_mulaw, inv_mulaw_quantize, mulaw, mulaw_quantize
from ..models.wavenet import Params, Upsampler
from ..ops.wavenet_gen import (incremental_generate_cuda,
                                kernel_limits_error, pack_params)
from ..train.checkpoints import CheckpointReader

MAX_STREAMS = 8


def batch_mels(mels: Sequence[np.ndarray], pad_value: float
               ) -> Tuple[np.ndarray, List[int]]:
    """Stack ragged [F_i, M] mels into [B, F_max, M] (silence-padded) and
    return the per-stream frame counts for post-trim."""
    frames = [m.shape[0] for m in mels]
    out = np.full((len(mels), max(frames), mels[0].shape[1]), pad_value,
                  np.float32)
    for i, m in enumerate(mels):
        out[i, :m.shape[0]] = m
    return out, frames


def resolve_weight_dtype(device: torch.device,
                         weight_dtype: Optional[torch.dtype] = None
                         ) -> torch.dtype:
    """The weight type a generator serves with: ``weight_dtype`` if given,
    else bf16 on a GPU and f32 on the CPU."""
    if weight_dtype is not None:
        return weight_dtype
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def encode_seed_audio(cfg: Config, wav: np.ndarray, batch: int
                      ) -> torch.Tensor:
    """Raw float waveform -> the sampler's seed convention: [B, T, 1]
    samples, mu-law companded when the model was trained on mu-law input;
    or, for ``mulaw-quantize``, [B, T, Q] one-hot mu-law classes."""
    w = cfg.wavenet
    x = torch.from_numpy(np.asarray(wav, np.float32).reshape(-1))
    if w.input_type == "mulaw":
        x = mulaw(x, w.quantization_channels)
    if w.scalar_input:
        return x[None, :, None].expand(batch, -1, 1)
    cls = mulaw_quantize(x, w.quantization_channels).long()
    onehot = torch.nn.functional.one_hot(cls, w.quantization_channels)
    return onehot.to(torch.float32)[None].expand(batch, -1, -1)


class WaveNetGenerator:
    """Holds the config, the converted parameters on ``device``, the packed
    kernel layout (matrices in ``weight_dtype``: by default bf16 on a GPU,
    f32 on the CPU) and the upsampler.  On a GPU the CUDA kernel serves any
    width whose layout fits a block's shared memory, or a cluster's of up
    to 8 blocks per stream (R = D = 128 at 50 layers takes 4), in one
    launch per ``generate`` call; a
    config it does not take (``kernel_limits_error`` with this weight
    type, e.g. R = D = 256 at 50 layers) raises ``ValueError`` here, before
    any weight moves to the card."""

    step: Optional[int] = None      # the checkpoint's step, when loaded

    def __init__(self, cfg: Config, params: Params,
                 device: Union[str, torch.device, None] = None,
                 weight_dtype: Optional[torch.dtype] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.weight_dtype = resolve_weight_dtype(self.device, weight_dtype)
        if self.device.type == "cuda":
            error = kernel_limits_error(cfg.wavenet, self.weight_dtype)
            if error is not None:
                raise ValueError(error)
        # Speaker rows are picked on the host, with numpy's indexing (a
        # negative id wraps, an id out of range raises IndexError), as the
        # JAX generator picks them: an index out of range on the card would
        # trip a device-side assert and leave the CUDA context unusable.
        self.gc_table = (params["gc_embedding"].detach().cpu().numpy()
                         if "gc_embedding" in params else None)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.packed = pack_params(cfg.wavenet, self.params, self.weight_dtype)
        self.upsampler = Upsampler(cfg.wavenet).load_params(self.params).to(
            self.device)
        self.gc_enable = gc_enabled(cfg.wavenet)

    @classmethod
    def load(cls, weights: Optional[str], config: str,
             device: Union[str, torch.device, None] = None,
             init_seed: Optional[int] = None) -> "WaveNetGenerator":
        """``config``: ``params.json``, a run dir or a ``*.ckpt.tar.gz``.
        ``weights``: an ``.npz`` of JAX-named parameters; or ``None`` with
        ``init_seed`` for seeded full-width weights."""
        cfg = load_config(config)
        if weights is not None:
            params = params_from_npz(cfg.wavenet, weights)
        elif init_seed is not None:
            params = seeded_params(cfg.wavenet, init_seed)
        else:
            raise ValueError("give weights or init_seed")
        return cls(cfg, params, device)

    @classmethod
    def from_checkpoint(cls, path: str,
                        device: Union[str, torch.device, None] = None,
                        use_ema: bool = True, step: Optional[int] = None,
                        config: Optional[str] = None) -> "WaveNetGenerator":
        """The trained generator of a run (a run dir, its ``ckpt/`` dir or
        a ``*.ckpt.tar.gz``), as the JAX ``WaveNetGenerator.load`` serves
        it: ``ema_params`` (``params`` when ``use_ema`` is off) of ``step``
        (the latest by default), weight norm folded, every name and shape
        checked; the config from the run's ``params.json`` unless
        ``config`` names another."""
        resolve_device(device)            # no GPU: fail before reading
        item = "ema_params" if use_ema else "params"
        with CheckpointReader(path) as reader:
            cfg = load_config(config) if config else reader.config()
            tree = reader.restore(step, items=(item, "step"))
        gen = cls(cfg, params_from_jax(cfg.wavenet, tree[item]), device)
        gen.step = int(tree["step"])
        return gen

    def _decode_samples(self, samples: np.ndarray) -> np.ndarray:
        w = self.cfg.wavenet
        if w.input_type == "mulaw-quantize":
            return inv_mulaw_quantize(torch.from_numpy(samples),
                                      w.quantization_channels).numpy()
        if w.input_type == "mulaw":
            return inv_mulaw(torch.from_numpy(samples),
                             w.quantization_channels).numpy()
        return samples

    @torch.no_grad()
    def generate(self, mel: Union[np.ndarray, Sequence[np.ndarray]],
                 speaker_id: Union[int, Sequence[int], None] = None,
                 seed: int = 0,
                 wav_seed: Optional[np.ndarray] = None,
                 temperature: float = 1.0,
                 deterministic: bool = False
                 ) -> Union[np.ndarray, List[np.ndarray]]:
        """mel [frames, num_mels], or a list of up to 8 ragged mels vocoded
        in one kernel launch -> float waveform(s) [frames*hop].

        ``seed`` seeds the ``torch.Generator`` of the sampling noise.
        ``temperature`` scales the softmax head (``mulaw-quantize``); the
        mixture-of-logistics head takes only 1.0."""
        single = not isinstance(mel, (list, tuple))
        mels = [np.asarray(m, np.float32) for m in ([mel] if single else mel)]
        if not 1 <= len(mels) <= MAX_STREAMS:
            raise ValueError(f"1 to {MAX_STREAMS} mels per call, got "
                             f"{len(mels)}")
        a = self.cfg.audio
        hop = a.hop_size
        pad_value = -a.max_abs_value if a.symmetric_mels else 0.0
        batch, frames = batch_mels(mels, pad_value)
        dev = self.device

        gc = None
        if self.gc_enable:
            ids = np.broadcast_to(
                np.asarray(0 if speaker_id is None else speaker_id),
                (len(mels),)).copy()
            gc = torch.from_numpy(self.gc_table[ids]).to(dev)

        seed_audio = None
        total = batch.shape[1] * hop
        if wav_seed is not None:
            # Only the receptive field of the seed can reach the output; keep
            # at least one free-running step.
            keep = min(self.cfg.wavenet.receptive_field, total - 1)
            seed_audio = encode_seed_audio(self.cfg, wav_seed, len(mels))
            seed_audio = seed_audio[:, -keep:].contiguous().to(dev)

        gen = torch.Generator(device=dev).manual_seed(seed)
        with no_tf32():
            lc = self.upsampler(torch.from_numpy(batch).to(dev))
            samples = incremental_generate_cuda(
                self.cfg.wavenet, self.packed, lc, generator=gen, gc=gc,
                seed_audio=seed_audio, deterministic=deterministic,
                temperature=temperature)
        samples = samples.cpu().numpy()
        wavs = [self._decode_samples(samples[i, :frames[i] * hop])
                for i in range(len(mels))]
        return wavs[0] if single else wavs

    def generate_to_file(self, mel_path: Union[str, Sequence[str]],
                         out_path: Union[str, Sequence[str]],
                         speaker_id: Optional[int] = None,
                         wav_seed: Optional[np.ndarray] = None,
                         temperature: float = 1.0) -> List[str]:
        mel_paths = [mel_path] if isinstance(mel_path, str) else list(mel_path)
        out_paths = [out_path] if isinstance(out_path, str) else list(out_path)
        if len(mel_paths) != len(out_paths):
            raise ValueError("one output path per mel")
        mels = [np.load(p) for p in mel_paths]
        t0 = time.perf_counter()
        wavs = self.generate(mels, speaker_id=speaker_id, wav_seed=wav_seed,
                             temperature=temperature)
        dt = time.perf_counter() - t0
        sr = self.cfg.audio.sample_rate
        n = sum(len(w) for w in wavs)
        print(f"generated {n} samples ({len(wavs)} stream(s)) on "
              f"{self.device} in {dt:.2f}s ({n / dt / sr:.2f}x realtime "
              f"aggregate)")
        for w, p in zip(wavs, out_paths):
            save_wav(w, p, sr)
        return out_paths
