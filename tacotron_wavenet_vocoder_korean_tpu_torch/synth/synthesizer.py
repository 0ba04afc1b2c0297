"""Text -> mel -> Griffin-Lim wav with Tacotron (counterpart of the JAX
package's ``synth/synthesizer.py``).

Texts are encoded by the Korean frontend, padded to a multiple of 16
(lengths include EOS), decoded in one batch over a static ``max_iters``,
and each utterance is trimmed where its attention has reached the end of
the text (``attention_trim_index``, the reference's argmax heuristic).
The mels are what ``WaveNetGenerator`` vocodes.  Manual-attention modes
1-3 decode a second time with the first decode's alignments made hard,
sharpened or pruned.  Each result's Griffin-Lim wav is rendered on the
device from its trimmed linear spectrogram, padded with silence to a
multiple of 100 frames as the JAX synthesizer pads it (the padding reaches
the wav's edges through Griffin-Lim, so it is part of the result).  With a
``base_path`` the wav, the mel (``.mel.npy``) and the alignment (``.png``,
``utils/plot.py``) are written there.  Prenet dropout at inference follows
the config, seeded by ``synthesize(rng_seed=)``, the same masks for both
decodes of a manual mode; the compute type (``compute_dtype``) does too,
on either device, and float32 stays float32 on the card (no TF32).
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config, load_config
from ..convert import (seeded_tacotron_params, tacotron_params_from_jax,
                       tacotron_params_from_npz)
from ..device import no_tf32, resolve_device
from ..dsp.audio_io import save_wav
from ..dsp.griffin_lim import inv_linear_spectrogram
from ..models.tacotron import Tacotron
from ..text import TextCodec
from ..train.checkpoints import CheckpointReader
from ..utils import plot

# Griffin-Lim renders each linear spectrogram padded to a multiple of this
# many frames (1.25 s), as the JAX synthesizer does.
GL_BUCKET = 100


def attention_trim_index(alignment: np.ndarray, seq_len: int,
                         reduction_factor: int) -> int:
    """Frames to keep, from the attention-argmax end-of-speech heuristic
    (reference synthesizer.py:236-256)."""
    attention_argmax = alignment[:seq_len].argmax(0)
    end_idx = min(seq_len - 1, attention_argmax.max())
    max_counter = min(int((attention_argmax == end_idx).sum()), 5)
    end_idx_counter = 0
    jdx = 0
    for jdx, attend_idx in enumerate(attention_argmax):
        if len(attention_argmax) > jdx + 1:
            if attend_idx == end_idx:
                end_idx_counter += 1
            if attend_idx == end_idx and attention_argmax[jdx + 1] > end_idx:
                break
            if end_idx_counter >= max_counter:
                break
        else:
            break
    return reduction_factor * jdx + 3


def round_up(x: int, multiple: int) -> int:
    r = x % multiple
    return x if r == 0 else x + multiple - r


class Synthesizer:
    """Holds the config, the text codec and the Tacotron on ``device``
    (``cuda`` unless the caller asks for the CPU)."""

    step: Optional[int] = None      # the checkpoint's step, when loaded

    def __init__(self, cfg: Config, params: Dict[str, torch.Tensor],
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.codec = TextCodec(cfg.tacotron.cleaners)
        self.model = Tacotron(cfg.tacotron, cfg.audio, self.codec.vocab_size)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()

    @classmethod
    def load(cls, weights: Optional[str], config: str,
             device: Union[str, torch.device, None] = None,
             seed: Optional[int] = None) -> "Synthesizer":
        """``config``: ``params.json``, a run dir or a ``*.ckpt.tar.gz``.
        ``weights``: an ``.npz`` of JAX-named parameters and batch stats
        (``convert.tacotron_params_from_npz``); or ``None`` with ``seed``
        for seeded full-width weights."""
        cfg = load_config(config)
        vocab = TextCodec(cfg.tacotron.cleaners).vocab_size
        if weights is not None:
            params = tacotron_params_from_npz(cfg.tacotron, weights,
                                              cfg.audio, vocab)
        elif seed is not None:
            params = seeded_tacotron_params(cfg.tacotron, seed, cfg.audio,
                                            vocab)
        else:
            raise ValueError("give weights or seed")
        return cls(cfg, params, device)

    @classmethod
    def from_checkpoint(cls, path: str,
                        device: Union[str, torch.device, None] = None,
                        step: Optional[int] = None,
                        num_speakers: Optional[int] = None,
                        inference_dropout: Optional[bool] = None
                        ) -> "Synthesizer":
        """The trained Tacotron of a run (a run dir, its ``ckpt/`` dir or a
        ``*.ckpt.tar.gz``), as the JAX ``Synthesizer.load`` serves it
        (``fused_rnn=True``): ``params`` and ``batch_stats`` of ``step``
        (the latest by default), GRUCell trees fused (``fused_rnn`` set),
        the config from the run's ``params.json``.  ``num_speakers``, when
        given, must match the checkpoint's; ``inference_dropout``, when
        given, overrides ``dec_prenet_dropout_inference``."""
        resolve_device(device)            # no GPU: fail before reading
        with CheckpointReader(path) as reader:
            cfg = reader.config()
            taco = cfg.tacotron
            if num_speakers is not None and num_speakers != taco.num_speakers:
                raise ValueError(f"checkpoint has {taco.num_speakers} "
                                 f"speakers, requested {num_speakers}")
            dropout = (taco.dec_prenet_dropout_inference
                       if inference_dropout is None else inference_dropout)
            cfg = dataclasses.replace(cfg, tacotron=dataclasses.replace(
                taco, dec_prenet_dropout_inference=dropout, fused_rnn=True))
            tree = reader.restore(step, items=("params", "batch_stats",
                                               "step"))
        vocab = TextCodec(cfg.tacotron.cleaners).vocab_size
        params = tacotron_params_from_jax(cfg.tacotron, tree["params"],
                                          tree["batch_stats"], cfg.audio,
                                          vocab)
        synth = cls(cfg, params, device)
        synth.step = int(tree["step"])
        return synth

    def _prepare_inputs(self, texts: Sequence[str]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        seqs = [self.codec.encode(t) for t in texts]
        max_len = round_up(max(len(s) for s in seqs), 16)
        inputs = np.zeros((len(seqs), max_len), np.int32)
        lengths = np.zeros(len(seqs), np.int32)
        for i, s in enumerate(seqs):
            inputs[i, :len(s)] = s
            lengths[i] = len(s)            # includes EOS
        return inputs, lengths

    def speaker_rows(self, speaker_ids, batch: int) -> Optional[np.ndarray]:
        """Speaker ids checked on the host with numpy's indexing: -1 is the
        last speaker, an id out of range raises ``IndexError`` before any
        launch (on the card it would trip a device-side assert)."""
        n = self.cfg.tacotron.num_speakers
        if n <= 1:
            return None
        ids = np.broadcast_to(
            np.asarray(0 if speaker_ids is None else speaker_ids), (batch,))
        return np.arange(n)[ids]

    def manual_alignments(self, align: np.ndarray, mode: int
                          ) -> np.ndarray:
        """The first decode's alignments [B, T_in, T_dec] -> the second
        decode's [B, T_dec, T_in]: 1 the argmax one-hot, 2 squared
        (sharpened), 3 the argmax set to 1 (pruned)."""
        manual = np.transpose(align, (0, 2, 1)).copy()
        steps = np.arange(manual.shape[1])
        for b in range(len(manual)):
            argmax = align[b].argmax(0)
            if mode == 1:
                manual[b] = 0.0
                manual[b][steps, argmax] = 1.0
            elif mode == 2:
                manual[b] = manual[b] ** 2
            elif mode == 3:
                manual[b][steps, argmax] = 1.0
            else:
                raise ValueError(f"manual_attention_mode {mode}: 0 to 3")
        return manual

    def griffin_lim_wav(self, linear: torch.Tensor) -> np.ndarray:
        """Trimmed linear frames [n, num_freq] (on the device) -> the
        Griffin-Lim wav of n * hop_size samples, rendered from the frames
        padded with silence to a multiple of ``GL_BUCKET`` (a multiple
        itself gets no padding and loses its last hop, as in JAX)."""
        a = self.cfg.audio
        n = linear.shape[0]
        bucket = round_up(max(n, 1), GL_BUCKET)
        pad = -a.max_abs_value if a.symmetric_mels else 0.0
        padded = torch.nn.functional.pad(linear.float().T, (0, bucket - n),
                                         value=pad)
        wav = inv_linear_spectrogram(padded, a)
        return wav[:n * a.hop_size].cpu().numpy()

    def synthesize_long(self, text: str, base_path: Optional[str] = None,
                        speaker_id: int = 0, silence_ms: float = 150.0,
                        **kwargs) -> dict:
        """Split ``text`` at sentence ends, synthesize the pieces as one
        batch and join their wavs with ``silence_ms`` of zeros (and their
        mels); with ``base_path``, write ``long.wav`` and ``long.mel.npy``
        there."""
        pieces = [p.strip() for p in re.split(r"(?<=[.!?])\s+", text.strip())
                  if p.strip()] or [text]
        results = self.synthesize(pieces, speaker_ids=[speaker_id]
                                  * len(pieces), **kwargs)
        sr = self.cfg.audio.sample_rate
        gap = np.zeros(int(sr * silence_ms / 1000.0), np.float32)
        parts = []
        for r in results:
            parts.extend([r["wav"].astype(np.float32), gap])
        wav = np.concatenate(parts[:-1])
        mel = np.concatenate([r["mel"] for r in results], axis=0)
        out = {"wav": wav, "mel": mel, "text": text, "pieces": len(pieces)}
        if base_path:
            os.makedirs(base_path, exist_ok=True)
            out["wav_path"] = os.path.join(base_path, "long.wav")
            save_wav(wav, out["wav_path"], sr)
            out["mel_path"] = os.path.join(base_path, "long.mel.npy")
            np.save(out["mel_path"], mel, allow_pickle=False)
        return out

    @torch.no_grad()
    def synthesize(self, texts: Union[str, Sequence[str]],
                   base_path: Optional[str] = None,
                   speaker_ids: Optional[Sequence[int]] = None,
                   attention_trim: bool = True,
                   manual_attention_mode: int = 0,
                   max_iters: Optional[int] = None,
                   save_alignment: bool = True,
                   save_mel: bool = True,
                   rng_seed: int = 0) -> List[dict]:
        """Decode ``texts`` in one batch; one dict per text with ``mel``
        [frames, num_mels] and ``linear`` [frames, num_freq] (both trimmed
        when ``attention_trim``), ``wav`` (Griffin-Lim, frames * hop_size
        samples), ``alignment`` [T_in, T_dec] and ``text``; with
        ``base_path`` also ``wav_path`` and, as ``save_mel`` and
        ``save_alignment`` ask, ``mel_path`` and ``alignment_path``
        (``{i}.wav``, ``{i}.mel.npy``, ``{i}.png``; ``{i}_manual.*`` in a
        manual-attention mode)."""
        if isinstance(texts, str):
            texts = [texts]
        cfg = self.cfg.tacotron
        r = cfg.reduction_factor
        max_iters = max_iters or cfg.max_iters
        inputs, lengths = self._prepare_inputs(texts)
        rows = self.speaker_rows(speaker_ids, len(texts))
        dev = self.device
        masks = None
        if cfg.dec_prenet_dropout_inference:
            masks = self.model.draw_prenet_masks(
                max_iters, len(texts),
                torch.Generator(device=dev).manual_seed(rng_seed))
        args = (torch.from_numpy(inputs).long().to(dev),
                torch.from_numpy(lengths).long().to(dev),
                None if rows is None else torch.from_numpy(rows).to(dev))
        with no_tf32():
            out = self.model(*args, max_iters=max_iters, prenet_masks=masks)
            if manual_attention_mode > 0:
                manual = self.manual_alignments(
                    out["alignments"].cpu().numpy(), manual_attention_mode)
                out = self.model(*args, max_iters=max_iters,
                                 prenet_masks=masks,
                                 manual_alignments=torch.from_numpy(
                                     manual).to(dev))
        mel = out["mel_outputs"].cpu().numpy()
        linear = out["linear_outputs"]
        align = out["alignments"].cpu().numpy()
        suffix = "_manual" if manual_attention_mode > 0 else ""
        results = []
        for i, text in enumerate(texts):
            n_keep = mel.shape[1]
            if attention_trim:
                n_keep = min(n_keep, attention_trim_index(
                    align[i], int(lengths[i]), r))
            lin = linear[i, :n_keep]
            entry = {"wav": self.griffin_lim_wav(lin), "mel": mel[i, :n_keep],
                     "linear": lin.cpu().numpy(), "alignment": align[i],
                     "text": text}
            if base_path:
                self._save(entry, base_path, f"{i}{suffix}",
                           int(lengths[i]), save_mel, save_alignment)
            results.append(entry)
        return results

    def _save(self, entry: dict, base_path: str, stem: str, length: int,
              save_mel: bool, save_alignment: bool) -> None:
        os.makedirs(base_path, exist_ok=True)
        entry["wav_path"] = os.path.join(base_path, f"{stem}.wav")
        save_wav(entry["wav"], entry["wav_path"], self.cfg.audio.sample_rate)
        if save_mel:
            entry["mel_path"] = os.path.join(base_path, f"{stem}.mel.npy")
            np.save(entry["mel_path"], entry["mel"], allow_pickle=False)
        if save_alignment:
            entry["alignment_path"] = os.path.join(base_path, f"{stem}.png")
            plot.plot_alignment(entry["alignment"][:length],
                                entry["alignment_path"])
