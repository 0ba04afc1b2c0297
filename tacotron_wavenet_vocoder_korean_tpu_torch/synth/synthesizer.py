"""Text -> mel synthesis with Tacotron: the mel half of the JAX package's
``synth/synthesizer.py``.

Texts are encoded by the Korean frontend, padded to a multiple of 16
(lengths include EOS), decoded in one batch over a static ``max_iters``,
and each utterance is trimmed where its attention has reached the end of
the text (``attention_trim_index``, the reference's argmax heuristic).
The mels are what ``WaveNetGenerator`` vocodes.  Prenet dropout at
inference follows the config, seeded by ``synthesize(rng_seed=)``; the
compute type (``compute_dtype``) does too, on either device, and float32
stays float32 on the card (no TF32).

Not ported yet (ROADMAP.md, Queue 1): the Griffin-Lim ``wav`` of each
result, the manual-attention modes 1-3, alignment PNGs, file output and
``synthesize_long``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config, load_config
from ..convert import seeded_tacotron_params, tacotron_params_from_npz
from ..device import no_tf32, resolve_device
from ..models.tacotron import Tacotron
from ..text import TextCodec


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

    @torch.no_grad()
    def synthesize(self, texts: Union[str, Sequence[str]],
                   speaker_ids: Optional[Sequence[int]] = None,
                   attention_trim: bool = True,
                   max_iters: Optional[int] = None,
                   rng_seed: int = 0) -> List[dict]:
        """Decode ``texts`` in one batch; one dict per text with ``mel``
        [frames, num_mels] and ``linear`` [frames, num_freq] (both trimmed
        when ``attention_trim``), ``alignment`` [T_in, T_dec] and
        ``text``."""
        if isinstance(texts, str):
            texts = [texts]
        cfg = self.cfg.tacotron
        inputs, lengths = self._prepare_inputs(texts)
        rows = self.speaker_rows(speaker_ids, len(texts))
        dev = self.device
        generator = None
        if cfg.dec_prenet_dropout_inference:
            generator = torch.Generator(device=dev).manual_seed(rng_seed)
        with no_tf32():
            out = self.model(
                torch.from_numpy(inputs).long().to(dev),
                torch.from_numpy(lengths).long().to(dev),
                None if rows is None else torch.from_numpy(rows).to(dev),
                max_iters=max_iters or cfg.max_iters, generator=generator)
        mel = out["mel_outputs"].cpu().numpy()
        linear = out["linear_outputs"].cpu().numpy()
        align = out["alignments"].cpu().numpy()
        results = []
        for i, text in enumerate(texts):
            n_keep = mel.shape[1]
            if attention_trim:
                n_keep = min(n_keep, attention_trim_index(
                    align[i], int(lengths[i]), cfg.reduction_factor))
            results.append({"mel": mel[i, :n_keep],
                            "linear": linear[i, :n_keep],
                            "alignment": align[i], "text": text})
        return results
