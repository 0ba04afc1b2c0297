"""Text -> Tacotron mel -> WaveNet wav in one call (counterpart of the JAX
package's ``synth/e2e.py``): the Griffin-Lim wav of every text, and, with
a vocoder, the trimmed mels vocoded up to 8 at a time, one launch of the
generation kernel per chunk."""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import torch

from ..device import resolve_device
from ..dsp.audio_io import save_wav
from .generator import MAX_STREAMS, WaveNetGenerator
from .synthesizer import Synthesizer


class TTSPipeline:
    def __init__(self, synth: Synthesizer,
                 vocoder: Optional[WaveNetGenerator] = None):
        self.synth = synth
        self.vocoder = vocoder

    @classmethod
    def from_checkpoint(cls, tacotron: str, wavenet: Optional[str] = None,
                        device: Union[str, torch.device, None] = None
                        ) -> "TTSPipeline":
        """The trained Tacotron of the run ``tacotron`` and, if given, the
        trained WaveNet of ``wavenet`` (run dirs, ``ckpt/`` dirs or
        ``*.ckpt.tar.gz``), through each class's ``from_checkpoint``."""
        resolve_device(device)            # no GPU: fail before reading
        synth = Synthesizer.from_checkpoint(tacotron, device)
        vocoder = (WaveNetGenerator.from_checkpoint(wavenet, device)
                   if wavenet else None)
        return cls(synth, vocoder)

    def tts(self, texts: Union[str, Sequence[str]],
            base_path: Optional[str] = None,
            speaker_ids: Optional[Sequence[int]] = None,
            use_wavenet: bool = True) -> List[dict]:
        """``Synthesizer.synthesize`` (Griffin-Lim wav always); with a
        vocoder and ``use_wavenet``, each result also gets
        ``wavenet_wav`` and, with ``base_path``, ``{i}.wavenet.wav`` in
        ``wavenet_wav_path``."""
        results = self.synth.synthesize(texts, base_path=base_path,
                                        speaker_ids=speaker_ids)
        if not use_wavenet or self.vocoder is None:
            return results
        sr = self.synth.cfg.audio.sample_rate
        for start in range(0, len(results), MAX_STREAMS):
            chunk = results[start:start + MAX_STREAMS]
            sids = (None if speaker_ids is None
                    else list(speaker_ids[start:start + MAX_STREAMS]))
            wavs = self.vocoder.generate([r["mel"] for r in chunk],
                                         speaker_id=sids)
            # generate is list-in, list-out: a length mismatch would hand
            # wavs to the wrong texts
            if len(wavs) != len(chunk):
                raise RuntimeError(f"{len(wavs)} wavs for {len(chunk)} mels")
            for i, (r, wav) in enumerate(zip(chunk, wavs), start):
                r["wavenet_wav"] = wav
                if base_path:
                    r["wavenet_wav_path"] = os.path.join(
                        base_path, f"{i}.wavenet.wav")
                    save_wav(wav, r["wavenet_wav_path"], sr)
        return results
