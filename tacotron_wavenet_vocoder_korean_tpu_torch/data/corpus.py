"""Corpus preprocessing: wav + transcript -> one ``.npz`` training example
(counterpart of the JAX package's ``data/corpus.py``).

Each utterance is loaded, peak-rescaled and trimmed; its mel and linear
spectrograms come from one STFT on the caller's device
(``dsp.stft.extract_features``); the audio is reflect-padded and cut to
``mel_frames * hop_size`` samples (the upsampler's invariant) and saved
with the 8 keys the JAX package writes: ``audio, mel, linear,
time_steps, mel_frames, text, tokens, loss_coeff`` (the JAX function's
``allow_pickle=False`` argument to ``np.savez``, which takes no such
option, is stored there as a ninth array; no reader looks for it, and the
port does not write it).  ``audio`` is float32
for ``raw`` and ``mulaw`` and int16 class ids for ``mulaw-quantize``,
whose leading and trailing silence is cut as well.  Utterances fan out
over threads, as in JAX.
"""
from __future__ import annotations

import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..dsp.audio_io import (
    load_wav, rescale, start_and_end_indices, trim_silence)
from ..dsp.mulaw import mulaw, mulaw_quantize
from ..dsp.stft import extract_features
from ..text import TextCodec

Example = Tuple[str, int, int, str]   # (npz_filename, time_steps, mel_frames, text)
Device = Union[str, torch.device, None]


def _process_utterance(out_dir: str, wav_path: str, text: str, cfg: Config,
                       device: torch.device) -> Optional[Example]:
    """One utterance -> one npz; None when it is missing, too short after
    trimming, or longer than ``max_mel_frames`` (with
    ``clip_mels_length``)."""
    audio_cfg = cfg.audio
    wavenet_cfg = cfg.wavenet
    try:
        wav = load_wav(wav_path, audio_cfg.sample_rate)
    except FileNotFoundError:
        print(f"missing wav, skipping: {wav_path}")
        return None

    if audio_cfg.rescaling:
        wav = rescale(wav, audio_cfg)
    if audio_cfg.trim_silence:
        wav = trim_silence(wav, audio_cfg)
    if len(wav) < audio_cfg.hop_size * 4:
        return None

    input_type = wavenet_cfg.input_type
    qc = wavenet_cfg.quantization_channels
    if input_type == "mulaw-quantize":
        out = mulaw_quantize(torch.from_numpy(wav), qc).numpy()
        start, end = start_and_end_indices(out, wavenet_cfg.silence_threshold)
        wav, out = wav[start:end], out[start:end]
        out_dtype = np.int16
    elif input_type == "mulaw":
        out = mulaw(torch.from_numpy(wav), qc).numpy()
        out_dtype = np.float32
    else:  # raw
        out = wav
        out_dtype = np.float32

    mel, linear = extract_features(wav, audio_cfg, device)
    mel_frames = mel.shape[1]
    if audio_cfg.clip_mels_length and mel_frames > audio_cfg.max_mel_frames:
        return None
    if linear.shape[1] != mel_frames:
        raise AssertionError(f"{wav_path}: {linear.shape[1]} linear frames, "
                             f"{mel_frames} mel frames")

    # Reflect-pad as the centred STFT does, then cut so that
    # len(audio) == mel_frames * hop.
    pad = audio_cfg.fft_size // 2
    out = np.pad(out, pad, mode="reflect")
    if len(out) < mel_frames * audio_cfg.hop_size:
        raise AssertionError(f"{wav_path}: {len(out)} padded samples for "
                             f"{mel_frames} frames")
    out = out[:mel_frames * audio_cfg.hop_size]
    time_steps = len(out)

    codec = TextCodec(cfg.tacotron.cleaners)
    wav_id = os.path.splitext(os.path.basename(wav_path))[0]
    npz_filename = f"{wav_id}.npz"
    np.savez(
        os.path.join(out_dir, npz_filename),
        audio=out.astype(out_dtype),
        mel=mel.T,                      # [frames, num_mels]
        linear=linear.T,                # [frames, num_freq]
        time_steps=time_steps,
        mel_frames=mel_frames,
        text=text,
        tokens=codec.encode(text),
        loss_coeff=1,
    )
    return (npz_filename, time_steps, mel_frames, text)


def _run_jobs(jobs, out_dir: str, cfg: Config, num_workers: int, tqdm,
              device: Device) -> List[Example]:
    dev = resolve_device(device)
    if num_workers <= 1:
        results = [_process_utterance(out_dir, w, t, cfg, dev)
                   for w, t in tqdm(jobs)]
    else:
        # Threads, as in JAX: the STFT, the wav decode and the npz write
        # release the interpreter lock, and threads share the device.
        with ThreadPoolExecutor(max_workers=num_workers) as ex:
            futures = [ex.submit(partial(_process_utterance, out_dir), w, t,
                                 cfg, dev) for w, t in jobs]
            results = [f.result() for f in tqdm(futures)]
    return [r for r in results if r is not None]


def build_from_json_corpus(cfg: Config, in_dir: str, out_dir: str,
                           json_name: str, num_workers: int = 1,
                           tqdm=lambda x: x, device: Device = None
                           ) -> List[Example]:
    """Build from a ``{wav_path: transcript}`` JSON map (the moon and son
    layout: the wavs under ``in_dir/audio/``)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(in_dir, json_name), encoding="utf-8") as f:
        data = json.load(f)

    jobs = []
    for key, text in data.items():
        wav_path = os.path.join(in_dir, "audio", key.strip().split("/")[-1])
        if not os.path.exists(wav_path):
            continue
        jobs.append((wav_path, text))
    return _run_jobs(jobs, out_dir, cfg, num_workers, tqdm, device)


def build_moon(cfg: Config, in_dir: str, out_dir: str, num_workers: int = 1,
               tqdm=lambda x: x, device: Device = None) -> List[Example]:
    return build_from_json_corpus(cfg, in_dir, out_dir,
                                  "moon-recognition-All.json", num_workers,
                                  tqdm, device)


def build_son(cfg: Config, in_dir: str, out_dir: str, num_workers: int = 1,
              tqdm=lambda x: x, device: Device = None) -> List[Example]:
    return build_from_json_corpus(cfg, in_dir, out_dir,
                                  "son-recognition-All.json", num_workers,
                                  tqdm, device)


def build_ljspeech(cfg: Config, in_dir: str, out_dir: str,
                   num_workers: int = 1, tqdm=lambda x: x,
                   device: Device = None) -> List[Example]:
    """LJSpeech-1.1 layout: ``metadata.csv`` rows ``id|raw|normalized``
    with the wavs at ``wavs/<id>.wav``.  Use ``english_cleaners`` in
    ``cfg.tacotron.cleaners`` so that the ASCII symbol table is chosen."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("|")
            if len(parts) < 2:
                continue
            wav_id, text = parts[0], parts[-1] or parts[1]
            wav_path = os.path.join(in_dir, "wavs", wav_id + ".wav")
            if os.path.exists(wav_path):
                jobs.append((wav_path, text))
    return _run_jobs(jobs, out_dir, cfg, num_workers, tqdm, device)


def build_cmu_arctic(cfg: Config, in_dir: str, out_dir: str,
                     num_workers: int = 1, tqdm=lambda x: x,
                     device: Device = None) -> List[Example]:
    """CMU ARCTIC layout: ``wav/<id>.wav`` and the festival prompt file
    ``etc/txt.done.data`` with rows ``( arctic_a0001 "Transcript." )``;
    other rows are skipped.  Use ``english_cleaners``."""
    os.makedirs(out_dir, exist_ok=True)
    prompt_path = os.path.join(in_dir, "etc", "txt.done.data")
    row = re.compile(r'^\(\s*(\S+)\s+"(.*)"\s*\)\s*$')
    jobs = []
    with open(prompt_path, encoding="utf-8") as f:
        for line in f:
            m = row.match(line.strip())
            if not m:
                continue
            wav_id, text = m.group(1), m.group(2)
            wav_path = os.path.join(in_dir, "wav", wav_id + ".wav")
            if os.path.exists(wav_path):
                jobs.append((wav_path, text))
    return _run_jobs(jobs, out_dir, cfg, num_workers, tqdm, device)


CORPUS_BUILDERS = {
    "moon": build_moon,
    "son": build_son,
    "ljspeech": build_ljspeech,
    "cmu_arctic": build_cmu_arctic,
}


def write_metadata(examples: List[Example], out_dir: str, cfg: Config
                   ) -> None:
    """``train.txt`` (one ``name|time_steps|mel_frames|text`` row per
    example) and the corpus's size on stdout."""
    with open(os.path.join(out_dir, "train.txt"), "w", encoding="utf-8") as f:
        for ex in examples:
            f.write("|".join(str(x) for x in ex) + "\n")
    frames = sum(ex[2] for ex in examples)
    hours = frames * cfg.audio.frame_shift_ms / (3600 * 1000)
    print(f"Wrote {len(examples)} utterances, {frames} frames "
          f"({hours:.2f} hours)")
    if examples:
        print(f"Max mel frames: {max(ex[2] for ex in examples)}")
        print(f"Max audio timesteps: {max(ex[1] for ex in examples)}")


def preprocess_corpus(cfg: Config, name: str, in_dir: str, out_dir: str,
                      num_workers: int = 1, device: Device = None
                      ) -> List[Example]:
    """Build corpus ``name`` (a key of ``CORPUS_BUILDERS``) from ``in_dir``
    into ``out_dir`` with its ``train.txt``; the spectrograms are computed
    on ``device`` (``cuda`` unless the caller asks for another)."""
    if name not in CORPUS_BUILDERS:
        raise KeyError(f"unknown corpus {name!r}; have "
                       f"{sorted(CORPUS_BUILDERS)}")
    try:
        from tqdm import tqdm as _tqdm
    except ImportError:
        _tqdm = lambda x: x
    examples = CORPUS_BUILDERS[name](cfg, in_dir, out_dir, num_workers,
                                     _tqdm, device)
    write_metadata(examples, out_dir, cfg)
    return examples
