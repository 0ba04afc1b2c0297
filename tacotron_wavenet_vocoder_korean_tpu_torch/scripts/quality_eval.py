"""End-to-end quality evaluation: MCD of synthesized speech vs real speech
(counterpart of the JAX system's ``scripts/quality_eval.py``).

For each sampled corpus utterance:
  * oracle  -- Griffin-Lim on the REAL linear spectrogram vs the real audio
               (the vocoder bound: no acoustic model involved)
  * synth   -- text -> Tacotron -> Griffin-Lim vs the real audio
  * e2e     -- with ``--wavenet``: text -> Tacotron mel -> WaveNet wav vs
               the real audio (one launch of the generation kernel per
               utterance)

The gap synth - oracle isolates the acoustic model's contribution.  Prints
one JSON line with JAX's keys (``RESULT_KEYS``), with a per-speaker
breakdown (speaker id = position in the ``--data`` list, as training
numbers the dirs).

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.scripts.quality_eval \\
        --tacotron logs/both --data workdir/moon/data,workdir/son/data \\
        [--n 6] [--heldout] [--wavenet logs/wn_moon] [--no_persist]

``--tacotron`` and ``--wavenet`` are run dirs, their ``ckpt/`` or
``*.ckpt.tar.gz``.  ``--heldout`` scores only the run's held-out split,
rebuilt as training drew it (one ``TacotronBatcher`` over all of
``--data``, in training order).  ``--inference_dropout`` auto|on|off sets
the decoder prenet's dropout (auto: the run's config).  ``--fused_rnn`` is
accepted and has no effect: the port always serves fused GRUs.  The result
goes to ``eval.json`` in the Tacotron run dir, and one line is appended to
its ``eval_history.jsonl``, unless ``--no_persist``; a tarball with
persistence asked for raises before any work.  Runs on the GPU unless
``--device cpu`` is given; with no GPU and no ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..data.loader import TacotronBatcher
from ..device import resolve_device
from ..dsp.audio_io import save_wav
from ..dsp.griffin_lim import inv_linear_spectrogram
from ..synth.generator import WaveNetGenerator
from ..synth.synthesizer import Synthesizer
from ..utils.metrics import mcd
from .vocoder_eval import persist, persist_dir

RESULT_KEYS = frozenset((
    "metric", "n_utterances", "heldout_only", "inference_dropout",
    "synth_mcd_db", "oracle_mcd_db", "gap_db", "checkpoint_step",
    "per_speaker"))
E2E_KEYS = frozenset(("e2e_mcd_db", "e2e_vocoder", "e2e_vocoder_step"))
SPEAKER_KEYS = frozenset(("n", "synth_mcd_db", "oracle_mcd_db", "gap_db",
                          "per_utt_synth", "per_utt_oracle"))
SPEAKER_E2E_KEYS = frozenset(("e2e_mcd_db", "per_utt_e2e"))


def speaker_key(sid: int, data_dir: str) -> str:
    """``<sid>:<the dir's parent's name>``: the id keeps two dirs with one
    parent name apart."""
    name = (os.path.basename(os.path.dirname(os.path.normpath(data_dir)))
            or data_dir)
    return f"{sid}:{name}"


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tacotron", required=True,
                   help="tacotron run dir, its ckpt/ or a *.ckpt.tar.gz")
    p.add_argument("--data", type=lambda s: s.split(","), required=True,
                   help="preprocessed npz dir(s), comma separated; order "
                        "must match training so speaker ids line up")
    p.add_argument("--n", type=int, default=6,
                   help="utterances to score per speaker")
    p.add_argument("--heldout", action="store_true",
                   help="score ONLY the run's held-out split (rebuilt with "
                        "the run config's seed and num_test_per_speaker; "
                        "--data must list ALL training dirs in train order)")
    p.add_argument("--skip_path_filter", action="store_true",
                   help="must match the flag the training run used, or the "
                        "rebuilt held-out split will differ")
    p.add_argument("--out_dir", default=None,
                   help="optionally save synthesized wavs here")
    p.add_argument("--wavenet", default=None,
                   help="wavenet run: also score text -> Tacotron mel -> "
                        "WaveNet wav as e2e_mcd_db")
    p.add_argument("--e2e_max_frames", type=int, default=None,
                   help="smoke only: cap the mel frames fed to the vocoder "
                        "(truncates the e2e comparison)")
    p.add_argument("--no_persist", action="store_true",
                   help="print the JSON but do not write eval.json / "
                        "eval_history.jsonl into the run dir")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--fused_rnn", action="store_true",
                   help="accepted for the JAX command's sake; no effect")
    p.add_argument("--inference_dropout", choices=("auto", "on", "off"),
                   default="auto",
                   help="decoder-prenet dropout at inference: 'auto' follows "
                        "the run config (the reference keeps it ON); "
                        "'on'/'off' force it")
    args = p.parse_args(argv)

    run = persist_dir(args.tacotron, args.no_persist)
    dev = resolve_device(args.device)
    synth = Synthesizer.from_checkpoint(
        args.tacotron, dev, inference_dropout={
            "auto": None, "on": True, "off": False}[args.inference_dropout])
    cfg = synth.cfg
    vocoder = (WaveNetGenerator.from_checkpoint(args.wavenet, dev)
               if args.wavenet else None)

    heldout_batcher = None
    if args.heldout:
        # The training batcher shuffles every dir's paths from ONE
        # RandomState in --data order, so the split is rebuilt only by one
        # batcher over ALL dirs in that order.  apply_filter None follows
        # the run config's train.skip_path_filter.
        heldout_batcher = TacotronBatcher(
            args.data, cfg, "test", batch_size=1,
            apply_filter=False if args.skip_path_filter else None)

    def pick_paths(data_dir: str) -> List[str]:
        if heldout_batcher is not None:
            paths = sorted(heldout_batcher.path_dict[data_dir])
        else:
            paths = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
        return paths[:: max(1, len(paths) // args.n)][:args.n]

    def gl_wav(linear: np.ndarray) -> np.ndarray:
        return inv_linear_spectrogram(torch.from_numpy(linear.T.copy()).to(
            dev), cfg.audio).cpu().numpy()

    per_speaker = {}
    all_synth, all_oracle = [], []
    e2e_jobs = []
    for sid, data_dir in enumerate(args.data):
        oracle_scores, synth_scores = [], []
        for path in pick_paths(data_dir):
            with np.load(path) as d:
                real = np.asarray(d["audio"], np.float32)
                linear = np.asarray(d["linear"], np.float32)
                text = str(d["text"])
            oracle_scores.append(mcd(gl_wav(linear), real, cfg.audio))

            out = synth.synthesize([text], speaker_ids=[sid],
                                   save_alignment=False, save_mel=False)
            wav = out[0]["wav"]
            synth_scores.append(mcd(wav, real, cfg.audio))
            base = os.path.splitext(os.path.basename(path))[0]
            if vocoder is not None:
                e2e_jobs.append({"sid": sid, "real": real,
                                 "mel": out[0]["mel"], "base": base})
            if args.out_dir:
                os.makedirs(args.out_dir, exist_ok=True)
                save_wav(wav, os.path.join(args.out_dir,
                                           f"{sid}_{base}.synth.wav"),
                         cfg.audio.sample_rate)

        per_speaker[speaker_key(sid, data_dir)] = {
            "n": len(synth_scores),
            "synth_mcd_db": round(float(np.mean(synth_scores)), 2),
            "oracle_mcd_db": round(float(np.mean(oracle_scores)), 2),
            "gap_db": round(float(np.mean(synth_scores)
                                  - np.mean(oracle_scores)), 2),
            "per_utt_synth": [round(s, 2) for s in synth_scores],
            "per_utt_oracle": [round(s, 2) for s in oracle_scores],
        }
        all_synth += synth_scores
        all_oracle += oracle_scores

    e2e_field = {}
    if vocoder is not None and e2e_jobs:
        # Every free-run mel is padded with silence to ONE shared frame
        # count, as in JAX (where it let XLA compile the kernel once), and
        # each wav cut back; kept so that the scores mean what JAX's meant.
        hop = cfg.audio.hop_size
        pad_val = (-cfg.audio.max_abs_value if cfg.audio.symmetric_mels
                   else 0.0)
        if args.e2e_max_frames:
            for j in e2e_jobs:
                j["mel"] = j["mel"][:args.e2e_max_frames]
                j["real"] = j["real"][:args.e2e_max_frames * hop]
        f_max = max(len(j["mel"]) for j in e2e_jobs)
        per_sid_scores = {}
        for j in e2e_jobs:
            n_frames = len(j["mel"])
            mel_pad = np.pad(j["mel"], ((0, f_max - n_frames), (0, 0)),
                             constant_values=pad_val)
            wav = vocoder.generate(mel_pad)[:n_frames * hop]
            score = mcd(wav, j["real"], cfg.audio)
            per_sid_scores.setdefault(j["sid"], []).append(round(score, 2))
            if args.out_dir:
                save_wav(wav, os.path.join(
                    args.out_dir, f"{j['sid']}_{j['base']}.e2e.wav"),
                    cfg.audio.sample_rate)
        all_e2e = [s for scores in per_sid_scores.values() for s in scores]
        for key, entry in per_speaker.items():
            scores = per_sid_scores.get(int(key.split(":", 1)[0]))
            if scores:
                entry["e2e_mcd_db"] = round(float(np.mean(scores)), 2)
                entry["per_utt_e2e"] = scores
        e2e_field = {
            "e2e_mcd_db": round(float(np.mean(all_e2e)), 2),
            "e2e_vocoder": args.wavenet,
            "e2e_vocoder_step": vocoder.step,
        }

    result = {
        "metric": "mcd_db",
        "n_utterances": len(all_synth),
        **e2e_field,
        "heldout_only": bool(args.heldout),
        "inference_dropout": args.inference_dropout,
        "synth_mcd_db": round(float(np.mean(all_synth)), 2),
        "oracle_mcd_db": round(float(np.mean(all_oracle)), 2),
        "gap_db": round(float(np.mean(all_synth) - np.mean(all_oracle)), 2),
        "checkpoint_step": synth.step,
        "per_speaker": per_speaker,
    }
    print(json.dumps(result))
    persist(run, result)
    return result


if __name__ == "__main__":
    main()
