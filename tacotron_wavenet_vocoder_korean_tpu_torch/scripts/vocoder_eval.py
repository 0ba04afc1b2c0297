"""WaveNet vocoder quality evaluation: MCD of vocoded speech vs real speech
(counterpart of the JAX system's ``scripts/vocoder_eval.py``).

For sampled corpus utterances, vocode the GROUND-TRUTH mel with the trained
WaveNet (EMA params, one launch of the generation kernel per clip) and
score DTW-MCD against the real audio; the Griffin-Lim-on-real-linear
oracle is reported for context (the reference's baseline vocoder).  Prints
one JSON line, with JAX's keys (``RESULT_KEYS``).

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.scripts.vocoder_eval \\
        --wavenet logs/wn_moon --data workdir/moon/data [--n 3] \\
        [--unseen_data workdir/son/data] [--out_dir DIR] [--no_persist]

``--wavenet`` is a run dir, its ``ckpt/`` or a ``*.ckpt.tar.gz``.  The
result goes to ``eval.json`` in the run dir, and one line is appended to
its ``eval_history.jsonl``, unless ``--no_persist``; a tarball with
persistence asked for raises before any work.  Runs on the GPU unless
``--device cpu`` is given; with no GPU and no ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..dsp.audio_io import save_wav
from ..dsp.griffin_lim import inv_linear_spectrogram
from ..synth.generator import WaveNetGenerator
from ..utils.metrics import mcd

RESULT_KEYS = frozenset((
    "metric", "n_utterances", "wavenet_mcd_db", "gl_oracle_mcd_db",
    "heldout_wavenet_mcd_db", "n_heldout", "heldout_same_speaker_mcd_db",
    "unseen_speaker_mcd_db", "unseen_speaker_gl_oracle_mcd_db",
    "checkpoint_step", "gen_realtime_factor", "per_utt"))


def select_eval_paths(all_paths: Sequence[str], n: int, n_test: int
                      ) -> Tuple[List[str], Set[str]]:
    """Pick eval utterances: every truly held-out clip (the loader's split:
    the last ``n_test`` of the sorted paths when the corpus is big enough),
    then an even spread over the rest up to ``n`` total.  Returns (paths,
    heldout_set)."""
    held = set(all_paths[-n_test:]) if len(all_paths) >= 2 * n_test else set()
    rest = [p_ for p_ in all_paths if p_ not in held]
    budget = max(0, n - len(held))
    rest = rest[:: max(1, len(rest) // budget)][:budget] if budget else []
    return sorted(held) + rest, held


def unseen_paths(data_dir: str, n_unseen: int) -> List[str]:
    """An even spread of ``n_unseen`` clips of a corpus the run never
    trained on."""
    dpaths = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    return dpaths[:: max(1, len(dpaths) // n_unseen)][:n_unseen]


def persist_dir(run: str, no_persist: bool) -> Optional[str]:
    """The run dir ``eval.json`` goes into (``None`` with
    ``no_persist``).  A ``*.ckpt.tar.gz`` has none: raises ``ValueError``
    before any work."""
    if no_persist:
        return None
    if not os.path.isdir(run):
        raise ValueError(f"{run} is not a run dir (a checkpoint tarball?): "
                         "eval.json and eval_history.jsonl go into the run "
                         "dir; give the run dir, or pass --no_persist")
    return run


def persist(run: Optional[str], result: dict) -> None:
    """``eval.json`` beside the checkpoint it measures, and one line
    appended to the run's ``eval_history.jsonl`` (the score-vs-step
    history)."""
    if run is None:
        return
    with open(os.path.join(run, "eval.json"), "w") as f:
        json.dump(result, f, indent=1)
    with open(os.path.join(run, "eval_history.jsonl"), "a") as f:
        f.write(json.dumps(result) + "\n")


def _mean(scores: List[float], idx: Optional[List[int]] = None
          ) -> Optional[float]:
    if idx is not None:
        if not idx:
            return None
        scores = [scores[i] for i in idx]
    return round(float(np.mean(scores)), 2)


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--wavenet", required=True,
                   help="wavenet run dir, its ckpt/ or a *.ckpt.tar.gz")
    p.add_argument("--data", required=True, help="preprocessed npz dir")
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--unseen_data", type=lambda s: s.split(","), default=None,
                   help="extra npz dir(s) the vocoder NEVER trained on (e.g. "
                        "a different speaker's corpus): their clips are "
                        "scored the same way and counted as heldout (the "
                        "model is mel-conditioned only, so cross-speaker "
                        "vocoding is well-defined)")
    p.add_argument("--n_unseen", type=int, default=8,
                   help="clips to score per --unseen_data dir")
    p.add_argument("--max_frames", type=int, default=240,
                   help="cap mel length per utterance (3 s default)")
    p.add_argument("--out_dir", default=None,
                   help="write each vocoded clip as <utt>.wn.wav here")
    p.add_argument("--no_persist", action="store_true",
                   help="print the JSON but do not write eval.json / "
                        "eval_history.jsonl into the run dir")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    run = persist_dir(args.wavenet, args.no_persist)
    dev = resolve_device(args.device)
    gen = WaveNetGenerator.from_checkpoint(args.wavenet, dev)
    cfg = gen.cfg
    hop = cfg.audio.hop_size

    all_paths = sorted(glob.glob(os.path.join(args.data, "*.npz")))
    # Every truly held-out clip, then the rest of the budget spread over
    # the corpus (the vocoder reads ground-truth acoustics, so copy
    # synthesis of training clips is a meaningful secondary sample; the
    # heldout subset is reported apart).
    paths, held = select_eval_paths(
        all_paths, args.n, max(1, cfg.train.num_test_per_speaker))
    # Clips of other corpora (an unseen speaker) count as heldout.
    unseen = set()
    for d in (args.unseen_data or []):
        pick = unseen_paths(d, args.n_unseen)
        unseen.update(pick)
        paths = paths + pick
    held = held | unseen

    pad_val = -cfg.audio.max_abs_value if cfg.audio.symmetric_mels else 0.0
    wn_scores, gl_scores, rtfs = [], [], []
    for path in paths:
        with np.load(path) as d:
            real = np.asarray(d["audio"], np.float32)
            mel = np.asarray(d["mel"], np.float32)
            linear = np.asarray(d["linear"], np.float32)
        n_frames = min(len(mel), args.max_frames)
        mel, linear = mel[:n_frames], linear[:n_frames]
        real_cut = real[:n_frames * hop]

        # Every mel is padded with silence to --max_frames, as in JAX (where
        # it let XLA compile the kernel once), and the wav cut back.  The
        # padding also sets the upsampler's context at the cut and the
        # length the kernel runs, so it stays for the scores to mean what
        # JAX's meant; vocoding n_frames alone is a later speed item.
        mel_pad = np.pad(mel, ((0, args.max_frames - n_frames), (0, 0)),
                         constant_values=pad_val)
        t0 = time.perf_counter()
        wav = gen.generate(mel_pad)[:n_frames * hop]
        dt = time.perf_counter() - t0
        rtfs.append(len(wav) / dt / cfg.audio.sample_rate)
        wn_scores.append(mcd(wav, real_cut, cfg.audio))
        # The oracle's linear spectrogram is padded the same way (with its
        # own minimum), as JAX pads it.
        lin_pad = np.pad(linear, ((0, args.max_frames - n_frames), (0, 0)),
                         constant_values=linear.min())
        gl = inv_linear_spectrogram(torch.from_numpy(lin_pad.T.copy()).to(dev),
                                    cfg.audio)[:n_frames * hop].cpu().numpy()
        gl_scores.append(mcd(gl, real_cut, cfg.audio))
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            base = os.path.splitext(os.path.basename(path))[0]
            save_wav(wav, os.path.join(args.out_dir, base + ".wn.wav"),
                     cfg.audio.sample_rate)

    held_idx = [i for i, p_ in enumerate(paths) if p_ in held]
    same_idx = [i for i in held_idx if paths[i] not in unseen]
    unseen_idx = [i for i in held_idx if paths[i] in unseen]
    result = {
        "metric": "vocoder_mcd_db",
        "n_utterances": len(paths),
        "wavenet_mcd_db": _mean(wn_scores),
        "gl_oracle_mcd_db": _mean(gl_scores),
        # never-trained-on clips only: the loader's heldout split plus the
        # --unseen_data clips
        "heldout_wavenet_mcd_db": _mean(wn_scores, held_idx),
        "n_heldout": len(held_idx),
        "heldout_same_speaker_mcd_db": _mean(wn_scores, same_idx),
        "unseen_speaker_mcd_db": _mean(wn_scores, unseen_idx),
        "unseen_speaker_gl_oracle_mcd_db": _mean(gl_scores, unseen_idx),
        "checkpoint_step": gen.step,
        # median: the first call also pays the kernel's build
        "gen_realtime_factor": round(float(np.median(rtfs)), 2),
        "per_utt": [
            {"utt": os.path.splitext(os.path.basename(p_))[0],
             "heldout": p_ in held,
             **({"unseen_speaker": True} if p_ in unseen else {}),
             "wavenet_mcd_db": round(wn_scores[i], 2),
             "gl_mcd_db": round(gl_scores[i], 2)}
            for i, p_ in enumerate(paths)],
    }
    print(json.dumps(result))
    persist(run, result)
    return result


if __name__ == "__main__":
    main()
