"""WaveNet waveform generation CLI (counterpart of the JAX package's
``generate.py``).

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.generate \\
        --load_path artifacts/wn_moon.ckpt.tar.gz \\
        --mel samples/e2e_both_r2_wn_moon/0.mel.npy --out out.wav

Weights come from ``--load_path`` (a training run dir or its
``*.ckpt.tar.gz``: the latest step's ``ema_params``, or its ``params``
with ``--no_ema``), from ``--weights`` (an ``.npz`` of JAX-named
parameters) or, with ``--init_seed N``, are made at full width from a
seed.  ``--config`` names the ``params.json`` (or a run dir or tarball
holding one); by default the checkpoint's with ``--load_path``, else
``wn_moon``'s.  Up to 8 ``--mel`` inputs are vocoded per kernel launch.
``--temperature`` scales the softmax head of a ``mulaw-quantize`` model.
Runs on the GPU (bf16 weights) unless ``--device cpu`` (f32 weights) is
given.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .dsp.audio_io import load_wav
from .synth.generator import MAX_STREAMS, WaveNetGenerator

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONFIG = os.path.join(REPO_DIR, "artifacts", "wn_moon.ckpt.tar.gz")


def out_names(mels: List[str], out: Optional[str]) -> List[str]:
    if out is None:
        return [m.rsplit(".", 1)[0] + ".gen.wav" for m in mels]
    if len(mels) == 1:
        return [out]
    stem, ext = os.path.splitext(out)       # out.wav -> out_0.wav, ...
    return [f"{stem}_{i}{ext or '.wav'}" for i in range(len(mels))]


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--load_path",
                     help="trained run: run dir or *.ckpt.tar.gz")
    src.add_argument("--weights", help=".npz of JAX-named WaveNet params")
    src.add_argument("--init_seed", type=int,
                     help="seeded full-width weights instead of --weights")
    p.add_argument("--no_ema", action="store_true",
                   help="with --load_path: raw params instead of the EMA")
    p.add_argument("--config", default=None,
                   help="params.json, run dir, or *.ckpt.tar.gz (default: "
                        "the checkpoint's, else wn_moon's)")
    p.add_argument("--mel", action="append", required=True,
                   help="mel .npy (repeatable)")
    p.add_argument("--out", default=None,
                   help="output wav (default: <mel>.gen.wav)")
    p.add_argument("--gc_id", type=int, default=None, help="speaker id")
    p.add_argument("--wav_seed", default=None,
                   help="wav that primes generation (teacher-forced)")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="softmax temperature (mulaw-quantize models only)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.load_path:
        gen = WaveNetGenerator.from_checkpoint(
            args.load_path, args.device, use_ema=not args.no_ema,
            config=args.config)
    else:
        gen = WaveNetGenerator.load(args.weights,
                                    args.config or DEFAULT_CONFIG,
                                    args.device, init_seed=args.init_seed)
    wav_seed = (load_wav(args.wav_seed, gen.cfg.audio.sample_rate)
                if args.wav_seed else None)
    outs = out_names(args.mel, args.out)
    for lo in range(0, len(args.mel), MAX_STREAMS):
        mels, dests = args.mel[lo:lo + MAX_STREAMS], outs[lo:lo + MAX_STREAMS]
        gen.generate_to_file(mels, dests, speaker_id=args.gc_id,
                             wav_seed=wav_seed, temperature=args.temperature)
        for m, o in zip(mels, dests):
            print(f"{m} -> {o}")


if __name__ == "__main__":
    main()
