"""WaveNet waveform generation CLI (counterpart of the JAX package's
``generate.py``).

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.generate \\
        --init_seed 0 --mel samples/both_r2/0.mel.npy --out out.wav

Weights come from ``--weights`` (an ``.npz`` of JAX-named parameters) or,
with ``--init_seed N``, are made at full width from a seed.  ``--config``
names the ``params.json`` (or a checkpoint tarball holding it).  Up to 8
``--mel`` inputs are vocoded per kernel launch.  Runs on the GPU unless
``--device cpu`` is given.
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
    src.add_argument("--weights", help=".npz of JAX-named WaveNet params")
    src.add_argument("--init_seed", type=int,
                     help="seeded full-width weights instead of --weights")
    p.add_argument("--config", default=DEFAULT_CONFIG,
                   help="params.json, run dir, or *.ckpt.tar.gz")
    p.add_argument("--mel", action="append", required=True,
                   help="mel .npy (repeatable)")
    p.add_argument("--out", default=None,
                   help="output wav (default: <mel>.gen.wav)")
    p.add_argument("--gc_id", type=int, default=None, help="speaker id")
    p.add_argument("--wav_seed", default=None,
                   help="wav that primes generation (teacher-forced)")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="softmax temperature; only 1.0 until the "
                   "mulaw-quantize softmax head is ported")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.temperature != 1.0:
        raise NotImplementedError(
            "--temperature applies to the mulaw-quantize softmax head, which "
            "is not ported yet")

    gen = WaveNetGenerator.load(args.weights, args.config, args.device,
                                init_seed=args.init_seed)
    wav_seed = (load_wav(args.wav_seed, gen.cfg.audio.sample_rate)
                if args.wav_seed else None)
    outs = out_names(args.mel, args.out)
    for lo in range(0, len(args.mel), MAX_STREAMS):
        mels, dests = args.mel[lo:lo + MAX_STREAMS], outs[lo:lo + MAX_STREAMS]
        gen.generate_to_file(mels, dests, speaker_id=args.gc_id,
                             wav_seed=wav_seed)
        for m, o in zip(mels, dests):
            print(f"{m} -> {o}")


if __name__ == "__main__":
    main()
