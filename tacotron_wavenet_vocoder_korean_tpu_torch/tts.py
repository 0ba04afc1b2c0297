"""End-to-end TTS CLI: text -> Tacotron mel -> WaveNet (and Griffin-Lim)
wav (counterpart of the JAX package's ``tts.py``).

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.tts \\
        --tacotron artifacts/both_r2.ckpt.tar.gz \\
        --wavenet artifacts/wn_moon.ckpt.tar.gz \\
        --text "존경하는 국민 여러분" --speaker_id 0 --out_dir out

Writes ``{i}.wav`` (Griffin-Lim), ``{i}.wavenet.wav``, ``{i}.mel.npy`` and
``{i}.png`` per text under ``--out_dir``.  Runs on the GPU unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from .synth.e2e import TTSPipeline


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tacotron", required=True,
                   help="Tacotron run: run dir or *.ckpt.tar.gz")
    p.add_argument("--wavenet", default=None,
                   help="WaveNet run (omit for Griffin-Lim only)")
    p.add_argument("--text", action="append", required=True)
    p.add_argument("--out_dir", default="samples")
    p.add_argument("--speaker_id", type=int, action="append", default=None)
    p.add_argument("--fused_rnn", action="store_true",
                   help="accepted for the JAX CLI's sake; no effect: the "
                        "port always serves the fused GRUs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    pipe = TTSPipeline.from_checkpoint(args.tacotron, args.wavenet,
                                       args.device)
    results = pipe.tts(args.text, base_path=args.out_dir,
                       speaker_ids=args.speaker_id)
    for r in results:
        line = f"{r['text']!r} -> GL: {r.get('wav_path')}"
        if "wavenet_wav_path" in r:
            line += f", WaveNet: {r['wavenet_wav_path']}"
        print(line)


if __name__ == "__main__":
    main()
