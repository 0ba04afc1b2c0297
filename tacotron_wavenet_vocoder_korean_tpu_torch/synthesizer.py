"""Tacotron synthesis CLI, text -> mel -> Griffin-Lim wav (counterpart of
the JAX package's ``synthesizer.py``).

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.synthesizer \\
        --load_path artifacts/both_r2.ckpt.tar.gz \\
        --text "존경하는 국민 여러분" --base_path out

Writes ``{i}.wav``, ``{i}.mel.npy`` and ``{i}.png`` per text under
``--base_path`` (``{i}_manual.*`` with ``--manual_attention_mode``).  Runs
on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from .synth.synthesizer import Synthesizer


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--load_path", required=True,
                   help="trained run: run dir or *.ckpt.tar.gz")
    p.add_argument("--text", action="append", required=True,
                   help="text to synthesize (repeatable)")
    p.add_argument("--base_path", default="samples")
    p.add_argument("--speaker_id", type=int, action="append", default=None)
    p.add_argument("--manual_attention_mode", type=int, default=0,
                   choices=[0, 1, 2, 3])
    p.add_argument("--no_attention_trim", action="store_true")
    p.add_argument("--max_iters", type=int, default=None)
    p.add_argument("--fused_rnn", action="store_true",
                   help="accepted for the JAX CLI's sake; no effect: the "
                        "port always serves the fused GRUs")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    synth = Synthesizer.from_checkpoint(args.load_path, args.device)
    results = synth.synthesize(
        args.text, base_path=args.base_path, speaker_ids=args.speaker_id,
        attention_trim=not args.no_attention_trim,
        manual_attention_mode=args.manual_attention_mode,
        max_iters=args.max_iters)
    for r in results:
        print(f"{r['text']!r} -> {r.get('wav_path')} "
              f"({len(r['wav'])} samples)")


if __name__ == "__main__":
    main()
