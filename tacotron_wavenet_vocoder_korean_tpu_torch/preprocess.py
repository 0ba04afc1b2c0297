"""Corpus preprocessing CLI (counterpart of the root ``preprocess.py``).

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.preprocess \\
        --name moon --in_dir datasets/moon --out_dir datasets/moon/data \\
        --num_workers 4

Writes one ``.npz`` per utterance, ``train.txt`` and the default config's
``params.json`` into ``--out_dir`` (default ``<in_dir>/data``).  The
spectrograms are computed on the GPU unless ``--device cpu`` is given;
with no GPU and no ``--device cpu`` the command raises.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .config import Config, save_config
from .data.corpus import CORPUS_BUILDERS, preprocess_corpus
from .device import resolve_device


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--name", required=True,
                   help="corpus name: " + " | ".join(CORPUS_BUILDERS))
    p.add_argument("--in_dir", required=True)
    p.add_argument("--out_dir", default=None)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    out_dir = args.out_dir or os.path.join(args.in_dir, "data")
    cfg = Config()
    os.makedirs(out_dir, exist_ok=True)
    save_config(cfg, out_dir)
    preprocess_corpus(cfg, args.name, args.in_dir, out_dir, args.num_workers,
                      device)


if __name__ == "__main__":
    main()
