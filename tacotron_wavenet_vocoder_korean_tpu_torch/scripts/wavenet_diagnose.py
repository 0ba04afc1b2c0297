"""Training-health diagnostic for a WaveNet run: one-step-ahead accuracy
(counterpart of the JAX system's ``scripts/wavenet_diagnose.py``).

Free-run WaveNet output stays noise-like for the first couple hundred
thousand steps (reference ReadMe.md:111,115), which makes it hard to tell a
healthy-but-young model from a broken generation path.  This separates the
two: teacher-forced (one-step-ahead) prediction on held-out crops uses the
TRUE history, so it isolates the learned conditional p(x_t | x_<t, mel)
from autoregressive drift.  A healthy run shows correlation near 1 long
before free-run audio is speech; a generation-path bug does not.

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.scripts.wavenet_diagnose \\
        --wavenet logs/wn_moon --data workdir/moon/data [--n_crops 4]

The crops are the test stream of ``WaveNetBatcher`` (seeded ``--seed``),
run through the training graph with the EMA parameters; no generation
kernel is launched.  Crop i's mixture draw takes its uniforms from a CPU
``torch.Generator`` seeded ``i + 1``, so the card and the CPU score the
same draws.  Prints one JSON line with JAX's keys (``RESULT_KEYS``).
Runs on the GPU unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.loader import WaveNetBatcher
from ..device import no_tf32, resolve_device
from ..models.mixture import sample_from_discretized_mix_logistic
from ..models.wavenet import WaveNet
from ..synth.generator import WaveNetGenerator
from ..train.wavenet_task import batch_to_device

RESULT_KEYS = frozenset(("step", "n_crops", "one_step_ahead_corr",
                         "one_step_ahead_mae", "per_crop_corr", "healthy"))


def mol_uniforms(shape: Tuple[int, ...], nr_mix: int, seed: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mixture sampler's uniforms for ``shape`` positions, ``(u_sel
    [*shape, nr_mix], u [*shape])``, drawn on the CPU from a generator
    seeded ``seed``."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(tuple(shape) + (nr_mix + 1,), generator=g)
    return u[..., :nr_mix], u[..., nr_mix]


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--wavenet", required=True,
                   help="wavenet run dir, its ckpt/ or a *.ckpt.tar.gz")
    p.add_argument("--data", required=True, help="preprocessed corpus dir")
    p.add_argument("--n_crops", type=int, default=4)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    # the generator's restore path: config, EMA params (weight norm folded)
    # and step
    gen = WaveNetGenerator.from_checkpoint(args.wavenet, dev)
    cfg, params = gen.cfg, gen.params
    model = WaveNet(dataclasses.replace(cfg.wavenet,
                                        weight_normalization=False))
    batcher = WaveNetBatcher([args.data], cfg, batch_size=1,
                             data_type="test", seed=args.seed)
    it = iter(batcher)
    nr_mix = cfg.wavenet.out_channels // 3

    corrs, maes = [], []
    for i in range(args.n_crops):
        bd = batch_to_device(next(it), dev)
        with torch.no_grad(), no_tf32():
            out = model(params, bd["input_wav"], bd["local_condition"])
            raw = out["raw_output"]
            u_sel, u = mol_uniforms(raw.shape[:-1], nr_mix, i + 1)
            pred = sample_from_discretized_mix_logistic(
                raw, uniforms=(u_sel.to(dev), u.to(dev)))
        pred = pred.cpu().numpy()
        tgt = out["target"].cpu().numpy()
        if tgt.ndim == 3:
            tgt = tgt[..., 0]
        n = min(pred.shape[-1], tgt.shape[-1])
        a, b = pred[0, -n:].ravel(), tgt[0, -n:].ravel()
        corrs.append(float(np.corrcoef(a, b)[0, 1]))
        maes.append(float(np.abs(a - b).mean()))

    result = {
        "step": gen.step,
        "n_crops": args.n_crops,
        "one_step_ahead_corr": round(float(np.mean(corrs)), 4),
        "one_step_ahead_mae": round(float(np.mean(maes)), 4),
        "per_crop_corr": [round(c, 4) for c in corrs],
        "healthy": bool(np.mean(corrs) > 0.9),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
