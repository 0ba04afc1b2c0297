"""Where the generation kernel's step goes: time builds of
``csrc/wavenet_gen.cu`` with one part removed or swapped, f32 and bf16
weights, MoL head, full ``wn_moon`` width with seeded weights.

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.ablate_gen

Needs one CUDA card and ``nvcc``.  Each variant is the kernel's source with
one text substitution, built with the package's flags into a temporary
directory; the timings use the package's wrapper with that build bound in
its place, warmed up by a short launch.  What an ablated build computes is
not the model's function: only its time means anything.  Variants:

  base           the kernel as it is
  no_skip        the deferred skip product left out
  no_post1       the post1 product left out
  no_chain       the 50-layer chain left out (gated values from the lc row)
  column_loop    both weight types on the one-column skip/post1 loop
  octet_loop     both weight types on the eight-column 16-byte-load loop
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch

from .config import load_config
from .convert import seeded_params
from .models.wavenet import Upsampler
from .ops import build, wavenet_gen as G

REPO = os.path.dirname(build.PKG_DIR)
SOURCE = os.path.join(build.CSRC_DIR, "wavenet_gen.cu")

_SKIP = "    dense_relu(gat, w_skip, p.skip_bias, L * D, S, z, part, tid);\n"
_POST1 = "    dense_relu(z, post1, p.b1, S, S, z1, part, tid);\n"
_CHAIN = ("    for (int l = 0; l < L; ++l) {\n"
          "      // This layer's input goes into its ring at slot t mod d.\n")
_LOOP = "  if constexpr (sizeof(WT) == 4) {\n"
_ROW8_F32_DOT = ("  __device__ __forceinline__ float dot(const float* x) const {\n"
                 "    return x[0] * a.x")
_SMEM = "(bf16 ? 8 * NT : 0)"
_ROW8_F32_AT = ("  __device__ __forceinline__ float at(int i) const {\n"
                "    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};\n"
                "    return v[i];\n"
                "  }\n")

VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "base": [],
    "no_skip": [(_SKIP, "    for (int s = tid; s < S; s += NT) "
                        "z[s] = fmaxf(p.skip_bias[s], 0.f);\n"
                        "    __syncthreads();\n")],
    "no_post1": [(_POST1, "    for (int s = tid; s < S; s += NT) z1[s] = z[s];\n"
                          "    __syncthreads();\n")],
    "no_chain": [(_CHAIN, "    for (int i = tid; i < L * D; i += NT)\n"
                          "      gat[i] = rnd<WT>(0.01f * lcs[i]);\n"
                          "    __syncthreads();\n"
                          "    for (int l = 0; l < 0; ++l) {\n")],
    "column_loop": [(_LOOP, "  if constexpr (true) {\n")],
    "octet_loop": [(_LOOP, "  if constexpr (false) {\n"),
                   (_ROW8_F32_DOT, _ROW8_F32_AT + _ROW8_F32_DOT),
                   (_SMEM, "8 * NT")],
}


def variant_source(name: str) -> str:
    src = open(SOURCE, encoding="utf-8").read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the kernel source no longer holds "
                               f"{old!r} once")
        src = src.replace(old, new)
    return src


def build_all(out_dir: str) -> Dict[str, str]:
    """Every variant built in parallel (one nvcc each); name -> library."""
    procs = {}
    for name in VARIANTS:
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w", encoding="utf-8") as f:
            f.write(variant_source(name))
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        libs[name] = lib
    return libs


def _bind(path: str):
    fn = ctypes.CDLL(path).wavenet_gen_launch
    fn.argtypes = G._launcher().argtypes
    fn.restype = ctypes.c_int
    return fn


def _ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=8192)
    p.add_argument("--streams", type=int, default=4)
    p.add_argument("--reps", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gen: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = load_config(os.path.join(REPO, "artifacts", "wn_moon.ckpt.tar.gz"))
    w = cfg.wavenet
    B, T = args.streams, args.steps
    frames = -(-T // cfg.audio.hop_size)
    mel = np.stack([np.resize(np.load(os.path.join(
        REPO, "samples", "both_r2", f"{b % 4}.mel.npy")), (frames, 80))
        for b in range(B)]).astype(np.float32)
    params = seeded_params(w, 0, dev)
    with torch.no_grad():
        lc = Upsampler(w).load_params(params).to(dev)(
            torch.from_numpy(mel).to(dev))[:, :T]
        packs = {dt: G.pack_params(w, params, dt)
                 for dt in (torch.float32, torch.bfloat16)}
        projs = {dt: G.precompute_lc_proj(pk, lc) for dt, pk in packs.items()}
    print(f"card: {smi}; B={B} T={T}, us per step", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {name: _bind(lib) for name, lib in build_all(tmp).items()}
        kernel_launcher = G._launcher
        try:
            for rep in range(args.reps):
                for name, fn in fns.items():
                    G._launcher = lambda fn=fn: fn
                    row = []
                    for dt, pk in packs.items():
                        gen = torch.Generator(dev).manual_seed(0)
                        G.wavenet_generate(pk, projs[dt][:, :64].contiguous(),
                                           generator=gen)   # warm-up
                        t = _ms(lambda: G.wavenet_generate(pk, projs[dt],
                                                           generator=gen))
                        row.append(f"{str(dt)[6:]} {t / T * 1e3:6.1f}")
                    print(f"rep {rep} {name:12s} " + "  ".join(row),
                          flush=True)
        finally:
            G._launcher = kernel_launcher


if __name__ == "__main__":
    main()
