"""Where the generation kernel's step goes: time builds of
``csrc/wavenet_gen.cu`` with one part removed, and the previous step design
beside it, f32 and bf16 weights, MoL head, full ``wn_moon`` width with
seeded weights, one block per stream; with ``--split``, the split's
blocks per stream; with ``--clusters``, the cluster instance's.

    python -m tacotron_wavenet_vocoder_korean_tpu_torch.ablate_gen
    python -m tacotron_wavenet_vocoder_korean_tpu_torch.ablate_gen --split
    python -m tacotron_wavenet_vocoder_korean_tpu_torch.ablate_gen --clusters

``--split`` times wn_moon (R = D = 32, 50 layers, MoL head) at B = 1 and
8 streams, bf16 and f32, on one block per stream and on the split at
each of 2, 3, 4, 5 and 8 blocks per stream (``kernel_plan``'s is
marked), and in bf16 three builds of the split with one part removed:

  split_no_peer_wait  block 0 does not wait for the peers' post1 partials;
                      the chain's pushes and the peers' partials are
                      plain remote stores, and the peers wait for no layer
                      (they run on their own): what the wait after the
                      chain costs
  split_no_push       the chain pushes nothing, the peers send nothing and
                      wait for nothing, block 0 waits for nothing: block
                      0's step alone (against split_no_peer_wait, what
                      the pushes cost the chain)
  split_post1_global  the peers read their rows of post1 from L2, not from
                      shared memory

``--clusters`` times wn_moon's architecture at 4x its residual width (R =
D = 128, 50 layers: over one block's shared memory) at every cluster size
whose layout fits (2, 4, 8 blocks per stream; ``kernel_plan``'s is
marked), and at 2x (R = D = 64,
which fits one block) at 1, 2 and 4 blocks, MoL head, f32 and bf16,
through the wrapper's private ``blocks`` override; each size prints its
weight slots, shared memory per block and us per step.  At 4x it also
times two builds of the cluster instance with one part removed:

  cluster_no_exchange  no block sends its residual partials to its peers,
                       and each expects none (it sums what the buffers
                       hold): the exchange's stores and wait left out
  cluster_no_skip      the skip product left out

Needs one CUDA card and ``nvcc``.  Each variant is a kernel source with
text substitutions, built with the package's flags into a temporary
directory; a substitution that no longer matches its source exactly once
raises before anything is timed.  The timings use the package's wrapper
with that build bound in its place, warmed up by a short launch.  What an
ablated build computes is not the model's function: only its time means
anything.  Variants:

  base           the kernel as it is
  no_skip        the skip product left out (the skip warps idle)
  no_post1       the post1 product left out
  no_chain       the L-layer chain and its weight copies left out (gated
                 values from the lc row)
  chain_no_wait  the chain reads its weight slots without waiting for them
  chain_no_tap   the chain's tap products left out
  chain_no_gate  tanh * sigmoid replaced by a sum
  chain_no_res   the chain's residual products left out
  skip_u8        the skip warps load 8 rows at once in f32 too (16 in
                 the kernel)
  skip_roundsN   the skip warps wait for N layers (or the last) before
                 each round (N = 4, 12, 50: 50 runs the skip after the chain)
  skip_all_warps the skip product also on the chain warp's scheduler
  any_width      the instance for run-time widths, at wn_moon's
  parent         the previous, block-synchronous step design
                 (``csrc/wavenet_gen_block.cu``), unchanged
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
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
PARENT = os.path.join(build.CSRC_DIR, "wavenet_gen_block.cu")

_SKIP = ("      skip_partial<WT>(gat, w_skip, ready, t & 1, L, D, S, part, "
         "skip_i,\n                       lane);\n")
_SKIP_SUM = ("        for (int j = 0; j < n_groups; ++j) v += part[j * S + s];"
             "\n")
_POST1 = "      dense_relu(z, post1, p.b1, S, S, z1, part, tid);\n"
_PROLOGUE = "  if (tid == PRODUCER)\n    for (; g_load < NSLOT"
_CHAIN = "    if (warp == 0) {\n      if constexpr (FIXED)\n"
_PRODUCER = "    } else if (tid == PRODUCER) {\n"
_WAIT = "    mbar_wait(&full[s], (unsigned)((g / NSLOT) & 1));\n"
_TAP = ("      Chunk<WT>::two(wf + k, wg + k, k < R ? xo + k : hr + (k - R), "
        "af, ag);\n")
_GATE = "rnd<WT>(tanhf(f) * (1.f / (1.f + expf(-gg))))"
_RES = "      Chunk<WT>::one(wr + k, gat + l * D + k, ar);\n"
_SKIP_U = "  constexpr int U = sizeof(WT) == 2 ? 8 : 16;\n"
_SKIP_WAIT = "    mbar_wait(&ready[l0], parity);\n    int l1 = l0 + 1;\n"
_NSK = "constexpr int NSK = 32 * (NT / 32 - NT / 128 - 1);\n"
_FIXED = "  if (fixed_widths(p.L, p.R, p.Dlc, p.S, p.C, p.W, wsize)) {\n"
_XSEND = ("          st_async(mapa(xch_a + 4u * (mine + r), q), part, "
          "mapa(bar, q));\n")
_XEXPECT = "      mbar_expect_tx(&xbar[l], 4u * (k - 1) * R);\n"
_CSKIP = ("      skip_partial<WT>(gat, w_skip, ready, t & 1, L, Dl, S, part, "
          "skip_i,\n                       lane);\n")
_SKIP_I = ("  const int skip_i = (warp > 1 && warp % 4 != 0)\n"
           "                         ? (warp - warp / 4 - 2) * 32 + lane : -1;\n")

# name -> (source, [(old, new), ...])
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "base": (SOURCE, []),
    "no_skip": (SOURCE, [(_SKIP, ""), (_SKIP_SUM, "")]),
    "no_post1": (SOURCE, [(_POST1, "      for (int s = tid; s < S; s += NT) "
                                   "z1[s] = z[s];\n"
                                   "      __syncthreads();\n")]),
    "no_chain": (SOURCE, [
        (_PROLOGUE, "  if (false)\n    for (; g_load < NSLOT"),
        (_CHAIN, "    if (warp == 0) {\n"
                 "      for (int l = 0; l < L; ++l) {\n"
                 "        gat[l * D + lane] = "
                 "rnd<WT>(0.01f * lcs[l * 2 * D + lane]);\n"
                 "        mbar_arrive(&ready[l]);\n"
                 "      }\n"
                 "    } else if (false) {\n      if constexpr (FIXED)\n"),
        (_PRODUCER, "    } else if (false) {\n")]),
    "chain_no_wait": (SOURCE, [(_WAIT, "")]),
    "chain_no_tap": (SOURCE, [(_TAP, "")]),
    "chain_no_gate": (SOURCE, [(_GATE, "rnd<WT>(0.01f * (f + gg))")]),
    "chain_no_res": (SOURCE, [(_RES, "")]),
    "skip_u8": (SOURCE, [(_SKIP_U, "  constexpr int U = 8;\n")]),
    **{f"skip_rounds{n}": (SOURCE, [(_SKIP_WAIT, _SKIP_WAIT.replace(
        "ready[l0]", f"ready[min(l0 + {n - 1}, L - 1)]"))])
       for n in (4, 12, 50)},
    "skip_all_warps": (SOURCE, [
        (_NSK, "constexpr int NSK = 32 * (NT / 32 - 2);\n"),
        (_SKIP_I, "  const int skip_i = warp > 1 ? (warp - 2) * 32 + lane "
                  ": -1;\n")]),
    "any_width": (SOURCE, [(_FIXED, "  if (false) {\n")]),
    "parent": (PARENT, []),
}
# The split's (``--split``).
_PUSH = ("      st_async4(mapa(gpush + 4u * (l * FW + 4 * (i & 7)), 1 + i / 8), "
         "g4,\n                mapa(xbar + 8u * l, 1 + i / 8));\n")
_PEER_EXPECT = ("    if (tid == 0)\n      for (int l = 0; l < L; ++l) "
                "mbar_expect_tx(&xbar[l], 4u * D);\n")
_PEER_WAIT = "      mbar_wait_cluster(&xbar[l], par);\n"
_PEER_SEND = ("      if ((i4 & 3) == 0 && i4 < S) st_async4(pdst + 16u * i, y, "
              "pbar);\n")
_PARTIALS_WAIT = ("      if (tid == 0) mbar_expect_tx(pbar, 4u * npeer * S);\n"
                  "      mbar_wait_cluster(pbar, t & 1);\n")
_RESIDENT = "  return q.ok ? q : split_layout(L, S, C, W, k, wsize, false);\n"
# A plain 16-byte store into a peer's shared memory, for the ablations.
_ST4 = "__device__ __forceinline__ void st_async4("
_ST4_PLAIN = ("__device__ __forceinline__ void st_cluster4(uint32_t a, float4 v) "
              "{\n  asm volatile(\"st.shared::cluster.v4.f32 [%0], {%1, %2, "
              "%3, %4};\" :: \"r\"(a), \"f\"(v.x), \"f\"(v.y), \"f\"(v.z), "
              "\"f\"(v.w) : \"memory\");\n}\n" + _ST4)
SPLIT_VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "split_no_peer_wait": (SOURCE, [
        (_ST4, _ST4_PLAIN),
        (_PUSH, "      st_cluster4(mapa(gpush + 4u * (l * FW + 4 * (i & 7)), "
                "1 + i / 8), g4);\n"),
        (_PEER_EXPECT, ""), (_PEER_WAIT, ""),
        (_PEER_SEND, "      if ((i4 & 3) == 0 && i4 < S) st_cluster4(pdst + 16u "
                     "* i, y);\n"),
        (_PARTIALS_WAIT, "")]),
    "split_no_push": (SOURCE, [
        (_PUSH, "      ;\n"), (_PEER_EXPECT, ""), (_PEER_WAIT, ""),
        (_PEER_SEND, "      if (i4 == S) red[0] = y.x;\n"),
        (_PARTIALS_WAIT, "")]),
    "split_post1_global": (SOURCE, [
        (_RESIDENT, "  return split_layout(L, S, C, W, k, wsize, false);\n")]),
}
# The cluster instance's (``--clusters``).
CLUSTER_VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "cluster_no_exchange": (SOURCE, [
        (_XSEND, "          ;\n"),
        (_XEXPECT, "      mbar_expect_tx(&xbar[l], 0u);\n")]),
    "cluster_no_skip": (SOURCE, [(_CSKIP, "")]),
}


def variant_source(name: str) -> str:
    path, subs = {**VARIANTS, **CLUSTER_VARIANTS, **SPLIT_VARIANTS}[name]
    src = open(path, encoding="utf-8").read()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the kernel source no longer holds "
                               f"{old!r} once")
        src = src.replace(old, new)
    return src


def build_all(out_dir: str, names=tuple(VARIANTS)) -> Dict[str, str]:
    """Every variant named built in parallel (one nvcc each); name ->
    library."""
    procs = {}
    for name in names:
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


# wavenet_gen_launch's R and D, and its blocks per stream (the argument
# before the stream), which the previous design does not take (it is laid
# out for R = D = 32, one block per stream).
_RD_ARGS = slice(21, 23)


def _bind(path: str, takes_widths: bool = True):
    fn = ctypes.CDLL(path).wavenet_gen_launch
    args = list(G._launcher().argtypes)
    fn.restype = ctypes.c_int
    if takes_widths:
        fn.argtypes = args
        return fn
    del args[-2]
    del args[_RD_ARGS]
    fn.argtypes = args
    return lambda *a: fn(*a[:_RD_ARGS.start], *a[_RD_ARGS.stop:-2], a[-1])


def _ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _mels(cfg, B: int, T: int) -> np.ndarray:
    """The committed mels, repeated to T samples, one per stream."""
    frames = -(-T // cfg.audio.hop_size)
    return np.stack([np.resize(np.load(os.path.join(
        REPO, "samples", "both_r2", f"{b % 4}.mel.npy")), (frames, 80))
        for b in range(B)]).astype(np.float32)


def clusters(cfg, dev, smi: str, B: int, T: int, reps: int,
             tmp: str) -> None:
    """The cluster sweep (``--clusters``): 4x wn_moon's residual width at
    2, 4 and 8 blocks per stream (and the ablated builds), 2x at 1, 2 and
    4."""
    builds = {"base": G._launcher()}
    builds.update({name: _bind(lib) for name, lib in build_all(
        tmp, tuple(CLUSTER_VARIANTS)).items()})
    mel = torch.from_numpy(_mels(cfg, B, T)).to(dev)
    print(f"card: {smi}; B={B} T={T}, MoL head, us per step", flush=True)
    for name, width in (("4x", 128), ("2x", 64)):
        c = dataclasses.replace(cfg.wavenet, residual_channels=width,
                                dilation_channels=width)
        params = seeded_params(c, 0, dev)
        with torch.no_grad():
            lc = Upsampler(c).load_params(params).to(dev)(mel)[:, :T]
        for dt in G.WEIGHT_DTYPES:
            pk = G.pack_params(c, params, dt)
            with torch.no_grad():
                proj = G.precompute_lc_proj(pk, lc)
            dims = G.kernel_widths(pk)
            plan = G.kernel_plan(*dims, dt)
            sizes = G.CLUSTER_SIZES[1:] if name == "4x" else (1, 2, 4)
            for k in sizes:
                nbytes, slots = G._block_smem(*dims, k, dt)
                if not slots:
                    print(f"{name} {str(dt)[6:]:8s} k={k}: does not fit "
                          f"({nbytes:,} B per block with one slot)",
                          flush=True)
                    continue
                for build, fn in builds.items():
                    if build != "base" and (name != "4x" or k == 1):
                        continue
                    G._launcher = lambda fn=fn: fn
                    gen = torch.Generator(dev).manual_seed(0)
                    G._generate(pk, proj[:, :64].contiguous(), generator=gen,
                                blocks=k)                   # warm-up
                    times = [_ms(lambda: G._generate(
                        pk, proj, generator=gen, blocks=k))
                        for _ in range(reps)]
                    print(f"{name} {str(dt)[6:]:8s} k={k} slots={slots} "
                          f"smem={nbytes} B"
                          f"{' (plan)' if k == plan[0] else ''} {build}: "
                          + " ".join(f"{t / T * 1e3:.1f}" for t in times),
                          flush=True)
                G._launcher = lambda fn=builds["base"]: fn
            del proj


# The split's sizes ``--split`` times.
SPLIT_SWEEP = (2, 3, 4, 5, 6, 7, 8)


def split_sweep(cfg, dev, smi: str, T: int, reps: int, tmp: str) -> None:
    """The split's sweep (``--split``): wn_moon at B = 1 and 8, both weight
    types, one block and each of ``SPLIT_SWEEP`` blocks per stream, and the
    split's ablated builds in bf16."""
    builds = {"base": G._launcher()}
    builds.update({name: _bind(lib) for name, lib in build_all(
        tmp, tuple(SPLIT_VARIANTS)).items()})
    w = cfg.wavenet
    params = seeded_params(w, 0, dev)
    upsampler = Upsampler(w).load_params(params).to(dev)
    print(f"card: {smi}; T={T}, MoL head, us per step", flush=True)
    for B in (1, 8):
        with torch.no_grad():
            lc = upsampler(torch.from_numpy(_mels(cfg, B, T)).to(dev))[:, :T]
        for dt in (torch.bfloat16, torch.float32):
            pk = G.pack_params(w, params, dt)
            with torch.no_grad():
                proj = G.precompute_lc_proj(pk, lc)
            L, _, _, S, C, W = dims = G.kernel_widths(pk)
            bf16 = dt == torch.bfloat16
            plan = G.kernel_plan(*dims, dt, B, lambda k: G._card_clusters(
                L, S, C, W, k, bf16))[0]
            for k in (1,) + SPLIT_SWEEP:
                nbytes = (G.kernel_smem(*dims, dt)[0] if k == 1 else
                          G._split_smem(L, S, C, W, k, dt))
                held = "" if k == 1 else (
                    f" held={G._card_clusters(L, S, C, W, k, bf16)}")
                for build, fn in builds.items():
                    if build != "base" and (k == 1 or not bf16):
                        continue
                    G._launcher = lambda fn=fn: fn
                    gen = torch.Generator(dev).manual_seed(0)
                    G._generate(pk, proj[:, :64].contiguous(), generator=gen,
                                blocks=k)                   # warm-up
                    times = [_ms(lambda: G._generate(
                        pk, proj, generator=gen, blocks=k))
                        for _ in range(reps)]
                    print(f"B={B} {str(dt)[6:]:8s} k={k} smem={nbytes} B"
                          f"{held}{' (plan)' if k == plan else ''} {build}: "
                          + " ".join(f"{t / T * 1e3:.2f}" for t in times),
                          flush=True)
                G._launcher = lambda fn=builds["base"]: fn
            del proj


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=None,
                   help="steps per launch (8192; 4096 with --split, 2048 "
                        "with --clusters)")
    p.add_argument("--streams", type=int, default=4)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--clusters", action="store_true",
                   help="time the cluster instance's blocks per stream")
    p.add_argument("--split", action="store_true",
                   help="time the split's blocks per stream")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gen: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = load_config(os.path.join(REPO, "artifacts", "wn_moon.ckpt.tar.gz"))
    if args.clusters or args.split:
        kernel_launcher = G._launcher
        try:
            with tempfile.TemporaryDirectory() as tmp:
                if args.split:
                    split_sweep(cfg, dev, smi, args.steps or 4096,
                                args.reps, tmp)
                else:
                    clusters(cfg, dev, smi, args.streams,
                             args.steps or 2048, args.reps, tmp)
        finally:
            G._launcher = kernel_launcher
        return
    w = cfg.wavenet
    B, T = args.streams, args.steps or 8192
    mel = _mels(cfg, B, T)
    params = seeded_params(w, 0, dev)
    with torch.no_grad():
        lc = Upsampler(w).load_params(params).to(dev)(
            torch.from_numpy(mel).to(dev))[:, :T]
        packs = {dt: G.pack_params(w, params, dt)
                 for dt in (torch.float32, torch.bfloat16)}
        projs = {dt: G.precompute_lc_proj(pk, lc) for dt, pk in packs.items()}
    print(f"card: {smi}; B={B} T={T}, us per step", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {name: _bind(lib, VARIANTS[name][0] == SOURCE)
               for name, lib in build_all(tmp).items()}
        kernel_launcher = G._launcher
        try:
            for rep in range(args.reps):
                for name, fn in fns.items():
                    G._launcher = lambda fn=fn: fn
                    row = []
                    for dt, pk in packs.items():
                        gen = torch.Generator(dev).manual_seed(0)
                        G._generate(pk, projs[dt][:, :64].contiguous(),
                                    generator=gen, blocks=1)   # warm-up
                        t = _ms(lambda: G._generate(pk, projs[dt],
                                                    generator=gen, blocks=1))
                        row.append(f"{str(dt)[6:]} {t / T * 1e3:6.1f}")
                    print(f"rep {rep} {name:12s} " + "  ".join(row),
                          flush=True)
        finally:
            G._launcher = kernel_launcher


if __name__ == "__main__":
    main()
