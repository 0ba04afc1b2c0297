#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: build the generation kernel,
hold it against its plain twin at full width, drive the vocoder serving path
(mel -> wav) through ``WaveNetGenerator``, and time the kernel.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result, when
either is missing or when this file stands outside the repository.  Weights
are random, made from a seed at the full width of the repository's
``wn_moon`` WaveNet (its ``params.json`` is read from the checkpoint
tarball); the requests are the committed Tacotron mels
``samples/both_r2/{0,1,2,3}.mel.npy``.  Wavs go to a temporary directory
that is removed at the end.  The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "tacotron_wavenet_vocoder_korean_tpu_torch"
TPU_KERNEL = "tacotron_wavenet_vocoder_korean_tpu/ops/wavenet_pallas.py:510"
MELS = [os.path.join(REPO, "samples", "both_r2", f"{i}.mel.npy")
        for i in range(4)]
CONFIG = os.path.join(REPO, "artifacts", "wn_moon.ckpt.tar.gz")
# Published H100 SXM peaks at the 700 W limit: HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores (the kernel's arithmetic is plain f32 FMA).
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12

# Kernel against its plain twin.  Both run the same f32 math; sums are taken
# in another order, so a step differs by ~1e-6.  A step may differ by more
# only where two mixture logits (or Gumbel scores) tie to within that
# rounding and the two sides pick different components: isolated steps.
STEP_TOL = 1e-4          # all steps but near-ties
NEAR_TIE_TOL = 1e-3      # a step above this counts as a near-tie flip
MAX_TIE_SHARE = 0.005    # at most 0.5% of steps may be flips
FREE_RUN_TOL = 1e-3      # free-running: rounding compounds through feedback
# Two-sample Kolmogorov-Smirnov bound at alpha = 0.001 for n = m:
# 1.95 * sqrt(2 / n).  Teacher-forced logits do not depend on the draws, so
# the pooled samples are independent draws from one distribution.
KS_ALPHA_COEF = 1.95


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"[{name}] start")
    yield
    log(f"[{name}] done in {time.perf_counter() - t0:.1f}s")


def compare(name, got, want, tol=STEP_TOL, max_share=MAX_TIE_SHARE):
    err = (got - want).abs()
    per_step = err.flatten()
    share = float((per_step > NEAR_TIE_TOL).float().mean())
    rest = per_step[per_step <= NEAR_TIE_TOL]
    rest_max = float(rest.max()) if rest.numel() else 0.0
    log(f"  {name}: max_abs_err={float(err.max()):.3e} "
        f"share(>{NEAR_TIE_TOL:g})={share:.5f} max_other={rest_max:.3e}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output not finite")
    if share > max_share or rest_max > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin")
    return float(err.max())


def ks_statistic(a, b) -> float:
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / len(a)
    fb = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.abs(fa - fb).max())


def cuda_ms(fn, reps: int = 1) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG} not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from tacotron_wavenet_vocoder_korean_tpu_torch.config import load_config
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        seeded_params)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import (
        save_wav)
    from tacotron_wavenet_vocoder_korean_tpu_torch.models.wavenet import (
        Upsampler)
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops import build
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
        generate_bytes, generate_flops, generate_plain, pack_params,
        precompute_lc_proj, wavenet_generate)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
        WaveNetGenerator)

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        log(f"  card: {smi}")
        log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

    with phase("build"):
        build.load_library("wavenet_gen")

    cfg = load_config(CONFIG)
    w = cfg.wavenet
    params = seeded_params(w, seed=0, device=dev)
    packed = pack_params(w, params)
    up = Upsampler(w).load_params(params).to(dev)
    mels = [np.load(p).astype(np.float32) for p in MELS]
    nr = w.out_channels // 3
    log(f"  wn_moon width: L={len(w.dilations)} R={w.residual_channels} "
        f"D={w.dilation_channels} S={w.skip_channels} C={w.out_channels} "
        f"W={w.initial_filter_width}")

    def lc_proj_for(B, T):
        f = -(-T // cfg.audio.hop_size)
        mel = np.stack([np.resize(mels[b % 4], (f, mels[0].shape[1]))
                        for b in range(B)])
        with torch.no_grad():
            lc = up(torch.from_numpy(mel).to(dev))[:, :T]
            return precompute_lc_proj(packed, lc)

    def prime_signal(B, T, seed):
        rng = np.random.default_rng(seed)
        t = np.arange(T)[:, None] / cfg.audio.sample_rate
        f0 = rng.uniform(100, 300, (1, B))
        x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(
            (T, B))
        return torch.from_numpy(x.astype(np.float32)).to(dev).contiguous()

    errors = {}
    with phase("kernel vs plain twin, full width, B=4"), torch.no_grad():
        B, T = 4, 2048
        proj = lc_proj_for(B, T)
        primed = prime_signal(B, T, 1)
        k = wavenet_generate(packed, proj, deterministic=True, primed=primed,
                             prime_len=T)
        p = generate_plain(packed, proj, deterministic=True, primed=primed,
                           prime_len=T)
        torch.cuda.synchronize()
        errors["a"] = compare("(a) deterministic, teacher-forced 2048", k, p)

        proj_b = proj[:, :256].contiguous()
        k = wavenet_generate(packed, proj_b, deterministic=True)
        p = generate_plain(packed, proj_b, deterministic=True)
        compare("(b) deterministic, free-running 256", k, p,
                tol=FREE_RUN_TOL, max_share=0.0)
        if float(k.std()) == 0.0:
            raise AssertionError("(b) free-running output is constant")

        noise = torch.rand(T, B, nr + 1, device=dev,
                           generator=torch.Generator(dev).manual_seed(2))
        k = wavenet_generate(packed, proj, noise=noise, primed=primed,
                             prime_len=T)
        p = generate_plain(packed, proj, noise=noise, primed=primed,
                           prime_len=T)
        errors["c"] = compare("(c) stochastic, same noise, teacher-forced "
                              "2048", k, p)

        B, T = 8, 4096
        proj = lc_proj_for(B, T)
        primed = prime_signal(B, T, 3)
        k = wavenet_generate(packed, proj,
                             generator=torch.Generator(dev).manual_seed(4),
                             primed=primed, prime_len=T)
        p = generate_plain(packed, proj,
                           generator=torch.Generator(dev).manual_seed(5),
                           primed=primed, prime_len=T)
        ks = ks_statistic(k.cpu().numpy().ravel(), p.cpu().numpy().ravel())
        bound = KS_ALPHA_COEF * np.sqrt(2.0 / k.numel())
        log(f"  (d) Philox vs torch.Generator, 8 x 4096 teacher-forced: "
            f"KS={ks:.4f} (bound {bound:.4f}), std kernel "
            f"{float(k.std()):.4f} plain {float(p.std()):.4f}")
        if not ks < bound:
            raise AssertionError("(d) Philox samples differ in distribution")
        del proj, primed, k, p

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with phase("main path: WaveNetGenerator on the card"):
            gen = WaveNetGenerator(cfg, params, device="cuda")
            hop, sr = cfg.audio.hop_size, cfg.audio.sample_rate
            requests = [("batched 4 mels", mels, None),
                        ("single 0.mel", mels[0], None)]
            results = {}
            wavenet_generate.launches = 0
            launches = 0
            for i, (name, mel, seed_wav) in enumerate(
                    requests + [("wav_seed 1.mel", mels[1], "from request 2")]):
                if seed_wav is not None:
                    seed_wav = results["single 0.mel"][0][:hop * 20]
                t0 = time.perf_counter()
                out = gen.generate(mel, seed=i, wav_seed=seed_wav)
                dt = time.perf_counter() - t0
                wavs = out if isinstance(out, list) else [out]
                mlist = mel if isinstance(mel, list) else [mel]
                launches += 1
                if wavenet_generate.launches != launches:
                    raise AssertionError(f"{name}: kernel not launched once")
                for wav, m in zip(wavs, mlist):
                    if wav.shape != (m.shape[0] * hop,):
                        raise AssertionError(f"{name}: wav length {wav.shape}")
                    if not np.isfinite(wav).all() or np.abs(wav).max() > 1:
                        raise AssertionError(f"{name}: wav not finite in "
                                             "[-1, 1]")
                    if wav.std() == 0:
                        raise AssertionError(f"{name}: constant wav")
                n = sum(len(x) for x in wavs)
                results[name] = wavs
                for j, x in enumerate(wavs):
                    save_wav(x, os.path.join(tmp, f"{i}_{j}.wav"), sr)
                log(f"  {name}: {len(wavs)} stream(s), {n} samples in "
                    f"{dt:.3f}s = {n / dt:.0f} samples/s = "
                    f"{n / dt / sr:.3f}x realtime at {sr} Hz "
                    f"(std {np.mean([x.std() for x in wavs]):.4f}) [{smi}]")
            main_launches = wavenet_generate.launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    with phase("kernel timing at the main path's shapes"), torch.no_grad():
        B = len(mels)
        T = max(m.shape[0] for m in mels) * cfg.audio.hop_size
        proj = lc_proj_for(B, T)
        gen_t = torch.Generator(dev).manual_seed(6)
        ms = cuda_ms(lambda: wavenet_generate(packed, proj, generator=gen_t))
        # The twin launches hundreds of small ops per sample: it is timed on
        # a 512-step span of the same streams, and the kernel on that span
        # too, so the two times compare directly.
        span = 512
        proj_s = proj[:, :span].contiguous()
        plain_ms = cuda_ms(lambda: generate_plain(packed, proj_s,
                                                  generator=gen_t))
        span_ms = cuda_ms(lambda: wavenet_generate(packed, proj_s,
                                                   generator=gen_t))
        flops = generate_flops(packed, B, T)
        nbytes = generate_bytes(packed, B, T)
        t_ops, t_bytes = flops / F32_FLOPS_S * 1e3, nbytes / HBM_BYTES_S * 1e3
        log(f"  wavenet_generate B={B} T={T}: {ms:.1f} ms "
            f"({B * T / ms * 1e3:.0f} samples/s aggregate); bound "
            f"{max(t_ops, t_bytes):.2f} ms ({flops:.3e} FLOP, {nbytes:.3e} B)"
            f"; {span} steps: kernel {span_ms:.2f} ms, plain twin "
            f"{plain_ms:.1f} ms [{smi}]")

    kernels = [{
        "name": "wavenet_generate",
        "route": "cuda",
        "source": f"{PKG}/csrc/wavenet_gen.cu",
        "replaces": TPU_KERNEL,
        "launches": main_launches,
        "max_abs_err": max(errors.values()),
        "ms": ms,
        "plain_ms": plain_ms,
        "plain_steps": span,
        "ms_plain_steps": span_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]
    if main_launches < 1:
        raise AssertionError("the main path did not launch the kernel")
    log(f"total wall time {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
