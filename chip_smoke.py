#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: build the generation kernel,
hold each of its four variants (mixture-of-logistics or 256-way softmax
head, f32 or bf16 weights) against its plain twin at full width, drive the
vocoder serving path (mel -> wav) through ``WaveNetGenerator``, check that
an out-of-range speaker id leaves the card working, drive text -> mel
(``Synthesizer``, Tacotron at the ``both_r2`` width) and text -> wav (its
mels through the bf16 generator), hold the card's f32 Tacotron decode
against the CPU's, time the decode, time the kernel, and time the previous
step design (``csrc/wavenet_gen_block.cu``) beside it.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result, when
either is missing or when this file stands outside the repository.  Weights
are random, made from a seed at the full width of the repository's
``wn_moon`` WaveNet (its ``params.json`` is read from the checkpoint
tarball): as it is (raw input, MoL head), and switched to ``mulaw-quantize``
(one-hot input, softmax head over 256 classes).  The vocoder's requests are
the committed Tacotron mels ``samples/both_r2/{0,1,2,3}.mel.npy``; the
Tacotron's are four Korean texts (two per speaker, with digits and Latin
letters), decoded with seeded weights over the served 200 steps in bf16
with prenet dropout, as ``both_r2``'s ``params.json`` asks (the port's
``config.BOTH_R2``; the tarball itself is not copied to the card).  Wavs go
to a temporary directory that is removed at the end.  A ``tacotron`` JSON
line carries the decode's numbers; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# Published H100 SXM peaks at the 700 W limit: HBM3 bytes/s; f32 FLOP/s
# outside the tensor cores (the f32 variants' arithmetic); bf16 FLOP/s of
# the tensor cores (bf16 products summed in f32, the bf16 variants' work).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Kernel against its plain twin.  Both run the same math; sums are taken in
# another order, so a step differs by ~1e-6 in f32.  A step may differ by
# more only where two mixture logits (or Gumbel scores) tie to within that
# rounding and the two sides pick different components: isolated steps.
STEP_TOL = 1e-4          # all steps but near-ties
NEAR_TIE_TOL = 1e-3      # a step above this counts as a near-tie flip
MAX_TIE_SHARE = 0.005    # at most 0.5% of steps may be flips
FREE_RUN_TOL = 1e-3      # free-running: rounding compounds through feedback
# Softmax head, f32: the share of steps whose class must agree; only a
# near-tie of two scores (within ~1e-7) may flip a class.
CLASS_AGREE_F32 = 0.999
# bf16 weights: both sides round every activation to bf16 before its
# product.  A sum taken in another order can land an activation on the
# other side of a bf16 rounding step (2^-8 relative); the ring histories
# carry that into later steps, where it crosses further rounding steps, so
# over ~1,000 steps the kernel and its twin part about as far as bf16 parts
# from f32.  Bounds: over the whole span, the kernel differs from its twin
# no more than two independent bf16 roundings of the f32 function would
# (BF16_RATIO times the twin's own distance from the f32 kernel, which
# equals the f32 twin to ~1e-7: the union bound); over the first
# BF16_EARLY steps, before much has been carried, MoL samples within
# BF16_EARLY_TOL.
BF16_RATIO = 2.0
BF16_EARLY, BF16_EARLY_TOL = 64, 1e-3
BF16_JUMP = 1e-2         # a MoL step above this counts as a component flip
CLASS_AGREE_BF16 = 0.95  # and an absolute floor for the softmax head
# Two-sample Kolmogorov-Smirnov bound at alpha = 0.001 for n = m:
# 1.95 * sqrt(2 / n); and the chi-square homogeneity test of two class
# histograms at the same alpha.  Teacher-forced logits do not depend on the
# draws, so each side's draws are independent, step by step from the same
# distributions; pooling steps of different distributions only shrinks the
# statistics' variance, so both tests stay conservative.
KS_ALPHA_COEF = 1.95
ALPHA = 0.001
# Timing: the plain twin is timed over a span of this many steps; the
# previous step design beside the kernel over SIDE_T steps of B = 4.
SPAN = 512
SIDE_T = 16384
# Tacotron (text -> mel): four requests, two per speaker, with digits and
# Latin letters, decoded in one batch over the served max_iters.
TEXTS = ["존경하는 국민 여러분, 오늘은 2026년 10월 17일입니다.",
         "KIA와 CAT 3대가 12시에 도착했다.",
         "안녕하세요. 반갑습니다.",
         "JTBC 뉴스에서 60.3%의 시청률을 기록했습니다."]
SPEAKERS = [0, 1, 0, 1]
# The card's f32 decode against the same decode on the CPU: the GPU sums
# in another order (TF32 off), and on seeded weights the decoder contracts
# such differences rather than growing them (the port against JAX, both
# f32 on a CPU, differ by ~1e-6 at this width: tests/test_torch_tacotron.py),
# so 1e-4 leaves a wide margin.
TACO_F32_TOL = 1e-4
# The card's bf16 decode against the CPU's bf16 decode: the two round their
# sums differently, and 200 steps carry that, so they are held to bf16's own
# noise: mean |card - CPU| at most this many times the CPU's mean
# |bf16 - f32| (as tests/test_torch_tacotron.py holds the port to JAX).
TACO_BF16_RATIO = 2.0
TACO_REPS = 5            # timed repetitions of each decode, after a warm-up
ALIGN_SUM_TOL = 1e-3     # a column of monotonic attention sums to <= 1


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


def compare_classes(name, got, want, min_agree):
    agree = float((got == want).float().mean())
    err = float((got - want).abs().max())
    log(f"  {name}: class agreement {agree:.5f} (bound >= {min_agree}), "
        f"max_abs_err {err:g}, {len(torch.unique(got))} distinct classes")
    if not (torch.equal(got, got.round()) and float(got.min()) >= 0
            and float(got.max()) < 256):
        raise AssertionError(f"{name}: kernel output is not class ids")
    if agree < min_agree:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin")
    return err, agree


def compare_bf16(name, k16, t16, k32, classes):
    """bf16 kernel ``k16`` against its bf16 twin ``t16``, measured against
    the twin's own distance from the f32 kernel ``k32`` (see BF16_RATIO).
    MoL: mean abs error and share of component flips; softmax: share of
    differing classes.  Returns (max abs error, class agreement or None)."""
    if classes:
        d_kt = float((k16 != t16).float().mean())
        d_tf = float((t16 != k32).float().mean())
        agree = 1.0 - d_kt
        log(f"  {name}: classes differ kernel/twin {d_kt:.5f} (bound <= "
            f"{BF16_RATIO:g} x {d_tf:.5f}, twin bf16/f32; agreement >= "
            f"{CLASS_AGREE_BF16}), {len(torch.unique(k16))} distinct classes")
        ok = d_kt <= BF16_RATIO * d_tf and agree >= CLASS_AGREE_BF16
    else:
        e_kt, e_tf = (k16 - t16).abs(), (t16 - k32).abs()
        early = float(e_kt[:, :BF16_EARLY].max())
        mean_kt, mean_tf = float(e_kt.mean()), float(e_tf.mean())
        jump_kt = float((e_kt > BF16_JUMP).float().mean())
        jump_tf = float((e_tf > BF16_JUMP).float().mean())
        agree = None
        log(f"  {name}: first {BF16_EARLY} steps max_abs_err {early:.3e} "
            f"(bound {BF16_EARLY_TOL:g}); mean abs err kernel/twin "
            f"{mean_kt:.3e} (bound <= {BF16_RATIO:g} x {mean_tf:.3e}, twin "
            f"bf16/f32); flips (>{BF16_JUMP:g}) {jump_kt:.5f} (bound <= "
            f"{BF16_RATIO:g} x {jump_tf:.5f}); max_abs_err "
            f"{float(e_kt.max()):.3e}")
        ok = (early <= BF16_EARLY_TOL and mean_kt <= BF16_RATIO * mean_tf
              and jump_kt <= BF16_RATIO * jump_tf)
    if not bool(torch.isfinite(k16).all()) or not ok:
        raise AssertionError(f"{name}: bf16 kernel disagrees with its twin")
    return float((k16 - t16).abs().max()), agree


def ks_statistic(a, b) -> float:
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    fa = np.searchsorted(a, grid, side="right") / len(a)
    fb = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.abs(fa - fb).max())


def chi2_two_sample(a, b, n_classes):
    """Chi-square homogeneity statistic of two equal-size samples of class
    ids, classes seen fewer than 10 times in all pooled into one bin;
    returns (statistic, degrees of freedom, bound at ALPHA)."""
    from scipy.stats import chi2
    ca = np.bincount(a.astype(np.int64), minlength=n_classes)
    cb = np.bincount(b.astype(np.int64), minlength=n_classes)
    small = (ca + cb) < 10
    ca = np.append(ca[~small], ca[small].sum())
    cb = np.append(cb[~small], cb[small].sum())
    keep = (ca + cb) > 0
    ca, cb = ca[keep], cb[keep]
    stat = float(np.sum((ca - cb) ** 2 / (ca + cb)))
    dof = len(ca) - 1
    return stat, dof, float(chi2.ppf(1 - ALPHA, dof))


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


def decoder_launches(model, enc, masks, steps: int) -> dict:
    """CUDA kernels launched per decoder step, counted by torch.profiler
    over runs of ``steps`` and 2 x ``steps`` steps (the difference, so the
    loop's set-up is not counted), and the profiler's device time."""
    from torch.profiler import ProfilerActivity, profile
    counts, device_us = [], []
    for n in (steps, 2 * steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decoder(enc, n, [m[:n] for m in masks])
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type.name == "CUDA"]
        launch_calls = sum(e.count for e in events if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
        counts.append((sum(e.count for e in kernels), launch_calls))
        device_us.append(sum(getattr(e, "self_device_time_total", None)
                             or getattr(e, "self_cuda_time_total", 0)
                             for e in kernels))
    if counts[1][0] == 0:                # the profiler saw no device
        return {"kernels_per_step": None, "device_us_per_step": None,
                "launch_calls_per_step": (counts[1][1] - counts[0][1])
                / steps}
    return {"kernels_per_step": (counts[1][0] - counts[0][0]) / steps,
            "launch_calls_per_step": (counts[1][1] - counts[0][1]) / steps,
            "device_us_per_step": (device_us[1] - device_us[0]) / steps}


def tacotron_phases(dev, wn_cfg, gen, smi) -> dict:
    """text -> mel on the card at the both_r2 width (seeded weights), its
    f32 decode against the CPU's, text -> wav through the bf16 generator
    ``gen`` (the generation kernel's MoL bf16 variant), and the decode's
    times.  Returns the numbers for the ``tacotron`` line, with the
    kernel's launches on the text -> wav path under ``launches``."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.config import (
        BOTH_R2, Config)
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        seeded_tacotron_params)
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
        wavenet_generate)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.synthesizer import (
        Synthesizer, attention_trim_index)

    out = {}
    cfg = Config(audio=wn_cfg.audio, tacotron=BOTH_R2)
    cfg32 = dataclasses.replace(cfg, tacotron=dataclasses.replace(
        BOTH_R2, compute_dtype="float32"))
    params = seeded_tacotron_params(BOTH_R2, seed=0, audio=cfg.audio)
    r, iters = BOTH_R2.reduction_factor, BOTH_R2.max_iters
    a = cfg.audio
    with phase("Tacotron: text -> mel on the card (both_r2 width, bf16, "
               "prenet dropout on)"):
        synth = Synthesizer(cfg, params, device=dev)
        if synth.model.dtype != torch.bfloat16:
            raise AssertionError("both_r2 does not decode in bf16")
        inputs, lengths = synth._prepare_inputs(TEXTS)
        t0 = time.perf_counter()
        res = synth.synthesize(TEXTS, speaker_ids=SPEAKERS, rng_seed=0)
        log(f"  4 texts (ids padded to {inputs.shape[1]}, lengths "
            f"{lengths.tolist()}), {iters} steps: "
            f"{time.perf_counter() - t0:.3f}s with the first call's set-up")
        for i, x in enumerate(res):
            n = min(iters * r, attention_trim_index(
                x["alignment"], int(lengths[i]), r))
            if x["mel"].shape != (n, a.num_mels) or x["linear"].shape != (
                    n, a.num_freq):
                raise AssertionError(f"text {i}: mel {x['mel'].shape}, "
                                     f"linear {x['linear'].shape}, want {n}")
            if x["alignment"].shape != (inputs.shape[1], iters):
                raise AssertionError(f"text {i}: alignment "
                                     f"{x['alignment'].shape}")
            if not (np.isfinite(x["mel"]).all()
                    and np.isfinite(x["linear"]).all()):
                raise AssertionError(f"text {i}: output not finite")
            al = x["alignment"]
            col = al.sum(0)
            if al.min() < 0 or al.max() > 1 or col.max() > 1 + ALIGN_SUM_TOL:
                raise AssertionError(f"text {i}: alignments outside [0, 1] "
                                     f"or a column sums to {col.max()}")
            log(f"  text {i} (speaker {SPEAKERS[i]}): kept {n} of "
                f"{iters * r} frames; mel in [{x['mel'].min():.3f}, "
                f"{x['mel'].max():.3f}], std {x['mel'].std():.4f}; "
                f"alignments in [{al.min():.2e}, {al.max():.3f}], column "
                f"sums <= {col.max():.6f}")
        again = synth.synthesize(TEXTS, speaker_ids=SPEAKERS, rng_seed=0)
        other = synth.synthesize(TEXTS, speaker_ids=SPEAKERS, rng_seed=1,
                                 attention_trim=False)
        for x, y in zip(res, again):
            if not np.array_equal(x["mel"], y["mel"]):
                raise AssertionError("the same rng_seed gave another mel")
        n0 = res[0]["mel"].shape[0]
        d = float(np.abs(other[0]["mel"][:n0] - res[0]["mel"]).max())
        if d == 0.0:
            raise AssertionError("another rng_seed gave the same mel")
        log(f"  rng_seed 0 twice: equal mels; rng_seed 1: max abs "
            f"difference {d:.3f}")

    with phase("Tacotron deterministic decode (dropout off): card vs CPU, "
               "f32 and bf16, 200 steps"):
        spk = np.asarray(SPEAKERS)
        run = {}
        for c in (cfg32, cfg):
            for d in (dev, torch.device("cpu")):
                model = Synthesizer(c, params, device=d).model
                with torch.no_grad():
                    o = model(torch.from_numpy(inputs).long().to(d),
                              torch.from_numpy(lengths).long().to(d),
                              torch.from_numpy(spk).to(d))
                run[c.tacotron.compute_dtype, d.type] = {
                    k: v.float().cpu().numpy() for k, v in o.items()}
        for key, o in run.items():
            if any(not np.isfinite(v).all() for v in o.values()):
                raise AssertionError(f"{key} decode not finite")
        card, cpu = run["float32", dev.type], run["float32", "cpu"]
        errs = {k: float(np.abs(card[k] - cpu[k]).max()) for k in cpu}
        log(f"  f32 max abs err card vs CPU: {errs} (bound "
            f"{TACO_F32_TOL:g})")
        if max(errs.values()) > TACO_F32_TOL:
            raise AssertionError("the card's f32 decode differs from the "
                                 "CPU's")
        out["f32_card_vs_cpu_max_abs_err"] = errs
        card16, cpu16 = run["bfloat16", dev.type], run["bfloat16", "cpu"]
        bf16 = {}
        for k in cpu:
            d_card = float(np.abs(card16[k] - cpu16[k]).mean())
            d_noise = float(np.abs(cpu16[k] - cpu[k]).mean())
            bf16[k] = {"card_vs_cpu": d_card, "cpu_bf16_vs_f32": d_noise}
            log(f"  bf16 {k}: mean abs card vs CPU {d_card:.3e}, CPU bf16 "
                f"vs f32 {d_noise:.3e} (bound {TACO_BF16_RATIO:g}x)")
            if not 0 < d_noise or d_card > TACO_BF16_RATIO * d_noise:
                raise AssertionError(f"the card's bf16 decode ({k}) is "
                                     "farther from the CPU's than bf16 "
                                     "rounding")
        out["bf16_card_vs_cpu_mean_abs_err"] = bf16

    with phase("text -> wav on the card: Tacotron bf16, then one launch of "
               "the generation kernel (wn_moon width, bf16)"):
        sr, hop = a.sample_rate, a.hop_size
        wavenet_generate.launches = 0
        wavenet_generate.variant_launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = synth.synthesize(TEXTS, speaker_ids=SPEAKERS, rng_seed=0)
        wavs = gen.generate([x["mel"] for x in res], seed=0)
        dt = time.perf_counter() - t0
        launches = dict(wavenet_generate.variant_launches)
        log(f"  launches on the text -> wav path: {launches}")
        if launches != {"mol-bfloat16": 1}:
            raise AssertionError("text -> wav did not launch the bf16 MoL "
                                 "kernel once")
        for x, w in zip(res, wavs):
            if w.shape != (x["mel"].shape[0] * hop,):
                raise AssertionError(f"wav length {w.shape}")
            if not np.isfinite(w).all() or np.abs(w).max() > 1:
                raise AssertionError("wav not finite in [-1, 1]")
        audio_s = sum(len(w) for w in wavs) / sr
        longest = max(len(w) for w in wavs) / sr
        log(f"  4 texts -> {audio_s:.3f} s of audio (longest {longest:.3f} "
            f"s) in {dt:.3f} s wall = {audio_s / dt:.3f}x realtime "
            f"aggregate, {longest / dt:.3f}x for the longest stream "
            f"[{smi}]")
        out["text_to_wav"] = {"wall_s": dt, "audio_s": audio_s,
                              "x_realtime": audio_s / dt,
                              "x_realtime_longest": longest / dt}

    with phase("Tacotron decode timing (CUDA events, after a warm-up)"), \
            torch.no_grad():
        models = {"float32": Synthesizer(cfg32, params, device=dev).model,
                  "bfloat16": synth.model}
        timing = {}
        for name, model in models.items():
            for B in (1, 4):
                x = torch.from_numpy(inputs[:B]).long().to(dev)
                ln = torch.from_numpy(lengths[:B]).long().to(dev)
                sp = torch.from_numpy(np.asarray(SPEAKERS[:B])).to(dev)
                g = torch.Generator(dev).manual_seed(0)
                request = lambda: model(x, ln, sp, generator=g)
                request()
                req = [cuda_ms(request) for _ in range(TACO_REPS)]
                enc = model.encode(x, ln, sp)
                masks = model.draw_prenet_masks(iters, B, g)
                loop = lambda: model.decoder(enc, iters, masks)
                loop()
                loops = [cuda_ms(loop) for _ in range(TACO_REPS)]
                req_ms, loop_ms = np.mean(req), np.mean(loops)
                count = decoder_launches(model, enc, masks, 20)
                timing[f"{name}_B{B}"] = dict(
                    ms_per_request=req_ms, decoder_ms=loop_ms,
                    ms_per_step=loop_ms / iters,
                    request_ms_range=[min(req), max(req)],
                    decoder_ms_range=[min(loops), max(loops)], **count)
                log(f"  {name} B={B}: {req_ms:.2f} ms per request (reps "
                    f"{min(req):.2f}-{max(req):.2f}), decoder loop "
                    f"{loop_ms:.2f} ms (reps {min(loops):.2f}-"
                    f"{max(loops):.2f}) = {loop_ms / iters:.3f} ms per "
                    f"step; CUDA kernels per step "
                    f"{count['kernels_per_step'] or 'not measured'} "
                    f"({count['launch_calls_per_step']} launch calls), "
                    f"device time per step "
                    f"{count['device_us_per_step'] or 'not measured'} us "
                    f"[{smi}]")
        out["decode"] = timing
    out["launches"] = launches
    return out


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
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.mulaw import (
        inv_mulaw_quantize, mulaw_quantize)
    from tacotron_wavenet_vocoder_korean_tpu_torch.models.wavenet import (
        Upsampler)
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops import build
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops import wavenet_gen as G
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
        generate_bytes, generate_flops, generate_plain, kernel_variant,
        pack_params, precompute_lc_proj, wavenet_generate)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
        WaveNetGenerator)

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        log(f"  card: {smi}")
        log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

    with phase("build"):
        build.load_libraries("wavenet_gen", "wavenet_gen_block")

    cfg = load_config(CONFIG)
    w = cfg.wavenet
    cfg_q = dataclasses.replace(cfg, wavenet=dataclasses.replace(
        w, input_type="mulaw-quantize", scalar_input=False,
        out_channels=w.quantization_channels))
    wq = cfg_q.wavenet
    params = seeded_params(w, seed=0, device=dev)
    params_q = seeded_params(wq, seed=0, device=dev)
    packs = {}
    for p, c in ((params, w), (params_q, wq)):
        for dt in (f32, bf16):
            pk = pack_params(c, p, dt)
            packs[kernel_variant(pk)] = pk
    ups = {"mol": Upsampler(w).load_params(params).to(dev),
           "softmax": Upsampler(wq).load_params(params_q).to(dev)}
    mels = [np.load(p).astype(np.float32) for p in MELS]
    nr, Q = w.out_channels // 3, wq.quantization_channels
    log(f"  wn_moon width: L={len(w.dilations)} R={w.residual_channels} "
        f"D={w.dilation_channels} S={w.skip_channels}; MoL head "
        f"C={w.out_channels} W={w.initial_filter_width}; softmax head "
        f"Q={Q} W={wq.filter_width}")

    def lc_proj_for(variant, B, T):
        f = -(-T // cfg.audio.hop_size)
        mel = np.stack([np.resize(mels[b % 4], (f, mels[0].shape[1]))
                        for b in range(B)])
        with torch.no_grad():
            lc = ups[variant.split("-")[0]](torch.from_numpy(mel).to(dev))
            return precompute_lc_proj(packs[variant], lc[:, :T])

    def prime_signal(B, T, seed):
        rng = np.random.default_rng(seed)
        t = np.arange(T)[:, None] / cfg.audio.sample_rate
        f0 = rng.uniform(100, 300, (1, B))
        x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(
            (T, B))
        return torch.from_numpy(x.astype(np.float32)).to(dev).contiguous()

    def prime_classes(B, T, seed):
        return mulaw_quantize(prime_signal(B, T, seed), Q).float()

    errors = {v: [] for v in packs}
    agreement = {}
    with phase("MoL head, f32: kernel vs plain twin, full width, B=4"), \
            torch.no_grad():
        packed = packs["mol-float32"]
        B, T = 4, 2048
        proj = lc_proj_for("mol-float32", B, T)
        primed = prime_signal(B, T, 1)
        k = wavenet_generate(packed, proj, deterministic=True, primed=primed,
                             prime_len=T)
        p = generate_plain(packed, proj, deterministic=True, primed=primed,
                           prime_len=T)
        torch.cuda.synchronize()
        errors["mol-float32"].append(compare(
            "(a) deterministic, teacher-forced 2048", k, p))

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
        errors["mol-float32"].append(compare(
            "(c) stochastic, same noise, teacher-forced 2048", k, p))

        B, T = 8, 4096
        proj = lc_proj_for("mol-float32", B, T)
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

    with phase("softmax head, f32: kernel vs plain twin, full width, B=4"), \
            torch.no_grad():
        packed = packs["softmax-float32"]
        B, T = 4, 1024
        proj = lc_proj_for("softmax-float32", B, T)
        primed = prime_classes(B, T, 11)
        k = wavenet_generate(packed, proj, deterministic=True, primed=primed,
                             prime_len=T)
        p = generate_plain(packed, proj, deterministic=True, primed=primed,
                           prime_len=T)
        err, agree_a = compare_classes(
            "(a) deterministic, teacher-forced 1024", k, p, CLASS_AGREE_F32)
        errors["softmax-float32"].append(err)

        proj_b = proj[:, :256].contiguous()
        k = wavenet_generate(packed, proj_b, deterministic=True)
        p = generate_plain(packed, proj_b, deterministic=True)
        compare_classes("(b) deterministic, free-running 256", k, p, 1.0)
        if len(torch.unique(k)) < 2:
            raise AssertionError("(b) free-running class stream is constant")

        noise = torch.rand(T, B, Q, device=dev,
                           generator=torch.Generator(dev).manual_seed(12))
        k = wavenet_generate(packed, proj, noise=noise, primed=primed,
                             prime_len=T, temperature=0.7)
        p = generate_plain(packed, proj, noise=noise, primed=primed,
                           prime_len=T, temperature=0.7)
        err, agree_c = compare_classes(
            "(c) stochastic T=0.7, same noise, teacher-forced 1024", k, p,
            CLASS_AGREE_F32)
        errors["softmax-float32"].append(err)
        agreement["softmax-float32"] = min(agree_a, agree_c)

        B, T = 8, 4096
        proj = lc_proj_for("softmax-float32", B, T)
        primed = prime_classes(B, T, 13)
        k = wavenet_generate(packed, proj,
                             generator=torch.Generator(dev).manual_seed(14),
                             primed=primed, prime_len=T)
        p = generate_plain(packed, proj,
                           generator=torch.Generator(dev).manual_seed(15),
                           primed=primed, prime_len=T)
        stat, dof, bound = chi2_two_sample(k.cpu().numpy().ravel(),
                                           p.cpu().numpy().ravel(), Q)
        log(f"  (d) Philox vs torch.Generator, 8 x 4096 classes "
            f"teacher-forced: chi2={stat:.1f} on {dof} dof (bound {bound:.1f}"
            f" at alpha={ALPHA}); distinct classes kernel "
            f"{len(torch.unique(k))} plain {len(torch.unique(p))}")
        if not stat < bound:
            raise AssertionError("(d) Philox classes differ in distribution")
        del proj, primed, noise, k, p

    with phase("bf16 weights: kernel vs bf16 twin, full width, B=4"), \
            torch.no_grad():
        B, T = 4, 1024
        signals = {"mol": prime_signal(B, T, 21),
                   "softmax": prime_classes(B, T, 22)}
        for head, primed in signals.items():
            proj = lc_proj_for(f"{head}-bfloat16", B, T)
            run = lambda fn, dt: fn(packs[f"{head}-{dt}"], proj,
                                    deterministic=True, primed=primed,
                                    prime_len=T)
            k16 = run(wavenet_generate, "bfloat16")
            t16 = run(generate_plain, "bfloat16")
            k32 = run(wavenet_generate, "float32")
            err, agree = compare_bf16(
                f"{head}, deterministic, teacher-forced {T}", k16, t16, k32,
                classes=head == "softmax")
            errors[f"{head}-bfloat16"].append(err)
            if agree is not None:
                agreement[f"{head}-bfloat16"] = agree
            a, b = k16, k32
            if head == "softmax":
                log(f"  softmax drift, bf16 kernel vs f32 kernel: same class "
                    f"{float((a == b).float().mean()):.5f}")
                a, b = inv_mulaw_quantize(a, Q), inv_mulaw_quantize(b, Q)
            a, b = a.cpu().numpy().ravel(), b.cpu().numpy().ravel()
            corr = float(np.corrcoef(a, b)[0, 1])
            rel = float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-8))
            log(f"  {head} drift, bf16 kernel vs f32 kernel"
                f"{' (decoded)' if head == 'softmax' else ''}: corr "
                f"{corr:.5f}, mean relative drift {rel:.5f} (printed, not "
                "bounded)")
        del proj, signals, primed, k16, t16, k32

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        with phase("main path: WaveNetGenerator on the card"):
            gen = WaveNetGenerator(cfg, params, device="cuda")
            gen32 = WaveNetGenerator(cfg, params, device="cuda",
                                     weight_dtype=f32)
            gen_q = WaveNetGenerator(cfg_q, params_q, device="cuda")
            gen_q32 = WaveNetGenerator(cfg_q, params_q, device="cuda",
                                       weight_dtype=f32)
            if (gen.weight_dtype, gen_q.weight_dtype) != (bf16, bf16):
                raise AssertionError("the card's default weights are not bf16")
            hop, sr = cfg.audio.hop_size, cfg.audio.sample_rate
            # (name, generator, mel(s), wav_seed from request, temperature)
            requests = [
                ("raw bf16: batched 4 mels", gen, mels, None, 1.0),
                ("raw bf16: single 0.mel", gen, mels[0], None, 1.0),
                ("raw bf16: wav_seed 1.mel", gen, mels[1],
                 "raw bf16: single 0.mel", 1.0),
                ("raw f32: single 0.mel", gen32, mels[0], None, 1.0),
                ("mulaw-quantize bf16: 2.mel at T=0.7", gen_q, mels[2], None,
                 0.7),
                ("mulaw-quantize bf16: wav_seed 3.mel", gen_q, mels[3],
                 "mulaw-quantize bf16: 2.mel at T=0.7", 1.0),
                ("mulaw-quantize f32: 2.mel at T=0.7", gen_q32, mels[2], None,
                 0.7),
            ]
            results = {}
            wavenet_generate.launches = 0
            wavenet_generate.variant_launches.clear()
            for i, (name, g, mel, seed_from, temp) in enumerate(requests):
                seed_wav = (None if seed_from is None
                            else results[seed_from][0][:hop * 20])
                before = wavenet_generate.launches
                t0 = time.perf_counter()
                out = g.generate(mel, seed=i, wav_seed=seed_wav,
                                 temperature=temp)
                dt = time.perf_counter() - t0
                wavs = out if isinstance(out, list) else [out]
                mlist = mel if isinstance(mel, list) else [mel]
                if wavenet_generate.launches != before + 1:
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
            main_launches = dict(wavenet_generate.variant_launches)
            log(f"  launches on the main path: {main_launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    with phase("speaker ids: out of range raises on the host, the card "
               "works after"):
        ws = dataclasses.replace(w, num_speakers=2, gc_channels=16)
        gen_s = WaveNetGenerator(dataclasses.replace(cfg, wavenet=ws),
                                 seeded_params(ws, seed=0, device=dev),
                                 device="cuda")
        mel = mels[0][:20]
        try:
            gen_s.generate(mel, speaker_id=2)
        except IndexError as e:
            log(f"  speaker_id=2 of 2 speakers: IndexError ({e})")
        else:
            raise AssertionError("speaker_id=2 of 2 speakers did not raise")
        last = gen_s.generate(mel, speaker_id=-1, seed=3)
        one = gen_s.generate(mel, speaker_id=1, seed=3)
        torch.cuda.synchronize()
        if last.shape != (20 * cfg.audio.hop_size,) or not (
                np.isfinite(last).all() and np.abs(last).max() <= 1):
            raise AssertionError("generation after the IndexError failed")
        if not np.array_equal(last, one):
            raise AssertionError("speaker_id=-1 is not the last speaker")
        log(f"  then speaker_id=-1: {last.shape[0]} finite samples, equal "
            "to speaker_id=1 on the same seed")
        del gen_s

    taco = tacotron_phases(dev, cfg, gen, smi)
    text_launches = taco.pop("launches")

    timing = {}
    with phase("kernel timing at the main path's shapes"), torch.no_grad():
        B = len(mels)
        T = max(m.shape[0] for m in mels) * cfg.audio.hop_size
        for v, packed in packs.items():
            temp = 0.7 if v.startswith("softmax") else 1.0
            proj = lc_proj_for(v, B, T)
            gen_t = torch.Generator(dev).manual_seed(6)
            ms = cuda_ms(lambda: wavenet_generate(
                packed, proj, generator=gen_t, temperature=temp))
            # The twin launches hundreds of small ops per sample: it is
            # timed on a SPAN-step span of the same streams, and the kernel
            # on that span too, so the two times compare directly.
            proj_s = proj[:, :SPAN].contiguous()
            del proj
            plain_ms = cuda_ms(lambda: generate_plain(
                packed, proj_s, generator=gen_t, temperature=temp))
            span_ms = cuda_ms(lambda: wavenet_generate(
                packed, proj_s, generator=gen_t, temperature=temp))
            flops = generate_flops(packed, B, T)
            nbytes = generate_bytes(packed, B, T)
            t_ops = flops / PEAK_FLOPS_S[packed["w_tap"].dtype] * 1e3
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            timing[v] = dict(ms=ms, plain_ms=plain_ms, span_ms=span_ms,
                             t_ops=t_ops, t_bytes=t_bytes)
            log(f"  wavenet_generate[{v}] B={B} T={T}: {ms:.1f} ms "
                f"({ms / T * 1e3:.1f} us per step, {B * T / ms * 1e3:.0f} "
                f"samples/s aggregate); bound {max(t_ops, t_bytes):.2f} ms "
                f"({flops:.3e} FLOP, {nbytes:.3e} B); {SPAN} steps: kernel "
                f"{span_ms:.2f} ms, plain twin {plain_ms:.1f} ms [{smi}]")

    side = {}
    with phase(f"previous step design beside the kernel, B=4 T={SIDE_T}"), \
            torch.no_grad():
        kernel_launcher = G._launcher
        parent = build.load_library("wavenet_gen_block").wavenet_gen_launch
        parent.argtypes = kernel_launcher().argtypes
        parent.restype = kernel_launcher().restype
        B, T = 4, SIDE_T
        try:
            for v, packed in packs.items():
                temp = 0.7 if v.startswith("softmax") else 1.0
                proj = lc_proj_for(v, B, T)
                times = {"parent": [], "kernel": []}
                # parent, kernel, kernel, parent: in turns on one card
                for name in ("parent", "kernel", "kernel", "parent"):
                    fn = parent if name == "parent" else kernel_launcher()
                    G._launcher = lambda fn=fn: fn
                    gen_t = torch.Generator(dev).manual_seed(8)
                    wavenet_generate(packed, proj[:, :64].contiguous(),
                                     generator=gen_t, temperature=temp)
                    times[name].append(cuda_ms(lambda: wavenet_generate(
                        packed, proj, generator=gen_t, temperature=temp))
                        / T * 1e3)
                side[v] = {k: min(x) for k, x in times.items()}
                log(f"  {v}: previous {times['parent']} us per step, "
                    f"kernel {times['kernel']} us per step")
        finally:
            G._launcher = kernel_launcher
        log(f"previous step design vs kernel, us per step at B=4 T={T}: "
            + "; ".join(f"{v} {t['parent']:.1f} -> {t['kernel']:.1f} "
                        f"(x{t['parent'] / t['kernel']:.2f})"
                        for v, t in side.items()) + f" [{smi}]")

    kernels = []
    for v, t in timing.items():
        if main_launches.get(v, 0) < 1:
            raise AssertionError(f"the main path did not launch {v}")
        entry = {
            "name": f"wavenet_generate[{v}]",
            "route": "cuda",
            "source": f"{PKG}/csrc/wavenet_gen.cu",
            "replaces": TPU_KERNEL,
            "launches": main_launches[v],
            "max_abs_err": max(errors[v]),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "plain_steps": SPAN,
            "ms_plain_steps": t["span_ms"],
            "bound_ms": max(t["t_ops"], t["t_bytes"]),
            "bound_by": "operations" if t["t_ops"] >= t["t_bytes"] else "bytes",
            "library_ms": None,
            "launches_text_to_wav": text_launches.get(v, 0),
            "side_by_side_steps": SIDE_T,
            "us_per_step": side[v]["kernel"],
            "parent_us_per_step": side[v]["parent"],
        }
        if v in agreement:
            entry["class_agreement"] = agreement[v]
        kernels.append(entry)
    log(f"total wall time {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"tacotron": taco}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
