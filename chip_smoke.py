#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: build the generation kernel,
hold each of its four variants (mixture-of-logistics or 256-way softmax
head, f32 or bf16 weights) against its plain twin at full width and at
other widths (the ``widths`` phases: twice wn_moon's residual width,
timed, and served by ``WaveNetGenerator``; four times, past one block's
shared memory, on the cluster instance (each stream split over 4
blocks), timed and served in both weight types; R != D; TINY's widths and
widths off the 8-channel grid; 40 front taps and 40 components; 300
classes; a config over the 8-block ceiling refused), drive the
vocoder serving path (mel -> wav) through ``WaveNetGenerator``, check that
an out-of-range speaker id leaves the card working, drive text -> mel
(``Synthesizer``, Tacotron at the ``both_r2`` width) and text -> wav (its
mels through the bf16 generator), hold the card's f32 Tacotron decode
against the CPU's, time the decode; then serve the trained checkpoints
(read by the port's own zstd / OCDBT / zarr reader, timed): trained
``wn_moon`` through both MoL variants against their twins and on the
committed mel, with its MCD to the wav the JAX system made (beside the
seeded weights'), trained ``both_r2`` card against CPU, its served decode
and its DTW distance to the committed mel, and text -> wav with both
trained models; then the system's entry point, ``TTSPipeline`` from both
trained checkpoints: Griffin-Lim on the card against the CPU (the same
initial phase) and timed, one ``tts`` call on four texts (one kernel
launch; Tacotron, Griffin-Lim and vocoder times), the MCD of its
Griffin-Lim wav to the JAX system's beside the seeded Tacotron's, and the
``tts`` and ``synthesizer`` CLIs in subprocesses; then time the kernel.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero, printing no result, when
either is missing or when this file stands outside the repository.  The
seeded phases use random weights, made from a seed at the full width of
the repository's ``wn_moon`` WaveNet (its ``params.json`` is read from the
checkpoint tarball): as it is (raw input, MoL head), and switched to
``mulaw-quantize`` (one-hot input, softmax head over 256 classes).  The
vocoder's requests are the committed Tacotron mels
``samples/both_r2/{0,1,2,3}.mel.npy``; the Tacotron's are four Korean
texts (two per speaker, with digits and Latin letters), decoded with
seeded weights over the served 200 steps in bf16 with prenet dropout, as
``both_r2``'s ``params.json`` asks (the port's ``config.BOTH_R2``).  The
trained phases read ``artifacts/wn_moon.ckpt.tar.gz`` (``ema_params``) and
``artifacts/both_r2.ckpt.tar.gz`` (``params``, ``batch_stats``).

Last, WaveNet training and its data pipeline.  The committed
``samples/wn_moon_260k`` wavs become a moon-layout corpus, preprocessed
on the card by the ``preprocess`` CLI and held against the CPU.  On
``WaveNetBatcher`` crops of it at the ``wn_moon`` width (B = 8, 15,000
samples, as its ``params.json`` trains): 20 seeded Adam steps in f32 and
in bf16, one step on the card against the CPU (f32 and bf16), resuming
``wn_moon`` from its tarball at step 260,250 with its optimizer state,
three saves with the port's ``CheckpointManager`` (two kept), the saved
EMA served through one kernel launch, and the step's time, peak memory
and kernels.  Then the batcher's device store against its host path and
the prefetcher, ``wn_moon`` resumed through the ``train_vocoder`` CLI for
20 steps and its run resumed again for 10, a seeded two-speaker run, the
run served through the ``generate`` CLI (one kernel launch), and the
feeder's wait share with the store on and off.

Then the evaluation commands, in process on the trained tarballs and
that corpus, split into two speaker dirs (moon and son): ``vocoder_eval``
(one kernel launch per clip), ``quality_eval --heldout --wavenet`` (one
per utterance) and ``wavenet_diagnose`` on the card and on the CPU, with
their keys, their utterances, finite MCDs and wavs, and the diagnosis
card against CPU.

Then Tacotron training on those two speaker dirs, at
``both_r2``'s config: ``both_r2`` resumed at step 106,000 through the
``train_tacotron`` CLI for 10 steps (the learning rate held to the Noam
schedule, the loss below seeded weights'), then side by side its run
resumed for 5 more, a seeded single-speaker run, and the run served
through the ``tts`` CLI with the trained vocoder (one kernel launch);
the batcher's device store against its host path; one f32 step of the
trained state the CLI left (weights, batch statistics, Adam) on the card
against the CPU with the same dropout masks; the step's time, kernels,
busy share and peak memory at B = 32 with the corpus's 250 target
frames, f32 and bf16.

Last, multi-rank training on the one card (two ranks share it over gloo;
the phases show correctness and overheads, not scaling across cards):
``train_vocoder --use_mesh`` resuming ``wn_moon`` as one plain process
beside the run without it, and on two ranks launched by
``torch.distributed.run``, served by the ``generate`` CLI (one kernel
launch); the WaveNet mesh step at the ``wn_moon`` width as (n_data,
n_model) = (1, 2) and (2, 1) against one process; Tacotron's data-parallel
step at the ``both_r2`` width on two ranks against one, and
``train_tacotron --use_mesh`` on two ranks beside one; the steps' times
and the collectives' share.

Wavs, run dirs and unpacked checkpoints go to temporary directories that
are removed.  A ``tacotron``, a ``trained``, a ``tts``, a ``train``, a
``data``, a ``taco_train``, an ``attention`` and a ``mesh`` JSON line carry
those phases' numbers, an ``eval`` line the evaluation commands' results
and walls, and the ``kernels`` line, per variant, the widths held with
their errors and the 2x-width times, and the four cluster variants at 4x
(blocks per stream, slots, bytes per block, launches of their serving
path, error, time); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import ctypes
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
# The trained checkpoints, and what the JAX system made with them: text 0
# of samples/README.md (speaker 0) through Tacotron (E2E_MEL, also
# samples/both_r2/0.mel.npy) and the WaveNet vocoder (E2E_WAV).
WN_MOON = CONFIG
BOTH_R2 = os.path.join(REPO, "artifacts", "both_r2.ckpt.tar.gz")
TEXT0 = "존경하는 국민 여러분, 안녕하십니까."
E2E_MEL = os.path.join(REPO, "samples", "e2e_both_r2_wn_moon", "0.mel.npy")
E2E_WAV = os.path.join(REPO, "samples", "e2e_both_r2_wn_moon",
                       "0.wavenet.wav")
E2E_GL_WAV = os.path.join(REPO, "samples", "e2e_both_r2_wn_moon", "0.wav")
TACO_MEL0 = os.path.join(REPO, "samples", "both_r2", "0.mel.npy")
# Trained kernel-vs-twin spans start at these frames of E2E_MEL, primed
# with the committed wav's samples there.
TRAINED_FRAMES = (20, 60, 100, 140)
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
# Timing: each variant over TIME_T steps of TIME_B streams, the main
# path's batch (a step's time does not depend on T: the card gives the
# same us per step at T = 8,192 and 104,400); the plain twin and the kernel
# over the first teacher-forced span of the comparison phases.  Trained
# wn_moon is held over SPAN steps.
TIME_B, TIME_T = 4, 16384
SPAN = 128
# Other widths (``widths`` phases): f32 kernel vs twin over WIDTH_T
# teacher-forced and WIDTH_FREE free-running steps of TIME_B streams, bf16
# over WIDTH_BF16_T teacher-forced steps of WIDTH_BF16_B streams (enough
# component flips on both sides for compare_bf16's ratio of flip shares;
# the twin's time goes with the steps, not the streams); the 2x-width variants
# timed over WIDTH_TIME_T steps, the cluster instance at 4x (R = D = 128)
# over CLUSTER_TIME_T; the generator on WIDTH_FRAMES frames of the first
# committed mel.
WIDTH_T, WIDTH_FREE, WIDTH_BF16_B, WIDTH_BF16_T = 128, 64, 8, 256
WIDTH_TIME_T, CLUSTER_TIME_T, WIDTH_FRAMES = 4096, 2048, 20
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
TACO_REPS = 1          # timed repetitions of each decode, after a warm-up
ALIGN_SUM_TOL = 1e-3     # a column of monotonic attention sums to <= 1
# Griffin-Lim card vs CPU, the same initial phase: cuFFT and the CPU's FFT
# round differently, 60 iterations carry it and the inverse pre-emphasis
# (gain up to 1 / (1 - 0.97)) amplifies it; the port against JAX, both on
# a CPU, differ by ~6e-6 on the committed mel (tests/test_torch_griffin_lim.py).
GL_TOL = 1e-4
GL_REPS = 3
# The end-to-end request: TEXT0 and three of TEXTS, both speakers.
TTS_TEXTS = [TEXT0] + TEXTS[1:]
TTS_SPEAKERS = [0, 1, 0, 1]
CLI_TIMEOUT_S = 300
# WaveNet training at the wn_moon width: WaveNetBatcher crops of the
# committed wavs that the trained wn_moon made, preprocessed by the port.
TRAIN_WAVS = os.path.join(REPO, "samples", "wn_moon_260k")
TRAIN_B, TRAIN_T = 8, 15000       # params.json's batch_size and sample_size
TRAIN_STEPS = 20                  # seeded Adam steps on one fixed batch
# Card against CPU, one step of the same state: B = 1 and 21 frames (1,153
# outputs past the receptive field), f32 with TF32 off, on trained wn_moon
# (params and optimizer state).  The loss agrees to summation order; the
# graph's gradient under one cotangent to 1e-4 of each leaf's largest; the
# step's update to 1e-2 of each leaf's largest (Adam divides by sqrt(nu),
# which magnifies rounding where nu is tiny).  The MoL loss's own gradient
# is ill-conditioned in f32 (tests/test_torch_wavenet_train.py): the card's
# whole gradient is held to TRAIN_F64_RATIO times the CPU's own f32 - f64
# distance.  Seeded weights (fresh Adam state) are compared too, with only
# the loss bounded: there a rounding difference can cross a ReLU's kink in
# the skip sum (its gradient jumps) and Adam's first step, g / (|g| + eps),
# turns the sign of a gradient element that is rounding noise into a full
# update.
TRAIN_CMP_T = 6300
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_UPDATE_TOL = 1e-5, 1e-4, 1e-2
TRAIN_F64_RATIO = 3.0
TRAIN_BF16_RATIO = 2.0            # card bf16 vs CPU bf16, against bf16 - f32
TRAIN_RESUME_STEPS = 5
TRAIN_REPS = 5                    # timed steps, after a warm-up
TRAIN_SERVE_FRAMES = 40

# The data pipeline and the training CLI: the committed wn_moon_260k clips
# as a moon-layout corpus (text 0 for every clip), preprocessed on the
# card by the port's CLI with 4 workers (before the training phases, which
# train on it) and held against the CPU on DATA_CMP_CLIPS.  After the
# training phases: the batcher's device store against its host path and
# the prefetcher (DATA_BATCHES batches of wn_moon's B = 8, T = 15,000);
# wn_moon resumed through the train_vocoder CLI to DATA_RESUME_TO and then
# DATA_RESUME_MORE (boundaries as DATA_HPARAMS); a seeded two-speaker run
# of DATA_GC_STEPS steps; the run served through the generate CLI; the
# feeder's wait share over DATA_FEED_STEPS steps with the store on and
# off.  DATA_OVERRIDES cuts the batch for a rehearsal on the CPU (empty on
# the card), DATA_SERVE_MEL the mel served.
DATA_CMP_CLIPS = ("003.0000.wn.wav", "006.0028.wn.wav",
                  "NB10584578.0000.wn.wav", "NB10585784.0007.wn.wav")
DATA_MEL_TOL = 1e-4
DATA_LIN_F64_RATIO = 2.0
DATA_F16_ATOL, DATA_F16_RTOL = 4e-3, 2e-3
DATA_BATCHES = 5
DATA_START = 260250
DATA_RESUME_TO, DATA_RESUME_MORE = 260270, 260280
DATA_HPARAMS = ("train.sync_every=10,train.summary_interval=20,"
                "train.test_interval=20")
DATA_GC_STEPS = 10
DATA_FEED_STEPS = 10
DATA_OVERRIDES: dict = {}
DATA_SERVE_MEL = E2E_MEL
# Tacotron training on the corpus above, split into two speaker dirs (10
# 003.* / 006.* clips -> speaker 0, 8 NB* clips -> speaker 1; 40-240 frames,
# text 0), at both_r2's config (B = 32, bf16, deepvoice, 2 speakers).
# (a) one f32 step of the trained state the CLI of (c) leaves (both_r2's
# weights, batch_stats and Adam state, 15 steps on), card vs CPU, B = 4,
# the same dropout masks.  Bounds from measurement (on an NVIDIA H100
# 80GB HBM3 at 700 W: loss 2.3e-7 relative, params 5.2e-7 and batch_stats
# 1.6e-7 of each leaf's largest |value|; the update alone is not bounded:
# where Adam's nu is small it turns gradient rounding into 0.05% of the
# update).
TACO_CMP_B = 4
TACO_LOSS_TOL, TACO_PARAM_TOL, TACO_STATS_TOL = 1e-5, 5e-5, 1e-5
# and the gradient of seeded weights (B = 2, dropout off), card vs CPU in
# the L2 norm, as tests/test_torch_cuda.py holds it.
TACO_GRAD_TOL = 1e-5
# (b) the step's time, kernels and device time at full width on the
# corpus's B = 32 x 250 frames.
TACO_TIMING_SHAPES = ((32, 48, 250),)
TACO_TRAIN_REPS = 2               # timed steps, after a warm-up
# (c) both_r2 resumed through the train_tacotron CLI over two calls.
TACO_START, TACO_RESUME_TO, TACO_RESUME_MORE = 106000, 106010, 106015
TACO_HPARAMS = ("train.sync_every=5,train.summary_interval=5,"
                "train.test_interval=10,train.best_eval_batches=1")
TACO_WARMUP = 4000.0              # the schedule of a --load_path resume
TACO_LR_TOL = 1e-9
# A CPU rehearsal's smaller size: tacotron overrides in-process, and the
# CLI flags that give them to the subprocesses.
TACO_OVERRIDES: dict = {}
TACO_CLI_ARGS: list = []
TACO_STORE_BATCHES = 32           # (d): one group of 32 batches
TACO_SEEDED_STEPS = 10            # (e)
# Every attention type of the JAX table, and bah_mon_norm with simple
# speakers ("simple"), at the both_r2 width with seeded weights.  (a) TEXTS
# decoded at B = 4 in bf16 over ATT_SERVE_STEPS steps with prenet dropout,
# as served; the padded encoder positions get < ATT_MASKED_TOL (JAX's
# test_attention_types_forward); the decoder loop timed over ATT_REPS
# after a warm-up, kernels per step by torch.profiler (40 - 20 steps).
# (b) a deterministic decode of TEXTS[:ATT_CMP_B] over ATT_CMP_STEPS, card
# vs CPU: f32 within ATT_F32_TOL of the largest |value| (the alignments'
# for the alignments, the mel's for mel and linear, or the bound itself
# below 1: GMM's alignments are unnormalised), bf16 within
# TACO_BF16_RATIO x the CPU's own mean |bf16 - f32|.  (c) the gradient
# of one f32 training step (B = ATT_CMP_B, T_out = ATT_GRAD_T_OUT, the
# same dropout masks), card vs CPU: the loss within TACO_LOSS_TOL
# relative, the whole gradient within TACO_GRAD_TOL in the L2 norm; gmm's
# within ATT_GMM_GRAD_TOL: at seeded weights its unnormalised alignments
# give a loss of ~100 (printed; the others' ~1.7), and its f32 gradient
# there is ill-conditioned: the port and JAX, both on a CPU, part by
# ~1e-3 (tests/test_torch_attention_train.py), and the CPU's own
# gradient moves by ~6e-3 with oneDNN's convolutions off (printed for
# every type).  (d)
# train_tacotron --model_type simple from seeded weights on the two
# speaker dirs, ATT_CLI_STEPS steps, served by the tts CLI with trained
# wn_moon for speakers 0 and 1 (one kernel launch).
ATT_SERVE_STEPS = 200
ATT_REPS = 1
ATT_MASKED_TOL = 1e-3
ATT_CMP_B = 2
ATT_CMP_STEPS = 25
ATT_F32_TOL = 1e-4
ATT_GRAD_T_OUT = 100
ATT_GMM_GRAD_TOL = 2e-2
ATT_CLI_STEPS = 5
ATT_CLI_HPARAMS = ("tacotron.compute_dtype=bfloat16,tacotron.fused_rnn=true,"
                   "tacotron.scan_unroll=8,train.sync_every=5,"
                   "train.summary_interval=5,train.test_interval=5,"
                   "train.best_eval_batches=1")
# The mesh, on the one card: two ranks share it over gloo (NCCL refuses
# two ranks on one device), so these phases show that the mesh code runs
# on CUDA tensors and computes what one process computes, and its
# overheads; not scaling across cards.  (a) train_vocoder --use_mesh as
# one plain process (a one-rank NCCL mesh) resuming wn_moon for
# MESH_CLI_STEPS steps beside the run without --use_mesh: the same kernels
# in the same order, so whatever parts them is the card's own
# nondeterminism (atomics in some backward convolutions), which the MoL
# loss's ill-conditioned gradient and Adam carry from step to step (a CPU
# rehearsal, whose sums depend on the thread count, parted 1.5e-6 at the
# first step and 6.4e-4 in the loss by the tenth); (b) the same on 2 ranks
# (torch.distributed.run) beside (a).  Each: the first step's loss within
# MESH_FIRST_TOL relative (only the order of the sums differs), the later
# losses within MESH_LATER_TOL, grad_norm and the rest printed; (b)'s run
# served by the
# generate CLI on a MESH_SERVE_FRAMES-frame mel (one kernel launch).  (c)
# The WaveNet mesh step at the wn_moon width (B = 8, T = 15,000, resumed,
# f32) as (n_data, n_model) = (1, 2) and (2, 1) against one process: in
# float64 on the first MESH_F64_T samples of each crop, the graph's
# gradient under one cotangent into raw_output and the loss's gradient
# within MESH_GRAD_TOL of each leaf's largest |value|;
# the f32 step's loss within 1e-5 relative.  The gradients are compared in
# float64 because in f32 they are ill-conditioned at trained wn_moon on
# real crops: the MoL loss's cdf_delta cancels, and a rounding difference
# crosses a ReLU's kink in the skip sum.  In a CPU rehearsal (B = 2, T =
# 6,000) one process's f32 graph gradient at B = 2 parted from float64 by
# 0.42 of layer_13_skip_kernel's largest while the sum of the two B = 1
# gradients stayed within 7e-6.  (d)
# Tacotron at both_r2's width in f32 (so the comparison is not bf16's
# rounding), seeded weights, B = MESH_TACO_B, the global batch's dropout
# masks: one step's gradient on 2 ranks within TACO_GRAD_TOL of 1 in L2,
# the new running variances within MESH_STATS_TOL of each leaf's largest,
# the running means of the largest of all means; then train_tacotron
# --use_mesh on 2 ranks beside 1 as in (b).
# (e) s/step over MESH_REPS steps, then the collectives' share with the
# device synchronised around each collective (host clock).
MESH_RANK_TIMEOUT_S = 300
MESH_CLI_STEPS = 10
MESH_HPARAMS = ("train.sync_every=1,train.summary_interval=1,"
                "train.test_interval=10")
MESH_FIRST_TOL, MESH_LATER_TOL = 1e-5, 1e-3
MESH_SERVE_FRAMES = 40
MESH_GRAD_TOL = 1e-5
MESH_F64_T = TRAIN_CMP_T          # the float64 gradients' crop
MESH_STATS_TOL = 1e-6
MESH_TACO_B = 32
MESH_TACO_SEED = 5
MESH_TACO_HPARAMS = ("tacotron.fused_rnn=true,tacotron.scan_unroll=8,"
                     "tacotron.compute_dtype=float32,train.sync_every=1,"
                     "train.summary_interval=1,train.test_interval=1000,"
                     "train.best_eval_batches=0")
MESH_REPS = 1
# The evaluation commands on the trained tarballs and the two speaker dirs
# above (10 moon clips, 8 son clips: the split of the JAX run behind
# artifacts/wn_moon.eval.json).  (a) vocoder_eval: EVAL_N clips of the
# moon dir (its 2 held-out ones first) and EVAL_N_UNSEEN of the son dir,
# each mel padded to EVAL_FRAMES, one bf16 MoL launch per clip.  (b)
# quality_eval --heldout --wavenet: EVAL_N_SPEAKER per speaker, each free-
# run mel cut to EVAL_FRAMES and vocoded in one launch.  (c)
# wavenet_diagnose over EVAL_CROPS crops, on the card and on the CPU (the
# same crops and draws): correlation and MAE within EVAL_DIAG_TOL (the
# forward's summation order on the card is all that differs).
EVAL_N, EVAL_N_UNSEEN, EVAL_FRAMES = 3, 2, 80
EVAL_N_SPEAKER = 2
EVAL_CROPS = 4
EVAL_DIAG_TOL = 1e-3


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


def compare_classes(name, got, want, min_agree, n_classes=256):
    agree = float((got == want).float().mean())
    err = float((got - want).abs().max())
    log(f"  {name}: class agreement {agree:.5f} (bound >= {min_agree}), "
        f"max_abs_err {err:g}, {len(torch.unique(got))} distinct classes")
    if not (torch.equal(got, got.round()) and float(got.min()) >= 0
            and float(got.max()) < n_classes):
        raise AssertionError(f"{name}: kernel output is not class ids")
    if agree < min_agree:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin")
    return err, agree


def early_max(err, skip_flips=False) -> float:
    """The largest MoL error over the first BF16_EARLY steps, of the steps
    that are not component flips (> BF16_JUMP) when ``skip_flips``."""
    err = err[:, :BF16_EARLY]
    if skip_flips:
        err = err[err <= BF16_JUMP]
    return float(err.max()) if err.numel() else 0.0


def compare_bf16(name, k16, t16, k32, classes, early_tol=BF16_EARLY_TOL,
                 early_skip_flips=False):
    """bf16 kernel ``k16`` against its bf16 twin ``t16``, measured against
    the twin's own distance from the f32 kernel ``k32`` (see BF16_RATIO).
    MoL: mean abs error and share of component flips, and the largest
    error over the first BF16_EARLY steps (with ``early_skip_flips``, of
    the steps that are not flips: those the flip share holds) at most
    ``early_tol``; softmax: share of differing classes.  Returns (max abs
    error, class agreement or None)."""
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
        early = early_max(e_kt, early_skip_flips)
        mean_kt, mean_tf = float(e_kt.mean()), float(e_tf.mean())
        jump_kt = float((e_kt > BF16_JUMP).float().mean())
        jump_tf = float((e_tf > BF16_JUMP).float().mean())
        agree = None
        log(f"  {name}: first {BF16_EARLY} steps max_abs_err {early:.3e}"
            f"{' but flips' if early_skip_flips else ''} (bound "
            f"{early_tol:.3e}); mean abs err kernel/twin "
            f"{mean_kt:.3e} (bound <= {BF16_RATIO:g} x {mean_tf:.3e}, twin "
            f"bf16/f32); flips (>{BF16_JUMP:g}) {jump_kt:.5f} (bound <= "
            f"{BF16_RATIO:g} x {jump_tf:.5f}); max_abs_err "
            f"{float(e_kt.max()):.3e}")
        ok = (early <= early_tol and mean_kt <= BF16_RATIO * mean_tf
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


def kernel_count(fn, host: bool = True) -> tuple:
    """(CUDA kernels, kernel launch calls, device time in us) of ``fn``,
    counted by torch.profiler; no kernels when it sees no device.  With
    ``host=False`` it traces the device alone and counts no launch calls
    (None): a step of ~10^5 kernels takes minutes to trace with the
    host's ops too."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    launch_calls = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    return (sum(e.count for e in kernels), launch_calls if host else None,
            sum(getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) for e in kernels))


def decoder_launches(model, enc, masks, steps: int) -> dict:
    """CUDA kernels launched per decoder step, counted by torch.profiler
    over runs of ``steps`` and 2 x ``steps`` steps (the difference, so the
    loop's set-up is not counted), and the profiler's device time."""
    counts = [kernel_count(lambda n=n: model.decoder(
        enc, n, [m[:n] for m in masks])) for n in (steps, 2 * steps)]
    launch_calls = (counts[1][1] - counts[0][1]) / steps
    if counts[1][0] == 0:                # the profiler saw no device
        return {"kernels_per_step": None, "device_us_per_step": None,
                "launch_calls_per_step": launch_calls}
    return {"kernels_per_step": (counts[1][0] - counts[0][0]) / steps,
            "launch_calls_per_step": launch_calls,
            "device_us_per_step": (counts[1][2] - counts[0][2]) / steps}


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
                loops = [cuda_ms(loop) for _ in range(TACO_REPS)]
                req_ms, loop_ms = np.mean(req), np.mean(loops)
                # Kernels per step do not depend on B: counted at B = 1.
                count = (decoder_launches(model, enc, masks, 20) if B == 1
                         else dict(count, device_us_per_step=None))
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


def mean_dtw_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Mean euclidean distance of the frames that DTW pairs (mels
    [frames, num_mels])."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.utils.metrics import (
        dtw_path)
    ia, ib = dtw_path(a, b)
    return float(np.linalg.norm(a[ia] - b[ib], axis=-1).mean())


def read_trained() -> dict:
    """Read both trained checkpoints with the port's own reader, time it,
    check every array is finite and every name and shape against the
    converters.  Returns the reader's numbers."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        flatten, params_from_jax, tacotron_params_from_jax)
    from tacotron_wavenet_vocoder_korean_tpu_torch.text import TextCodec
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        CheckpointReader)

    numbers = {}
    for name, path, items in (
            ("wn_moon", WN_MOON, ("ema_params", "step")),
            ("both_r2", BOTH_R2, ("params", "batch_stats", "step"))):
        t0 = time.perf_counter()
        with CheckpointReader(path) as reader:
            t1 = time.perf_counter()
            cfg = reader.config()
            tree = reader.restore(items=items)
            t2 = time.perf_counter()
            mb = reader.decoded_bytes / 1e6
        arrays = flatten({k: v for k, v in tree.items() if k != "step"})
        bad = [k for k, v in arrays.items() if not np.isfinite(v).all()]
        if bad:
            raise AssertionError(f"{name}: arrays not finite: {bad[:5]}")
        if name == "wn_moon":
            params_from_jax(cfg.wavenet, tree["ema_params"])
        else:
            tacotron_params_from_jax(
                cfg.tacotron, tree["params"], tree["batch_stats"], cfg.audio,
                TextCodec(cfg.tacotron.cleaners).vocab_size)
        step = int(tree["step"])
        log(f"  {name} step {step} ({', '.join(items[:-1])}): unpacked in "
            f"{t1 - t0:.2f}s, restored {len(arrays)} arrays = {mb:.3f} MB "
            f"decoded in {t2 - t1:.2f}s = {mb / (t2 - t1):.3f} MB/s; all "
            f"finite, names and shapes as the converter wants")
        numbers[name] = {"step": step, "arrays": len(arrays),
                         "decoded_mb": mb, "unpack_s": t1 - t0,
                         "restore_s": t2 - t1,
                         "mb_per_s": mb / (t2 - t1)}
    return numbers


def trained_phases(dev, gen_seeded, smi, tmp) -> dict:
    """The trained checkpoints on the card: read them (the reader timed
    alone, then the serving entry points), hold both MoL variants against
    their twins with the trained WaveNet, vocode the committed mel and
    measure its MCD to the JAX system's wav (beside the seeded weights'),
    vocode through the CLI, and run text -> mel -> wav with both trained
    models.  Returns the numbers for the ``trained`` line; ``launches``
    holds the kernel launches of the trained paths and ``max_abs_err`` the
    kernel-vs-twin errors."""
    from tacotron_wavenet_vocoder_korean_tpu_torch import generate
    from tacotron_wavenet_vocoder_korean_tpu_torch.config import BOTH_R2 as B2
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        seeded_tacotron_params)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import (
        load_wav)
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
        generate_plain, pack_params, precompute_lc_proj, wavenet_generate)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
        WaveNetGenerator)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.synthesizer import (
        Synthesizer, attention_trim_index)
    from tacotron_wavenet_vocoder_korean_tpu_torch.utils.metrics import mcd

    out = {}
    with phase("trained checkpoints: read on the card's host"):
        out["read"] = read_trained()
    with phase("trained checkpoints: load through the serving entry "
               "points"):
        t0 = time.perf_counter()
        gen = WaveNetGenerator.from_checkpoint(WN_MOON, device=dev)
        t1 = time.perf_counter()
        synth = Synthesizer.from_checkpoint(BOTH_R2, device=dev)
        t2 = time.perf_counter()
        log(f"  WaveNetGenerator.from_checkpoint (ema_params, step "
            f"{gen.step}): {t1 - t0:.2f}s; Synthesizer.from_checkpoint "
            f"(step {synth.step}): {t2 - t1:.2f}s")
        if (gen.step, synth.step) != (out["read"]["wn_moon"]["step"],
                                      out["read"]["both_r2"]["step"]):
            raise AssertionError("the entry points served another step")
        if gen.weight_dtype != torch.bfloat16 or (
                synth.model.dtype != torch.bfloat16):
            raise AssertionError("the trained models do not serve bf16")
        out["load_s"] = {"wn_moon": t1 - t0, "both_r2": t2 - t1}
    cfg_w, cfg_t = gen.cfg, synth.cfg
    a = cfg_w.audio
    sr, hop = a.sample_rate, a.hop_size
    mel_e2e = np.load(E2E_MEL).astype(np.float32)
    wav_e2e = load_wav(E2E_WAV, sr)

    with phase(f"trained wn_moon: kernel vs twin, both MoL variants, full "
               f"width, B=4, {SPAN} steps teacher-forced"), torch.no_grad():
        T, f = SPAN, -(-SPAN // hop)
        lc = gen.upsampler(torch.from_numpy(np.stack(
            [mel_e2e[s:s + f] for s in TRAINED_FRAMES])).to(dev))[:, :T]
        primed = torch.from_numpy(np.stack(
            [wav_e2e[s * hop:s * hop + T] for s in TRAINED_FRAMES],
            axis=1)).to(dev).contiguous()
        res = {}
        for dt in (torch.float32, torch.bfloat16):
            pk = pack_params(cfg_w.wavenet, gen.params, dt)
            proj = precompute_lc_proj(pk, lc)
            for fn in (wavenet_generate, generate_plain):
                res[fn is wavenet_generate, dt] = fn(
                    pk, proj, deterministic=True, primed=primed, prime_len=T)
        torch.cuda.synchronize()
        err32 = compare("f32, deterministic, teacher-forced",
                        res[True, torch.float32], res[False, torch.float32])
        # BF16_EARLY_TOL was set on seeded weights, whose output layer is
        # scaled down; the trained network carries a bf16 rounding step
        # further, so its early steps are held, as the other bf16 bounds
        # are, to BF16_RATIO times the twin's own distance from f32 there.
        early_noise = float((res[False, torch.bfloat16]
                             - res[True, torch.float32]
                             )[:, :BF16_EARLY].abs().max())
        log(f"  bf16 twin vs f32 kernel, first {BF16_EARLY} steps: max abs "
            f"{early_noise:.3e}")
        err16, _ = compare_bf16("bf16, deterministic, teacher-forced",
                                res[True, torch.bfloat16],
                                res[False, torch.bfloat16],
                                res[True, torch.float32], classes=False,
                                early_tol=BF16_RATIO * early_noise)
        out["kernel_vs_twin"] = {"mol-float32_max_abs_err": err32,
                                 "mol-bfloat16_max_abs_err": err16}
        if float(res[True, torch.float32].std()) == 0.0:
            raise AssertionError("trained teacher-forced output is constant")
        del res, proj, lc, primed

    launches = {}
    with phase("trained wn_moon: vocode the committed mel (bf16) and its "
               "MCD to the JAX system's wav; the CLI"):
        wavenet_generate.launches = 0
        wavenet_generate.variant_launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wav = gen.generate(mel_e2e, seed=0)
        dt = time.perf_counter() - t0
        launches["vocode"] = dict(wavenet_generate.variant_launches)
        if launches["vocode"] != {"mol-bfloat16": 1}:
            raise AssertionError(f"vocoding launched {launches['vocode']}")
        n = mel_e2e.shape[0] * hop
        if wav.shape != (n,) or not np.isfinite(wav).all() or (
                np.abs(wav).max() > 1):
            raise AssertionError(f"trained wav {wav.shape} not {n} finite "
                                 "samples in [-1, 1]")
        seeded = gen_seeded.generate(mel_e2e, seed=0)
        mcd_t = mcd(wav, wav_e2e, a)
        mcd_s = mcd(seeded, wav_e2e, a)
        context = {}
        for key, (fname, field) in {
                "wn_moon": ("wn_moon.eval.json", "wavenet_mcd_db"),
                "both_r2": ("both_r2.eval.json", "e2e_mcd_db")}.items():
            with open(os.path.join(REPO, "artifacts", fname)) as fh:
                context[key] = json.load(fh).get(field)
        log(f"  {mel_e2e.shape[0]} frames -> {n} samples in {dt:.3f}s = "
            f"{n / dt / sr:.3f}x realtime [{smi}]; std {wav.std():.4f}")
        log(f"  MCD to the committed 0.wavenet.wav: trained {mcd_t:.3f} dB, "
            f"seeded weights {mcd_s:.3f} dB (gate: trained < seeded); the "
            f"repo's own figures, other utterances and steps, not bounds: "
            f"wn_moon.eval.json wavenet_mcd_db {context['wn_moon']}, "
            f"both_r2.eval.json e2e_mcd_db {context['both_r2']}")
        if not mcd_t < mcd_s:
            raise AssertionError("the trained vocoder is no closer to the "
                                 "JAX system's wav than seeded weights")
        out["vocode"] = {"samples": n, "wall_s": dt, "x_realtime": n / dt / sr,
                         "mcd_trained_db": mcd_t, "mcd_seeded_db": mcd_s,
                         "repo_eval_json": context}
        del seeded
        mel_path = os.path.join(tmp, "cli.mel.npy")
        wav_path = os.path.join(tmp, "cli.wav")
        np.save(mel_path, mel_e2e[:20])
        wavenet_generate.variant_launches.clear()
        generate.main(["--load_path", WN_MOON, "--mel", mel_path, "--out",
                       wav_path])
        launches["cli"] = dict(wavenet_generate.variant_launches)
        cli_wav = load_wav(wav_path, sr)
        log(f"  generate.py --load_path (default device): "
            f"{launches['cli']}, {cli_wav.shape[0]} samples")
        if launches["cli"] != {"mol-bfloat16": 1} or cli_wav.shape != (
                20 * hop,):
            raise AssertionError("the CLI did not vocode on the card")

    with phase("trained both_r2: text -> mel -> wav on the card"), \
            torch.no_grad():
        r, iters = cfg_t.tacotron.reduction_factor, cfg_t.tacotron.max_iters
        cfg32 = dataclasses.replace(cfg_t, tacotron=dataclasses.replace(
            cfg_t.tacotron, compute_dtype="float32"))
        params_t = {k: v.cpu() for k, v in synth.model.state_dict().items()}
        inputs, lengths = synth._prepare_inputs([TEXT0])
        run = {}
        for c in (cfg32, cfg_t):
            for d in (dev, torch.device("cpu")):
                model = Synthesizer(c, params_t, device=d).model
                o = model(torch.from_numpy(inputs).long().to(d),
                          torch.from_numpy(lengths).long().to(d),
                          torch.zeros(1, dtype=torch.long, device=d))
                run[c.tacotron.compute_dtype, d.type] = {
                    k: v.float().cpu().numpy() for k, v in o.items()}
        if any(not np.isfinite(v).all() for o in run.values()
               for v in o.values()):
            raise AssertionError("a trained decode is not finite")
        card, cpu = run["float32", dev.type], run["float32", "cpu"]
        errs = {k: float(np.abs(card[k] - cpu[k]).max()) for k in cpu}
        log(f"  dropout off, f32 max abs err card vs CPU: {errs} (bound "
            f"{TACO_F32_TOL:g})")
        if max(errs.values()) > TACO_F32_TOL:
            raise AssertionError("the card's trained f32 decode differs from "
                                 "the CPU's")
        bf16 = {}
        for k in cpu:
            d_card = float(np.abs(run["bfloat16", dev.type][k]
                                  - run["bfloat16", "cpu"][k]).mean())
            d_noise = float(np.abs(run["bfloat16", "cpu"][k] - cpu[k]).mean())
            bf16[k] = {"card_vs_cpu": d_card, "cpu_bf16_vs_f32": d_noise}
            log(f"  dropout off, bf16 {k}: mean abs card vs CPU {d_card:.3e}"
                f", CPU bf16 vs f32 {d_noise:.3e} (bound "
                f"{TACO_BF16_RATIO:g}x)")
            if not 0 < d_noise or d_card > TACO_BF16_RATIO * d_noise:
                raise AssertionError(f"the card's trained bf16 decode ({k}) "
                                     "is farther from the CPU's than bf16 "
                                     "rounding")
        out["decode_card_vs_cpu"] = {"f32_max_abs_err": errs,
                                     "bf16_mean_abs_err": bf16}

        wavenet_generate.launches = 0
        wavenet_generate.variant_launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = synth.synthesize([TEXT0], speaker_ids=[0], rng_seed=0)[0]
        t1 = time.perf_counter()
        wav = gen.generate(res["mel"], seed=0)
        t2 = time.perf_counter()
        launches["text_to_wav"] = dict(wavenet_generate.variant_launches)
        if launches["text_to_wav"] != {"mol-bfloat16": 1}:
            raise AssertionError(f"text -> wav launched "
                                 f"{launches['text_to_wav']}")
        trim = attention_trim_index(res["alignment"], int(lengths[0]), r)
        log(f"  served decode (bf16, prenet dropout): trim index {trim} of "
            f"{iters * r} frames, kept {res['mel'].shape[0]}")
        if not trim < iters * r:
            raise AssertionError("the trained decode did not stop before "
                                 "max_iters")
        if wav.shape != (res["mel"].shape[0] * hop,) or not (
                np.isfinite(wav).all() and np.abs(wav).max() <= 1):
            raise AssertionError("trained text -> wav not finite in [-1, 1]")
        seeded_synth = Synthesizer(
            dataclasses.replace(cfg_t, tacotron=B2),
            seeded_tacotron_params(B2, seed=0, audio=cfg_t.audio), device=dev)
        seeded_mel = seeded_synth.synthesize([TEXT0], speaker_ids=[0],
                                             rng_seed=0)[0]["mel"]
        ref_mel = np.load(TACO_MEL0)
        dtw_t = mean_dtw_distance(res["mel"], ref_mel)
        dtw_s = mean_dtw_distance(seeded_mel, ref_mel)
        log(f"  DTW mean frame distance to samples/both_r2/0.mel.npy "
            f"({ref_mel.shape[0]} frames, an earlier step): trained "
            f"{dtw_t:.4f} ({res['mel'].shape[0]} frames), seeded {dtw_s:.4f} "
            f"({seeded_mel.shape[0]} frames) (gate: trained < seeded)")
        if not dtw_t < dtw_s:
            raise AssertionError("the trained mel is no closer to the "
                                 "committed mel than the seeded one")
        mcd_e2e = mcd(wav, wav_e2e, a)
        audio_s = len(wav) / sr
        log(f"  text -> wav with both trained models: {audio_s:.3f} s of "
            f"audio in {t2 - t0:.3f} s (Tacotron {t1 - t0:.3f} s) = "
            f"{audio_s / (t2 - t0):.3f}x realtime [{smi}]; MCD to the "
            f"committed e2e 0.wavenet.wav {mcd_e2e:.3f} dB")
        out["text_to_wav"] = {
            "trim_index": trim, "frames": int(res["mel"].shape[0]),
            "dtw_trained": dtw_t, "dtw_seeded": dtw_s,
            "wall_s": t2 - t0, "tacotron_s": t1 - t0, "audio_s": audio_s,
            "x_realtime": audio_s / (t2 - t0), "mcd_e2e_db": mcd_e2e}
    out["launches"] = launches
    out["max_abs_err"] = out["kernel_vs_twin"]
    return out


def png_size(path: str) -> tuple:
    """(height, width) from a PNG's IHDR; raises unless the file starts
    with the PNG signature and an IHDR chunk."""
    import struct
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def timed_calls(obj, name: str, sink: list) -> None:
    """Replace the bound method ``obj.name`` by one that adds its wall time
    (between device synchronisations) to ``sink``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, wrapper)


def griffin_lim_phases(dev, smi, synth, tmp) -> dict:
    """Griffin-Lim on the card against the CPU, the same initial phase on
    both (one CPU draw): the committed mel through ``inv_mel_spectrogram``
    and trained both_r2's linear output of TEXT0 through
    ``inv_linear_spectrogram``, each padded to the Griffin-Lim bucket as
    the Synthesizer pads it and cut to frames x hop; then GL's time per
    utterance and kernels per iteration."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import (
        load_wav, save_wav)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.griffin_lim import (
        griffin_lim, initial_phase, inv_linear_spectrogram,
        inv_mel_spectrogram)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.synthesizer import (
        GL_BUCKET, round_up)

    a = synth.cfg.audio
    hop, sr, cpu = a.hop_size, a.sample_rate, torch.device("cpu")
    out = {}
    with phase("Griffin-Lim: card vs CPU, the same initial phase, 60 "
               "iterations"):
        served = synth.synthesize([TEXT0], speaker_ids=[0], rng_seed=0)[0]
        n0 = served["mel"].shape[0]
        wav_path = os.path.join(tmp, "gl_served.wav")
        save_wav(served["wav"], wav_path, sr)
        written = load_wav(wav_path, sr)
        if served["wav"].shape != (n0 * hop,) or not (
                np.isfinite(served["wav"]).all()
                and np.abs(written).max() <= 1):
            raise AssertionError("the served GL wav (the card's own phase "
                                 "draw) is not finite or not written in "
                                 "[-1, 1]")
        log(f"  served TEXT0 (card's own draw): {n0} frames -> "
            f"{served['wav'].shape[0]} samples, peak "
            f"{np.abs(served['wav']).max():.4f}, written in [-1, 1]")
        specs = {"inv_mel_spectrogram(committed 0.mel.npy)":
                 (inv_mel_spectrogram, np.load(E2E_MEL).astype(np.float32)),
                 "inv_linear_spectrogram(trained linear of TEXT0)":
                 (inv_linear_spectrogram, served["linear"])}
        checks = {}
        for name, (fn, spec) in specs.items():
            n = spec.shape[0]
            padded = torch.from_numpy(np.pad(
                spec, ((0, round_up(n, GL_BUCKET) - n), (0, 0)),
                constant_values=-a.max_abs_value).T.copy())
            draw = initial_phase((a.num_freq, padded.shape[1]), 0, cpu)
            card = fn(padded.to(dev), a, phase=draw.to(dev))[:n * hop]
            card = card.cpu().numpy()
            ref = fn(padded, a, phase=draw)[:n * hop].numpy()
            err = float(np.abs(card - ref).max())
            peak = float(np.abs(ref).max())
            save_wav(card, wav_path, sr)
            in_range = float(np.abs(load_wav(wav_path, sr)).max())
            log(f"  {name}: {n} frames -> {card.shape[0]} samples; max abs "
                f"err card vs CPU {err:.3e} (bound {GL_TOL:g}), wav peak "
                f"{peak:.4f} (Griffin-Lim's output is not normalised; "
                f"written peak {in_range:.4f})")
            if card.shape != (n * hop,) or not np.isfinite(card).all():
                raise AssertionError(f"{name}: {card.shape} not {n * hop} "
                                     "finite samples")
            if err > GL_TOL or in_range > 1:
                raise AssertionError(f"{name}: the card's Griffin-Lim "
                                     "differs from the CPU's")
            checks[name] = {"frames": n, "max_abs_err": err, "peak": peak}
        out["card_vs_cpu"] = checks

    with phase("Griffin-Lim timing (CUDA events, after a warm-up)"), \
            torch.no_grad():
        n = n0
        lin = torch.nn.functional.pad(
            torch.from_numpy(served["linear"].T.copy()).to(dev),
            (0, round_up(n, GL_BUCKET) - n), value=-a.max_abs_value)
        render = lambda: inv_linear_spectrogram(lin, a)
        render()
        reps = [cuda_ms(render) for _ in range(GL_REPS)]
        ms = float(np.mean(reps))
        mag = torch.rand(lin.shape, device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
        counts = [kernel_count(lambda k=k: griffin_lim(mag, a, n_iters=k))
                  for k in (10, 20)]
        per_iter = (counts[1][0] - counts[0][0]) / 10
        dev_us = (counts[1][2] - counts[0][2]) / 10
        iter_ms = (cuda_ms(lambda: griffin_lim(mag, a, n_iters=20))
                   - cuda_ms(lambda: griffin_lim(mag, a, n_iters=10))) / 10
        audio_s = n * hop / sr
        log(f"  inv_linear_spectrogram of {lin.shape[1]} frames (TEXT0's "
            f"{n}, {audio_s:.3f} s of audio), 60 iterations: {ms:.2f} ms "
            f"per utterance (reps {min(reps):.2f}-{max(reps):.2f}) = "
            f"{audio_s / ms * 1e3:.1f}x realtime; one iteration "
            f"{iter_ms:.3f} ms, {per_iter or 'not measured'} CUDA kernels, "
            f"device {dev_us or 'not measured'} us [{smi}]")
        out["timing"] = {
            "frames": n, "bucket_frames": int(lin.shape[1]),
            "ms_per_utterance": ms, "ms_range": [min(reps), max(reps)],
            "x_realtime": audio_s / ms * 1e3, "ms_per_iteration": iter_ms,
            "kernels_per_iteration": per_iter or None,
            "device_us_per_iteration": dev_us or None}
    return out


def leaf_error(a: dict, b: dict) -> float:
    """max over leaves of max |a - b| / max |b| (a zero leaf of b must be
    zero in a)."""
    err = 0.0
    for k, w in b.items():
        d = float((a[k].detach().double().cpu() - w.detach().double().cpu()
                   ).abs().max())
        scale = float(w.detach().double().abs().max())
        err = max(err, d / scale if scale else (0.0 if d == 0 else
                                                float("inf")))
    return err


def compare_step(card_task, cpu_task, card_state, cpu_state, b_card,
                 b_cpu) -> dict:
    """One f32 training step of the same state and batch on the card and on
    the CPU: the loss's relative error; the graph's gradient under one
    random cotangent into raw_output (largest leaf error against the leaf's
    largest); the loss's gradient, card against CPU and each against the
    CPU's float64 gradient; the step's update (new - old params)."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.device import no_tf32
    graph = {}
    for name, task, st, b in (("card", card_task, card_state, b_card),
                              ("cpu", cpu_task, cpu_state, b_cpu)):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in st.params.items()}
        with no_tf32():
            o = task.model(leaves, b["input_wav"], b["local_condition"])
            cot = torch.from_numpy(np.random.RandomState(5).standard_normal(
                tuple(o["raw_output"].shape)).astype(np.float32))
            g = torch.autograd.grad(o["raw_output"], list(leaves.values()),
                                    grad_outputs=cot.to(task.device),
                                    allow_unused=True)
        graph[name] = {k: torch.zeros_like(v) if x is None else x
                       for (k, v), x in zip(leaves.items(), g)}
    l_card, g_card = card_task.grads(card_state.params, b_card)
    l_cpu, g_cpu = cpu_task.grads(cpu_state.params, b_cpu)
    _, g64 = cpu_task.grads({k: v.double() for k, v in
                             cpu_state.params.items()},
                            {k: v.double() for k, v in b_cpu.items()})
    new_card, _ = card_task.train_step(card_state, b_card)
    new_cpu, _ = cpu_task.train_step(cpu_state, b_cpu)
    keys = cpu_state.params
    return {
        "loss_rel": abs(float(l_card["loss"]) - float(l_cpu["loss"]))
        / abs(float(l_cpu["loss"])),
        "graph_grad_err": leaf_error(graph["card"], graph["cpu"]),
        "loss_grad_err": leaf_error(g_card, g_cpu),
        "loss_grad_from_f64_card": leaf_error(g_card, g64),
        "loss_grad_from_f64_cpu": leaf_error(g_cpu, g64),
        "update_err": leaf_error(
            {k: new_card.params[k] - card_state.params[k] for k in keys},
            {k: new_cpu.params[k] - cpu_state.params[k] for k in keys})}


def training_phases(dev, smi, tmp, data: str) -> dict:
    """WaveNet training at the wn_moon width (raw input, MoL of 10, 50
    layers, R = D = 32, S = 512) on batches of the corpus ``data``: seeded
    Adam steps in f32 and bf16, one step on the card against the CPU,
    resuming the trained wn_moon from its checkpoint (opt_state included),
    saving the run with the port's CheckpointManager and serving the saved
    EMA through the generation kernel, and the step's time, memory and
    kernels."""
    from tacotron_wavenet_vocoder_korean_tpu_torch import config as C
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        from_jax_tree, to_jax_tree)
    from tacotron_wavenet_vocoder_korean_tpu_torch.data import WaveNetBatcher
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
        wavenet_generate)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
        WaveNetGenerator)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        CheckpointManager, prepare_run_dir, restore_into_state)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
        WaveNetTask, batch_to_device)

    cfg = C.load_config(WN_MOON)
    w = cfg.wavenet
    hop = cfg.audio.hop_size
    cfg16 = C.overlay(cfg, wavenet={"compute_dtype": "bfloat16"})
    out = {"card": smi, "B": TRAIN_B, "T": TRAIN_T,
           "outputs_per_stream": TRAIN_T - w.receptive_field}

    with phase("training batches: WaveNetBatcher over the corpus"):
        batch = next(iter(WaveNetBatcher([data], cfg, seed=11,
                                         device_store=True, device=dev)))
        cmp_cfg = C.overlay(cfg, wavenet={"sample_size": TRAIN_CMP_T})
        cmp_np = next(iter(WaveNetBatcher([data], cmp_cfg, batch_size=1,
                                          seed=12)))
        log(f"  batch {tuple(batch['input_wav'].shape)} audio, "
            f"{tuple(batch['local_condition'].shape)} mel (device store); "
            f"comparison batch {cmp_np.input_wav.shape}")

    with phase(f"seeded training: {TRAIN_STEPS} Adam steps on one batch, "
               f"f32 and bf16, B={TRAIN_B} T={TRAIN_T}"):
        seeded_loss = {}
        for name, c in (("float32", cfg), ("bfloat16", cfg16)):
            task = WaveNetTask(c, device=dev)
            state = task.init_state(0)
            losses = []
            for _ in range(TRAIN_STEPS):
                state, m = task.train_step(state, batch)
                losses.append(m["loss"])
            losses = [float(x) for x in losses]
            log(f"  {name}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
                f"({', '.join(f'{x:.3f}' for x in losses)}); lr "
                f"{float(m['learning_rate']):.6g}, grad_norm "
                f"{float(m['grad_norm']):.4g}")
            if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
                raise AssertionError(f"seeded {name} training did not "
                                     "lower the loss")
            seeded_loss[name] = losses
        out["seeded_losses"] = seeded_loss
        del state, task

    with phase("resume wn_moon at step 260,250 (params, ema_params, "
               "opt_state, step)"):
        cpu = torch.device("cpu")
        task = WaveNetTask(cfg, device=dev)
        cpu_task = WaveNetTask(cfg, device=cpu)
        t0 = time.perf_counter()
        trained_cpu, start = restore_into_state(cpu_task.init_state(0),
                                                WN_MOON, None)
        restore_s = time.perf_counter() - t0
        seeded = task.init_state(0)
        state = from_jax_tree(seeded, to_jax_tree(trained_cpu))
        lr = float(task.lr_schedule(state.step))
        want_lr = w.learning_rate * w.decay_rate ** (start / w.decay_steps)
        log(f"  restored step {start} in {restore_s:.2f}s (tarball, all "
            f"four items); learning rate {lr:.7g} (expected {want_lr:.7g})")
        if start != 260250 or abs(lr - want_lr) > 1e-7:
            raise AssertionError("resumed step or learning rate wrong")
        trained_eval = float(task.eval_step(state, batch)["loss"])
        seeded_eval = float(task.eval_step(seeded, batch)["loss"])
        log(f"  eval loss on the batch (EMA): trained {trained_eval:.4f}"
            f", seeded {seeded_eval:.4f}")
        if not trained_eval < seeded_eval:
            raise AssertionError("trained loss is not below the seeded one")
        out.update(resume_restore_s=restore_s, learning_rate=lr,
                   trained_eval_loss=trained_eval,
                   seeded_eval_loss=seeded_eval)

    with phase(f"one step, card vs CPU: B=1 T={TRAIN_CMP_T}, trained "
               "wn_moon (gated) and seeded weights"):
        b_cpu, b_card = (
            {k: v for k, v in batch_to_device(cmp_np, d).items()
             if k != "speaker_id"} for d in (cpu, dev))
        cmp = {"trained": compare_step(task, cpu_task, state, trained_cpu,
                                       b_card, b_cpu)}
        log("  trained wn_moon: " + ", ".join(
            f"{k} {v:.3e}" for k, v in cmp["trained"].items()))
        c = cmp["trained"]
        if not (c["loss_rel"] <= TRAIN_LOSS_TOL
                and c["graph_grad_err"] <= TRAIN_GRAD_TOL
                and c["loss_grad_from_f64_card"]
                <= TRAIN_F64_RATIO * c["loss_grad_from_f64_cpu"]
                and c["update_err"] <= TRAIN_UPDATE_TOL):
            raise AssertionError("the card's training step disagrees with "
                                 "the CPU's")
        cmp["seeded"] = compare_step(task, cpu_task, seeded,
                                     cpu_task.init_state(0), b_card, b_cpu)
        log("  seeded (printed; only the loss is bounded, see "
            "TRAIN_CMP_T): " + ", ".join(f"{k} {v:.3e}" for k, v in
                                          cmp["seeded"].items()))
        if not cmp["seeded"]["loss_rel"] <= TRAIN_LOSS_TOL:
            raise AssertionError("the card's seeded loss disagrees with "
                                 "the CPU's")

        card16, cpu16 = (WaveNetTask(cfg16, device=d) for d in (dev, cpu))
        l16_card, g16_card = card16.grads(state.params, b_card)
        l16_cpu, g16_cpu = cpu16.grads(trained_cpu.params, b_cpu)
        l32_cpu, g32_cpu = cpu_task.grads(trained_cpu.params, b_cpu)
        d_loss = abs(float(l16_card["loss"]) - float(l16_cpu["loss"]))
        n_loss = abs(float(l16_cpu["loss"]) - float(l32_cpu["loss"]))
        d_grad = leaf_error(g16_card, g16_cpu)
        n_grad = leaf_error(g32_cpu, g16_cpu)
        log(f"  bf16, trained: |loss card - cpu| {d_loss:.3e} (bound "
            f"{TRAIN_BF16_RATIO:g} x cpu |bf16 - f32| {n_loss:.3e}); "
            f"gradient {d_grad:.3e} (bound {TRAIN_BF16_RATIO:g} x "
            f"{n_grad:.3e})")
        if not (d_loss <= TRAIN_BF16_RATIO * n_loss
                and d_grad <= TRAIN_BF16_RATIO * n_grad):
            raise AssertionError("the card's bf16 step is outside bf16's "
                                 "noise")
        cmp["bf16_trained"] = {"loss": d_loss, "loss_bound": n_loss,
                               "grad": d_grad, "grad_bound": n_grad}
        out["card_vs_cpu"] = cmp
        del trained_cpu, cpu_task, card16, cpu16

    with phase(f"{TRAIN_RESUME_STEPS} resumed steps, saved by "
               "CheckpointManager (max_to_keep 2)"):
        counts = [int(state.opt_state[0]["count"]),
                  int(state.opt_state[1]["count"])]
        run = os.path.join(tmp, "wn_run")
        prepare_run_dir(run, cfg)
        mgr = CheckpointManager(run, max_to_keep=2)
        resumed = []
        for i in range(TRAIN_RESUME_STEPS):
            state, m = task.train_step(state, batch)
            resumed.append(float(m["loss"]))
            if i >= TRAIN_RESUME_STEPS - 3:     # three saves, two kept
                mgr.save(int(state.step), state)
        new_counts = [int(state.opt_state[0]["count"]),
                      int(state.opt_state[1]["count"])]
        log(f"  losses {resumed}; step {int(state.step)}, counts {counts} "
            f"-> {new_counts}")
        if (int(state.step) != 260250 + TRAIN_RESUME_STEPS
                or new_counts != [c + TRAIN_RESUME_STEPS for c in counts]
                or not np.isfinite(resumed).all()):
            raise AssertionError("resumed steps did not advance as expected")
        out["resumed_losses"] = resumed

    with phase("save with CheckpointManager (max_to_keep 2), read back, "
               "serve the EMA through the kernel"):
        steps = mgr.all_steps()
        want_steps = [260250 + TRAIN_RESUME_STEPS - 1,
                      260250 + TRAIN_RESUME_STEPS]
        back = mgr.restore(state)
        same = all(torch.equal(a, b) for part in ("params", "ema_params")
                   for a, b in zip(getattr(back, part).values(),
                                   getattr(state, part).values()))
        same = same and all(torch.equal(back.opt_state[0][m][k],
                                        state.opt_state[0][m][k])
                            for m in ("mu", "nu") for k in state.params)
        log(f"  kept steps {steps} (expected {want_steps}); the latest reads "
            f"back bit-equal: {same}")
        if steps != want_steps or not same or int(back.step) != int(
                state.step):
            raise AssertionError("saved run dir wrong")
        mel = np.load(E2E_MEL).astype(np.float32)[:TRAIN_SERVE_FRAMES]
        wavenet_generate.launches = 0
        wavenet_generate.variant_launches.clear()
        gen = WaveNetGenerator.from_checkpoint(run, device="cuda")
        t0 = time.perf_counter()
        wav = gen.generate(mel, seed=0)
        serve_s = time.perf_counter() - t0
        launches = dict(wavenet_generate.variant_launches)
        log(f"  served step {gen.step} (EMA, {gen.weight_dtype}): "
            f"{wav.shape[0]} samples in {serve_s:.2f}s, peak "
            f"{np.abs(wav).max():.3f}; kernel launches {launches}")
        if (gen.step != int(state.step) or launches != {"mol-bfloat16": 1}
                or wav.shape != (TRAIN_SERVE_FRAMES * hop,)
                or not np.isfinite(wav).all() or np.abs(wav).max() > 1):
            raise AssertionError("serving the saved run failed")
        out["serve"] = {"step": gen.step, "samples": int(wav.shape[0]),
                        "launches": launches}
        del gen, back, state

    with phase(f"training step time at B={TRAIN_B} T={TRAIN_T}"):
        timing = {}
        for name, c in (("float32", cfg), ("bfloat16", cfg16)):
            task = WaveNetTask(c, device=dev)
            state = task.init_state(2)
            state, _ = task.train_step(state, batch)        # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(TRAIN_REPS):
                holder = [state]

                def step():
                    holder[0] = task.train_step(holder[0], batch)[0]
                times.append(cuda_ms(step))
                state = holder[0]
            peak = torch.cuda.max_memory_allocated()
            kernels, launch_calls, device_us = kernel_count(
                lambda: task.train_step(state, batch))
            times.sort()
            timing[name] = {"ms_min": times[0],
                            "ms_median": times[len(times) // 2],
                            "ms_max": times[-1],
                            "peak_mem_gb": peak / 1e9,
                            "kernels_per_step": kernels,
                            "launch_calls_per_step": launch_calls,
                            "device_ms_per_step": device_us / 1e3,
                            "samples_per_s": TRAIN_B * TRAIN_T / (
                                times[len(times) // 2] / 1e3)}
            log(f"  {name}: {times[0]:.1f} / {times[len(times) // 2]:.1f} / "
                f"{times[-1]:.1f} ms per step (min / median / max of "
                f"{TRAIN_REPS}); peak {peak / 1e9:.2f} GB; {kernels} CUDA "
                f"kernels ({launch_calls} launch calls), device busy "
                f"{device_us / 1e3:.1f} ms per step [{smi}]")
            del state, task
        out["step_time"] = timing
    return out


def features_f64(wav: np.ndarray, a) -> tuple:
    """extract_features in float64 numpy (mel, linear): the reference the
    card's and the CPU's float32 spectrograms are measured from."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.stft import (
        hann_window, mel_basis)
    y = wav.astype(np.float64)
    y = np.concatenate([y[:1], y[1:] - a.preemphasis * y[:-1]])
    y = np.pad(y, a.fft_size // 2, mode="reflect")
    n = 1 + (len(y) - a.fft_size) // a.hop_size
    idx = np.arange(a.fft_size)[None] + a.hop_size * np.arange(n)[:, None]
    win = hann_window(a.win_size, a.fft_size).astype(np.float64)
    mag = np.abs(np.fft.rfft(y[idx] * win, axis=-1)).T
    m = a.max_abs_value

    def chain(x):
        db = 20 * np.log10(np.maximum(10 ** (a.min_level_db / 20), x))
        db = db - a.ref_level_db
        return np.clip(2 * m * (db - a.min_level_db) / -a.min_level_db - m,
                       -m, m)
    basis = mel_basis(a.sample_rate, a.fft_size, a.num_mels)
    return chain(basis.astype(np.float64) @ mag), chain(mag)


def run_cli(module: str, args: list, dev, timeout: float = CLI_TIMEOUT_S
            ) -> tuple:
    """``python -m PKG.<module> args`` from the repository; ``(rc, output,
    seconds)``.  On the CPU (a rehearsal) the CLI is given ``--device
    cpu``."""
    extra = [] if dev.type == "cuda" else ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.{module}", *args,
                           *extra], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    return (proc.returncode, proc.stdout + proc.stderr,
            time.perf_counter() - t0)


def require_rc0(name: str, rc: int, out: str) -> None:
    if rc != 0:
        raise AssertionError(f"{name} exited {rc}:\n{out[-6000:]}")


def step_lines(log_text: str) -> list:
    """``(step, sec_per_step, loss)`` of each ``Step`` line of a
    train.log."""
    rows = []
    for line in log_text.splitlines():
        if "]  Step " in line and "sec/step" in line:
            body = line.split("]  Step ", 1)[1]
            step = int(body.split("[")[0])
            sec = float(body.split("[")[1].split(" sec/step")[0])
            loss = float(body.split("loss=")[1].split(",")[0])
            rows.append((step, sec, loss))
    return rows


def read_metrics(run: str) -> list:
    with open(os.path.join(run, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def preprocess_phase(dev, smi, tmp) -> tuple:
    """Preprocess the committed clips with the port's CLI into
    ``tmp/data``, check the npz invariants and hold the card's npz files
    against the CPU's.  Returns ``(the corpus dir, the numbers for the
    data line)``."""
    from tacotron_wavenet_vocoder_korean_tpu_torch import config as C
    from tacotron_wavenet_vocoder_korean_tpu_torch.data import (
        preprocess_corpus)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import (
        load_wav, rescale, trim_silence)

    cpu = torch.device("cpu")
    a = C.Config().audio
    hop = a.hop_size
    corpus_in = os.path.join(tmp, "moon")
    data = os.path.join(tmp, "data")
    with phase("data (a): the preprocess CLI on the card, 18 clips, 4 "
               "workers; card vs CPU"):
        os.makedirs(os.path.join(corpus_in, "audio"))
        table = {}
        for f in sorted(os.listdir(TRAIN_WAVS)):
            shutil.copy(os.path.join(TRAIN_WAVS, f),
                        os.path.join(corpus_in, "audio", f))
            table[f"audio/{f}"] = TEXT0
        with open(os.path.join(corpus_in, "moon-recognition-All.json"), "w",
                  encoding="utf-8") as f:
            json.dump(table, f, ensure_ascii=False)
        rc, text, secs = run_cli("preprocess", [
            "--name", "moon", "--in_dir", corpus_in, "--out_dir", data,
            "--num_workers", "4"], dev)
        require_rc0("preprocess", rc, text)
        names = sorted(f for f in os.listdir(data) if f.endswith(".npz"))
        keys = {"audio", "mel", "linear", "time_steps", "mel_frames", "text",
                "tokens", "loss_coeff"}
        for name in names:
            with np.load(os.path.join(data, name)) as d:
                if (set(d.files) != keys
                        or len(d["audio"]) != int(d["mel_frames"]) * hop
                        or d["mel"].shape != (int(d["mel_frames"]),
                                              a.num_mels)
                        or d["linear"].shape[1] != a.num_freq
                        or d["tokens"][-1] != 1):
                    raise AssertionError(f"{name}: npz invariants broken")
        rows = rows_of(data)
        if len(names) != 18 or len(rows) != 18:
            raise AssertionError(f"{len(names)} npz, {len(rows)} rows")
        log(f"  preprocess CLI: rc 0 in {secs:.2f} s wall (process start "
            f"included); 18 npz with the 8 keys, len(audio) = frames x "
            f"{hop}, EOS; train.txt 18 rows [{smi}]")

        cpu_dir = os.path.join(tmp, "data_cpu")
        preprocess_corpus(C.Config(), "moon", corpus_in, cpu_dir,
                          num_workers=4, device=cpu)
        if rows_of(cpu_dir) != rows:
            raise AssertionError("train.txt rows differ card vs CPU")
        worst = {"mel": 0.0, "lin": 0.0, "lin_cpu_f64": 0.0,
                 "lin_card_f64": 0.0}
        for clip_name in DATA_CMP_CLIPS:
            name = clip_name[:-len(".wav")] + ".npz"
            wav = trim_silence(rescale(load_wav(
                os.path.join(TRAIN_WAVS, clip_name), a.sample_rate), a), a)
            _, lin64 = features_f64(wav, a)
            with np.load(os.path.join(data, name)) as g, \
                    np.load(os.path.join(cpu_dir, name)) as c:
                if not (np.array_equal(g["audio"], c["audio"])
                        and np.array_equal(g["tokens"], c["tokens"])):
                    raise AssertionError(f"{name}: audio or tokens differ")
                errs = {"mel": float(np.abs(g["mel"] - c["mel"]).max()),
                        "lin": float(np.abs(g["linear"] - c["linear"]).max()),
                        "lin_cpu_f64": float(np.abs(c["linear"].T - lin64)
                                             .max()),
                        "lin_card_f64": float(np.abs(g["linear"].T - lin64)
                                              .max())}
            log(f"  {name}: mel |card - cpu| {errs['mel']:.3e}; linear "
                f"{errs['lin']:.3e}, from float64: card "
                f"{errs['lin_card_f64']:.3e}, CPU {errs['lin_cpu_f64']:.3e}")
            worst = {k: max(v, errs[k]) for k, v in worst.items()}
        if not (worst["mel"] <= DATA_MEL_TOL and worst["lin_card_f64"]
                <= DATA_LIN_F64_RATIO * worst["lin_cpu_f64"]):
            raise AssertionError(f"card vs CPU spectrograms: {worst}")
    return data, {"wall_s": secs, "clips": len(names), "card_vs_cpu": worst}


def data_phases(dev, smi, tmp, data: str, library_ms: float,
                seeded_eval: float) -> dict:
    """The data pipeline and the training CLI on the card, on the corpus
    ``data``: the batcher's device store against its host path and the
    prefetcher against the batcher; resume wn_moon through train_vocoder
    (its mean logged loss below ``seeded_eval``, the seeded weights' eval
    loss) and resume its run again; a seeded two-speaker run; serve the
    run through the generate CLI (one kernel launch, counted); the
    feeder's wait share in-process.  Returns the ``data`` line, with the
    serving launches under ``launches``."""
    from tacotron_wavenet_vocoder_korean_tpu_torch import config as C
    from tacotron_wavenet_vocoder_korean_tpu_torch.data import (
        DevicePrefetcher, WaveNetBatcher)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import (
        load_wav)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        CheckpointManager)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
        WaveNetTask, batch_to_device)

    cpu = torch.device("cpu")
    cfg = C.load_config(WN_MOON)
    if DATA_OVERRIDES:
        cfg = C.overlay(cfg, wavenet=DATA_OVERRIDES)
    size_args = [a for k, v in DATA_OVERRIDES.items()
                 for a in (f"--{k}", str(v))]
    a, hop = cfg.audio, cfg.audio.hop_size
    out = {"card": smi}

    with phase(f"data (b): WaveNetBatcher device store vs host path, "
               f"{DATA_BATCHES} batches; DevicePrefetcher"):
        seed = 7
        host = WaveNetBatcher([data], cfg, seed=seed)
        store = WaveNetBatcher([data], cfg, seed=seed, device_store=True,
                               device=dev)
        hit, sit = iter(host), iter(store)
        mel_err = 0.0
        for _ in range(DATA_BATCHES):
            hb, sb = next(hit), next(sit)
            if any(sb[k].device.type != dev.type for k in sb) or not all(
                    np.array_equal(x, y) for x, y in zip(
                        host.rng.get_state(), store.rng.get_state())):
                raise AssertionError("the store's draws differ")
            if not (np.array_equal(sb["input_wav"].cpu().numpy(),
                                   hb.input_wav)
                    and np.array_equal(sb["speaker_id"].cpu().numpy(),
                                       hb.speaker_id)):
                raise AssertionError("the store's crops differ")
            lc = sb["local_condition"].cpu().numpy()
            np.testing.assert_allclose(lc, hb.local_condition,
                                       atol=DATA_F16_ATOL, rtol=DATA_F16_RTOL)
            mel_err = max(mel_err, float(np.abs(lc - hb.local_condition)
                                         .max()))
        log(f"  {DATA_BATCHES} batches of {tuple(hb.input_wav.shape)}: the "
            f"same draws (rng states equal), audio and speaker ids exact, "
            f"mel within f16 (max {mel_err:.2e}); store_bytes "
            f"{store.store_bytes:,}")
        out["store_bytes"] = store.store_bytes

        def refuse(batch):
            raise AssertionError("a device-store batch went through put_fn")
        feeder = DevicePrefetcher(store, put_fn=refuse, device=dev)
        try:
            for _ in range(2):
                got = next(feeder)
        finally:
            feeder.stop()
        if any(got[k].device.type != dev.type for k in got):
            raise AssertionError("a device-store batch left the device")
        del store, sit

        want = iter(WaveNetBatcher([data], cfg, seed=seed))
        feeder = DevicePrefetcher(WaveNetBatcher([data], cfg, seed=seed),
                                  device=dev)
        try:
            for _ in range(DATA_BATCHES):
                got, ref = next(feeder), batch_to_device(next(want), cpu)
                if any(got[k].device.type != dev.type or not torch.equal(
                        got[k].cpu(), ref[k]) for k in ref):
                    raise AssertionError("the prefetcher's batch differs")
            pinned = feeder.pinned_batches
        finally:
            feeder.stop()
        if dev.type == "cuda" and pinned < DATA_BATCHES:
            raise AssertionError(f"{pinned} batches from pinned memory")
        log(f"  prefetcher: {DATA_BATCHES} batches equal to the batcher's, "
            f"in order, on {dev}; {pinned} copied from pinned memory; "
            "device-store batches pass through")
        out["prefetcher_pinned_batches"] = pinned

    run = os.path.join(tmp, "run")
    with phase(f"data (c): resume wn_moon through the train_vocoder CLI, "
               f"{DATA_START} -> {DATA_RESUME_TO}"):
        rc, text, secs = run_cli("train_vocoder", [
            "--data_dir", data, "--log_dir", run, "--load_path", WN_MOON,
            "--num_steps", str(DATA_RESUME_TO), "--hparams", DATA_HPARAMS,
            *size_args], dev)
        require_rc0("train_vocoder (resume wn_moon)", rc, text)
        with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
            log_text = f.read()
        lines = step_lines(log_text)
        summaries = read_metrics(run)
        losses = [r["loss"] for r in summaries if "loss" in r]
        tests = [r["test_loss"] for r in summaries if "test_loss" in r]
        lr = [r["learning_rate"] for r in summaries if "learning_rate" in r]
        last = [r["step"] for r in summaries if "learning_rate" in r][-1]
        w = cfg.wavenet
        want_lr = w.learning_rate * w.decay_rate ** ((last - 1)
                                                     / w.decay_steps)
        mean_loss = float(np.mean([x[2] for x in lines]))
        log(f"  rc 0 in {secs:.1f} s wall; Step lines {lines}; metrics "
            f"loss {losses}, test_loss {tests}; learning rate at step "
            f"{last} {lr[-1]:.9g} (schedule {want_lr:.9g}); mean logged "
            f"loss {mean_loss:.4f} (gate < seeded {seeded_eval:.4f}) [{smi}]")
        if not (f"Resuming from step {DATA_START}" in log_text
                and os.path.isdir(os.path.join(run, "ckpt",
                                               str(DATA_RESUME_TO)))
                and losses and tests
                and np.isfinite(losses + tests).all()
                and abs(lr[-1] - want_lr) <= 1e-7
                and mean_loss < seeded_eval):
            raise AssertionError(f"the resumed CLI run is wrong:\n"
                                 f"{text[-4000:]}")
        # The CLI's own ValueWindow at its last boundary, and the last
        # interval alone (the first includes the warm-up step).
        n = len(lines)
        last_interval = lines[-1][1] * n - lines[-2][1] * (n - 1)
        out["cli"] = {"wall_s": secs, "steps": DATA_RESUME_TO - DATA_START,
                      "sec_per_step_window": lines[-1][1],
                      "sec_per_step_last_interval": last_interval,
                      "losses": losses, "test_losses": tests,
                      "mean_logged_loss": mean_loss,
                      "learning_rate": lr[-1]}

        # (e) serves the run as this call left it, copied, while the
        # second call writes on in the original.
        run_first = os.path.join(tmp, f"run_{DATA_RESUME_TO}")
        shutil.copytree(run, run_first)

    wav_path = os.path.join(tmp, "served.wav")
    script = (
        "import json, sys\n"
        f"from {PKG} import generate\n"
        f"from {PKG}.ops.wavenet_gen import wavenet_generate\n"
        "generate.main(sys.argv[1:])\n"
        "print(json.dumps(dict(wavenet_generate.variant_launches)))\n")
    dirs = []
    for speaker, mine in (("moon", lambda f: not f.startswith("NB")),
                          ("son", lambda f: f.startswith("NB"))):
        d = os.path.join(tmp, f"data_{speaker}")
        os.makedirs(d)
        sel = [r for r in rows_of(data) if mine(r.split("|")[0])]
        for r in sel:
            shutil.copy(os.path.join(data, r.split("|")[0]), d)
        with open(os.path.join(d, "train.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(sel) + "\n")
        dirs.append(d)
    gc_run = os.path.join(tmp, "gc_run")
    with phase(f"data (c), (d) and (e), side by side: the run of (c) "
               f"resumed to {DATA_RESUME_MORE}; a seeded two-speaker run, "
               f"{DATA_GC_STEPS} steps; the generate CLI serves the run of "
               f"(c), one kernel launch"):
        done = run_side_by_side({
            "train_vocoder (resume the run)": [
                "-m", f"{PKG}.train_vocoder", "--data_dir", data,
                "--log_dir", run, "--load_path", run, "--num_steps",
                str(DATA_RESUME_MORE), "--hparams", DATA_HPARAMS,
                *size_args],
            "train_vocoder (two speakers)": [
                "-m", f"{PKG}.train_vocoder", "--data_dir", ",".join(dirs),
                "--log_dir", gc_run, "--num_steps", str(DATA_GC_STEPS),
                "--hparams", "train.sync_every=5,train.summary_interval=5,"
                "train.test_interval=5", *size_args],
            "generate": ["-c", script, "--load_path", run_first, "--mel",
                         DATA_SERVE_MEL, "--out", wav_path]}, dev, tmp)

        text, secs2 = done["train_vocoder (resume the run)"]
        with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
            log_text = f.read()
        kept = CheckpointManager(run).all_steps()
        log(f"  (c) second call: rc 0 in {secs2:.1f} s wall; kept steps "
            f"{kept} (max_checkpoints {cfg.train.max_checkpoints})")
        if not (f"Resuming from step {DATA_RESUME_TO}" in log_text
                and kept[-1] == DATA_RESUME_MORE
                and len(kept) <= cfg.train.max_checkpoints):
            raise AssertionError(f"the second resume is wrong:\n"
                                 f"{text[-4000:]}")
        out["cli"]["second_call_wall_s"] = secs2

        text, secs = done["train_vocoder (two speakers)"]
        with open(os.path.join(gc_run, "train.log"), encoding="utf-8") as f:
            gc_log = f.read()
        gc_rows = read_metrics(gc_run)
        gc_losses = [r.get("loss", r.get("test_loss")) for r in gc_rows]
        num_speakers = C.load_config(gc_run).wavenet.num_speakers
        log(f"  (d) rc 0 in {secs:.1f} s wall; num_speakers {num_speakers}; "
            f"metrics {gc_rows}")
        if not ("gc=on" in gc_log and num_speakers == 2 and len(gc_rows) == 4
                and np.isfinite(gc_losses).all()):
            raise AssertionError(f"the two-speaker run is wrong:\n"
                                 f"{text[-4000:]}")
        out["two_speakers"] = {"wall_s": secs, "metrics": gc_rows}

        text, secs = done["generate"]
        launches = json.loads(text.strip().splitlines()[-1])
        frames = np.load(DATA_SERVE_MEL).shape[0]
        wav = load_wav(wav_path, a.sample_rate)
        log(f"  (e) rc 0 in {secs:.1f} s wall; launches {launches}; wav "
            f"{wav.shape[0]} samples ({frames} frames), peak "
            f"{np.abs(wav).max():.3f}")
        if (wav.shape != (frames * hop,) or not np.isfinite(wav).all()
                or np.abs(wav).max() > 1):
            raise AssertionError("the served wav is wrong")
        if dev.type == "cuda" and launches != {"mol-bfloat16": 1}:
            raise AssertionError(f"generate launched {launches}")
        out["serve"] = {"wall_s": secs, "samples": int(wav.shape[0])}
        out["launches"] = launches

    with phase(f"data (f): the feeder's wait share, {DATA_FEED_STEPS} "
               "steps, device store on and off"):
        task = WaveNetTask(cfg, device=dev)
        state = task.init_state(0)
        feed = {}
        for on in (True, False):
            batcher = WaveNetBatcher([data], cfg, device_store=on,
                                     device=dev)
            feeder = DevicePrefetcher(batcher, device=dev)
            try:
                for _ in range(2):                          # warm-up
                    state, m = task.train_step(state, next(feeder))
                float(m["loss"])
                wait = 0.0
                t_all = time.perf_counter()
                for i in range(DATA_FEED_STEPS):
                    t0 = time.perf_counter()
                    batch = next(feeder)
                    wait += time.perf_counter() - t0
                    state, m = task.train_step(state, batch)
                    if (i + 1) % 10 == 0:                    # sync_every
                        float(m["loss"])
                wall = time.perf_counter() - t_all
            finally:
                feeder.stop()
            name = "store" if on else "host"
            feed[name] = {"wait_share": wait / wall, "wait_s": wait,
                          "sec_per_step": wall / DATA_FEED_STEPS}
            log(f"  {name}: waited {wait * 1e3:.2f} ms of {wall:.3f} s "
                f"({wait / wall:.2%}); {wall / DATA_FEED_STEPS * 1e3:.1f} ms "
                f"per step [{smi}]")
        out["feeder"] = feed
        out["library_step_ms"] = library_ms
        log(f"  the CLI's sec/step {out['cli']['sec_per_step_window']:.4f} "
            f"(last interval {out['cli']['sec_per_step_last_interval']:.4f})"
            f" beside the library step {library_ms:.1f} ms [{smi}]")
        del task, state
    return out


def rows_of(data: str) -> list:
    with open(os.path.join(data, "train.txt"), encoding="utf-8") as f:
        return f.read().splitlines()


def map_tensors(node, fn):
    """``fn`` on every tensor of a tree of dicts, tuples and named
    tuples."""
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(map_tensors(v, fn) for v in node))
    if isinstance(node, tuple):
        return tuple(map_tensors(v, fn) for v in node)
    if isinstance(node, dict):
        return {k: map_tensors(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [map_tensors(v, fn) for v in node]
    return node


def noam(step: int, cfg) -> float:
    """The Noam learning rate the step that makes ``step`` reads (at
    state.step = step - 1), in float64."""
    s = float(step)
    return (cfg.initial_learning_rate * TACO_WARMUP ** 0.5
            * min(s * TACO_WARMUP ** -1.5, s ** -0.5))


def run_side_by_side(cmds: dict, dev, tmp: str) -> dict:
    """``python <args>`` for each name's args, all started at once from
    the repository, their output into files under ``tmp``; returns
    ``{name: (output, seconds to its own exit)}`` and raises unless each
    exited 0.  On the CPU (a rehearsal) each is given ``--device cpu``."""
    extra = [] if dev.type == "cuda" else ["--device", "cpu"]
    procs = {}
    for name, args in cmds.items():
        path = os.path.join(tmp, f"{name}.out")
        with open(path, "w", encoding="utf-8") as f:
            procs[name] = (subprocess.Popen(
                [sys.executable, *args, *extra], cwd=REPO, stdout=f,
                stderr=subprocess.STDOUT), path, time.perf_counter())
    done = {}
    deadline = time.perf_counter() + CLI_TIMEOUT_S
    try:
        while len(done) < len(procs):
            for name, (proc, path, t0) in procs.items():
                if name not in done and proc.poll() is not None:
                    with open(path, encoding="utf-8") as f:
                        done[name] = (f.read(), time.perf_counter() - t0)
                    require_rc0(name, proc.returncode, done[name][0])
            if time.perf_counter() > deadline:
                raise TimeoutError(f"still running: "
                                   f"{sorted(set(procs) - set(done))}")
            time.sleep(0.1)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return done


def taco_speaker_dirs(tmp: str, data: str) -> list:
    """The corpus ``data`` split into two speaker dirs under ``tmp``:
    the moon clips (speaker 0) and the son clips (``NB*``, speaker 1)."""
    dirs = []
    for i, mine in enumerate((lambda f: not f.startswith("NB"),
                              lambda f: f.startswith("NB"))):
        d = os.path.join(tmp, f"taco_speaker{i}")
        os.makedirs(d)
        sel = [r for r in rows_of(data) if mine(r.split("|")[0])]
        for r in sel:
            shutil.copy(os.path.join(data, r.split("|")[0]), d)
        with open(os.path.join(d, "train.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(sel) + "\n")
        dirs.append(d)
    return dirs


def eval_phases(dev, smi, tmp, dirs: list) -> dict:
    """The evaluation commands, called in process as a user would call
    them, on the trained tarballs and the two speaker dirs: (a)
    ``vocoder_eval`` (one kernel launch per clip, counted), (b)
    ``quality_eval --heldout --wavenet`` (one launch per utterance,
    counted), (c) ``wavenet_diagnose`` on the card and on the CPU (no
    launch).  Each result's keys are the command's constant (the JAX
    script's keys), its MCDs finite, its utterances those the command's
    own path selection picks on the host, its wavs finite in [-1, 1].
    Returns the ``eval`` line, with the launches under ``launches``."""
    import glob
    from tacotron_wavenet_vocoder_korean_tpu_torch import config as C
    from tacotron_wavenet_vocoder_korean_tpu_torch.data import (
        TacotronBatcher)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import (
        load_wav)
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
        wavenet_generate)
    from tacotron_wavenet_vocoder_korean_tpu_torch.scripts import (
        quality_eval as QE, vocoder_eval as VE, wavenet_diagnose as WD)

    extra = [] if dev.type == "cuda" else ["--device", "cpu"]
    out = {"card": smi}
    launches = {}

    def run(name: str, mod, args: list) -> dict:
        wavenet_generate.launches = 0
        wavenet_generate.variant_launches.clear()
        t0 = time.perf_counter()
        result = mod.main(args)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches[name] = dict(wavenet_generate.variant_launches)
        result["wall_s"] = time.perf_counter() - t0
        log(f"  {name}: {result['wall_s']:.1f} s wall, launches "
            f"{launches[name]} [{smi}]")
        return result

    def require(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(what)

    def finite(x) -> bool:
        return x is not None and bool(np.isfinite(x))

    def counted(name: str, n: int) -> None:
        want = {"mol-bfloat16": n} if dev.type == "cuda" else {}
        require(launches[name] == want,
                f"{name} launched {launches[name]}, want {want}")

    wav_dir = os.path.join(tmp, "eval_wavs")
    with phase(f"eval (a): vocoder_eval on wn_moon, {EVAL_N} + "
               f"{EVAL_N_UNSEEN} unseen clips at {EVAL_FRAMES} frames, one "
               "kernel launch each"):
        a = run("vocoder_eval", VE, [
            "--wavenet", WN_MOON, "--data", dirs[0], "--unseen_data",
            dirs[1], "--n", str(EVAL_N), "--n_unseen", str(EVAL_N_UNSEEN),
            "--max_frames", str(EVAL_FRAMES), "--no_persist", "--out_dir",
            wav_dir, *extra])
        n_test = max(1, C.load_config(WN_MOON).train.num_test_per_speaker)
        paths, held = VE.select_eval_paths(
            sorted(glob.glob(os.path.join(dirs[0], "*.npz"))), EVAL_N,
            n_test)
        unseen = VE.unseen_paths(dirs[1], EVAL_N_UNSEEN)
        utts = [os.path.splitext(os.path.basename(p))[0]
                for p in paths + unseen]
        require(set(a) - {"wall_s"} == VE.RESULT_KEYS,
                f"vocoder_eval keys {sorted(a)}")
        require(a["n_utterances"] == len(utts)
                and a["n_heldout"] == len(held) + len(unseen)
                and [u["utt"] for u in a["per_utt"]] == utts,
                "vocoder_eval picked other clips than its path selection")
        require(all(finite(a[k]) for k in (
            "wavenet_mcd_db", "gl_oracle_mcd_db", "heldout_wavenet_mcd_db",
            "heldout_same_speaker_mcd_db", "unseen_speaker_mcd_db",
            "unseen_speaker_gl_oracle_mcd_db")) and all(
            finite(u["wavenet_mcd_db"]) and finite(u["gl_mcd_db"])
            for u in a["per_utt"]), "vocoder_eval: an MCD is not finite")
        require(sorted(os.listdir(wav_dir)) == sorted(
            f"{u}.wn.wav" for u in utts), "vocoder_eval's --out_dir")
        for u in utts:
            w = load_wav(os.path.join(wav_dir, f"{u}.wn.wav"),
                         C.Config().audio.sample_rate)
            require(np.isfinite(w).all() and np.abs(w).max() <= 1
                    and w.std() > 0, f"{u}.wn.wav not finite in [-1, 1]")
        counted("vocoder_eval", len(utts))
        log(f"  wavenet {a['wavenet_mcd_db']} dB, GL oracle "
            f"{a['gl_oracle_mcd_db']} dB, heldout {a['heldout_wavenet_mcd_db']}"
            f" dB (same speaker {a['heldout_same_speaker_mcd_db']}, unseen "
            f"{a['unseen_speaker_mcd_db']} vs GL "
            f"{a['unseen_speaker_gl_oracle_mcd_db']}) over "
            f"{a['n_utterances']} clips ({a['n_heldout']} heldout); "
            f"realtime factor {a['gen_realtime_factor']}")
        out["vocoder_eval"] = a

    with phase(f"eval (b): quality_eval --heldout on both_r2 with wn_moon, "
               f"{EVAL_N_SPEAKER} per speaker, e2e at {EVAL_FRAMES} frames"):
        b = run("quality_eval", QE, [
            "--tacotron", BOTH_R2, "--wavenet", WN_MOON, "--data",
            ",".join(dirs), "--n", str(EVAL_N_SPEAKER), "--heldout",
            "--e2e_max_frames", str(EVAL_FRAMES), "--no_persist", *extra])
        batcher = TacotronBatcher(dirs, C.load_config(BOTH_R2), "test",
                                  batch_size=1)
        picked = {}
        for sid, d in enumerate(dirs):
            ps = sorted(batcher.path_dict[d])
            picked[QE.speaker_key(sid, d)] = len(
                ps[:: max(1, len(ps) // EVAL_N_SPEAKER)][:EVAL_N_SPEAKER])
        require(set(b) - {"wall_s"} == QE.RESULT_KEYS | QE.E2E_KEYS,
                f"quality_eval keys {sorted(b)}")
        require({k: e["n"] for k, e in b["per_speaker"].items()} == picked
                and b["n_utterances"] == sum(picked.values()),
                f"quality_eval scored {b['n_utterances']}, its selection "
                f"{picked}")
        for k, e in b["per_speaker"].items():
            require(set(e) == QE.SPEAKER_KEYS | QE.SPEAKER_E2E_KEYS,
                    f"quality_eval {k} keys {sorted(e)}")
            require(all(finite(e[f]) for f in (
                "synth_mcd_db", "oracle_mcd_db", "gap_db", "e2e_mcd_db"))
                and all(finite(x) for f in (
                    "per_utt_synth", "per_utt_oracle", "per_utt_e2e")
                    for x in e[f]), f"quality_eval {k}: an MCD not finite")
        require(all(finite(b[k]) for k in ("synth_mcd_db", "oracle_mcd_db",
                                           "gap_db", "e2e_mcd_db")),
                "quality_eval: an MCD is not finite")
        counted("quality_eval", b["n_utterances"])
        log(f"  synth (GL) {b['synth_mcd_db']} dB, oracle "
            f"{b['oracle_mcd_db']} dB, gap {b['gap_db']} dB, e2e "
            f"{b['e2e_mcd_db']} dB over {b['n_utterances']} held-out "
            f"utterances (every transcript is TEXT0: synth and e2e exercise "
            f"the path, they do not score Tacotron)")
        out["quality_eval"] = b

    with phase(f"eval (c): wavenet_diagnose on wn_moon, {EVAL_CROPS} "
               "held-out crops, on the card and on the CPU"):
        args = ["--wavenet", WN_MOON, "--data", dirs[0], "--n_crops",
                str(EVAL_CROPS)]
        c = {"card": run("wavenet_diagnose", WD, [*args, *extra]),
             "cpu": run("wavenet_diagnose_cpu", WD, [*args, "--device",
                                                    "cpu"])}
        for where, r in c.items():
            require(set(r) - {"wall_s"} == WD.RESULT_KEYS,
                    f"wavenet_diagnose ({where}) keys {sorted(r)}")
            require(finite(r["one_step_ahead_corr"])
                    and finite(r["one_step_ahead_mae"]),
                    f"wavenet_diagnose ({where}) not finite")
            require(launches["wavenet_diagnose" if where == "card"
                             else "wavenet_diagnose_cpu"] == {},
                    "wavenet_diagnose launched the generation kernel")
        diff = {k: abs(c["card"][k] - c["cpu"][k])
                for k in ("one_step_ahead_corr", "one_step_ahead_mae")}
        log(f"  card {c['card']['one_step_ahead_corr']} corr, "
            f"{c['card']['one_step_ahead_mae']} MAE, healthy "
            f"{c['card']['healthy']}; CPU {c['cpu']['one_step_ahead_corr']}"
            f", {c['cpu']['one_step_ahead_mae']}; |card - CPU| {diff} "
            f"(bound {EVAL_DIAG_TOL})")
        require(all(v <= EVAL_DIAG_TOL for v in diff.values()),
                f"wavenet_diagnose card vs CPU {diff}")
        out["wavenet_diagnose"] = dict(c, card_vs_cpu=diff)
    out["launches"] = {"mol-bfloat16": sum(
        x.get("mol-bfloat16", 0) for x in launches.values())}
    return out


def taco_train_phases(dev, smi, tmp, dirs: list) -> dict:
    """Tacotron training on the card: (c) both_r2 resumed through the
    train_tacotron CLI, its loss against seeded weights'; then, side by
    side (their walls alone are reported), the run resumed again, (e) a
    seeded single-speaker run and (f) the run of (c) served through the
    tts CLI (one kernel launch, counted); (d) the batcher's store against
    its host path; (a) one f32 step of the trained state the CLI left,
    card against CPU; (b) the step's time at full width.  Returns the
    ``taco_train`` line, with the serving launches under ``launches``."""
    from tacotron_wavenet_vocoder_korean_tpu_torch import config as C
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        from_jax_tree)
    from tacotron_wavenet_vocoder_korean_tpu_torch.data import (
        TacotronBatcher)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import (
        load_wav)
    from tacotron_wavenet_vocoder_korean_tpu_torch.text import TextCodec
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        CheckpointReader)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.tacotron_task import (
        TacotronTask, batch_to_device)

    cpu = torch.device("cpu")
    cfg = C.overlay(C.load_config(BOTH_R2), tacotron=TACO_OVERRIDES)
    cfg32 = dataclasses.replace(cfg, tacotron=dataclasses.replace(
        cfg.tacotron, compute_dtype="float32"))
    vocab = TextCodec(cfg.tacotron.cleaners).vocab_size
    out = {"card": smi}
    paths = ",".join(dirs)
    corpus_batch = batch_to_device(next(iter(TacotronBatcher(dirs, cfg))),
                                   dev, cfg.train.transfer_dtype)

    def corpus_loss(task, st) -> float:
        """The training-mode loss of ``st`` on the corpus's first batch,
        dropout from a fixed seed."""
        with torch.no_grad():
            draws = task.draw(corpus_batch,
                              torch.Generator(dev).manual_seed(0), st.step)
            return float(task.loss_fn(st.params, st.batch_stats,
                                      corpus_batch, draws)[0])

    with phase("taco_train: seeded weights' loss on a corpus batch"):
        task = TacotronTask(cfg, vocab, True, dev)
        out["seeded_loss"] = corpus_loss(task, task.init_state(0))
        log(f"  B={tuple(corpus_batch['inputs'].shape)[0]} T_out="
            f"{tuple(corpus_batch['mel_targets'].shape)[1]}: seeded loss "
            f"{out['seeded_loss']:.4f}")

    run = os.path.join(tmp, "taco_run")
    with phase(f"taco_train (c): resume both_r2 through the train_tacotron "
               f"CLI, {TACO_START} -> {TACO_RESUME_TO}"):
        rc, text, secs = run_cli("train_tacotron", [
            "--data_paths", paths, "--log_dir", run, "--load_path", BOTH_R2,
            "--num_steps", str(TACO_RESUME_TO), "--hparams", TACO_HPARAMS,
            *TACO_CLI_ARGS], dev)
        require_rc0("train_tacotron (resume both_r2)", rc, text)
        with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
            log_text = f.read()
        lines = step_lines(log_text)
        rows = read_metrics(run)
        losses = [r["loss"] for r in rows if "loss" in r]
        tests = [r["test_loss"] for r in rows if "test_loss" in r]
        lr = {r["step"]: r["learning_rate"] for r in rows
              if "learning_rate" in r}
        lr_err = max(abs(v - noam(k, cfg.tacotron)) for k, v in lr.items())
        mean_loss = float(np.mean([x[2] for x in lines]))
        files = [f"step-{TACO_START + 10}-audio.wav",
                 f"step-{TACO_START + 10}-align.png",
                 os.path.join("best", "best.json")]
        log(f"  rc 0 in {secs:.1f} s wall; Step lines {lines}; losses "
            f"{losses}, test losses {tests}; learning rate {lr} (Noam, "
            f"warmup {TACO_WARMUP:.0f}: max error {lr_err:.3g}, bound "
            f"{TACO_LR_TOL:g}); mean logged loss {mean_loss:.4f} (gate < "
            f"seeded {out['seeded_loss']:.4f}) [{smi}]")
        if not (f"Resuming from step {TACO_START}" in log_text
                and len(lr) == 2 and lr_err <= TACO_LR_TOL
                and losses and tests and np.isfinite(losses + tests).all()
                and mean_loss < out["seeded_loss"]
                and all(os.path.exists(os.path.join(run, f))
                        for f in files)):
            raise AssertionError(f"the resumed CLI run is wrong:\n"
                                 f"{text[-4000:]}")
        n = len(lines)
        out["cli"] = {"wall_s": secs, "steps": TACO_RESUME_TO - TACO_START,
                      "sec_per_step_window": lines[-1][1],
                      "sec_per_step_last_interval":
                          lines[-1][1] * n - lines[-2][1] * (n - 1),
                      "losses": losses, "test_losses": tests,
                      "mean_logged_loss": mean_loss,
                      "learning_rate_max_err": lr_err}

    with phase(f"taco_train (c), (e) and (f), side by side: the run of "
               f"(c) resumed to {TACO_RESUME_MORE}; a seeded single-speaker "
               f"run, {TACO_SEEDED_STEPS} steps; the tts CLI serves the run "
               f"of (c) with trained wn_moon, one kernel launch"):
        single = os.path.join(tmp, "taco_single")
        served = os.path.join(tmp, "taco_served")
        # (f) serves the run as (c)'s first call left it, copied, while the
        # second call writes on in the original.
        run_first = os.path.join(tmp, f"taco_run_{TACO_RESUME_TO}")
        shutil.copytree(run, run_first, ignore=shutil.ignore_patterns("best"))
        script = (
            "import json, sys\n"
            f"from {PKG} import tts\n"
            f"from {PKG}.ops.wavenet_gen import wavenet_generate\n"
            "tts.main(sys.argv[1:])\n"
            "print(json.dumps(dict(wavenet_generate.variant_launches)))\n")
        done = run_side_by_side({
            "train_tacotron (resume the run)": [
                "-m", f"{PKG}.train_tacotron", "--data_paths", paths,
                "--log_dir", run, "--load_path", run, "--num_steps",
                str(TACO_RESUME_MORE), "--hparams", TACO_HPARAMS,
                *TACO_CLI_ARGS],
            "train_tacotron (single speaker)": [
                "-m", f"{PKG}.train_tacotron", "--data_paths", dirs[0],
                "--log_dir", single, "--model_type", "single",
                "--skip_path_filter", "--num_steps", str(TACO_SEEDED_STEPS),
                "--hparams", "train.sync_every=5,train.summary_interval=5,"
                "train.test_interval=5,train.best_eval_batches=1",
                *TACO_CLI_ARGS],
            "tts": ["-c", script, "--tacotron", run_first, "--wavenet",
                    WN_MOON, "--text", TEXT0, "--speaker_id", "0",
                    "--out_dir", served]}, dev, tmp)
        text, secs2 = done["train_tacotron (resume the run)"]
        with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
            log_text = f.read()
        more = [x for x in step_lines(log_text) if x[0] > TACO_RESUME_TO]
        log(f"  (c) second call: rc 0 in {secs2:.1f} s wall; Step lines "
            f"{more}")
        if not (f"Resuming from step {TACO_RESUME_TO}" in log_text
                and [x[0] for x in more] == [TACO_RESUME_MORE]
                and os.path.isdir(os.path.join(run, "ckpt",
                                               str(TACO_RESUME_MORE)))):
            raise AssertionError(f"the second resume is wrong:\n"
                                 f"{text[-4000:]}")
        out["cli"]["second_call_wall_s"] = secs2

        text, secs = done["train_tacotron (single speaker)"]
        rows = read_metrics(single)
        s_cfg = C.load_config(single)
        vals = [r.get("loss", r.get("test_loss")) for r in rows]
        vals = [v for v in vals if v is not None]
        log(f"  (e) rc 0 in {secs:.1f} s wall; num_speakers "
            f"{s_cfg.tacotron.num_speakers}, model_type "
            f"{s_cfg.tacotron.model_type}, fused_rnn "
            f"{s_cfg.tacotron.fused_rnn}; losses {vals}")
        if not (s_cfg.tacotron.num_speakers == 1 and vals
                and np.isfinite(vals).all() and os.path.isdir(os.path.join(
                    single, "ckpt", str(TACO_SEEDED_STEPS)))):
            raise AssertionError(f"the single-speaker run is wrong:\n"
                                 f"{text[-4000:]}")
        out["single_speaker"] = {"wall_s": secs, "losses": vals}

        text, secs = done["tts"]
        launches = json.loads([ln for ln in text.splitlines()
                               if ln.startswith("{")][-1])
        mel = np.load(os.path.join(served, "0.mel.npy"))
        wav = load_wav(os.path.join(served, "0.wavenet.wav"),
                       cfg.audio.sample_rate)
        log(f"  (f) rc 0 in {secs:.1f} s wall; launches {launches}; mel "
            f"{mel.shape}, wav {wav.shape[0]} samples, peak "
            f"{np.abs(wav).max():.3f}")
        if not (np.isfinite(mel).all() and mel.ndim == 2 and len(wav)
                and np.isfinite(wav).all() and np.abs(wav).max() <= 1):
            raise AssertionError("the served mel or wav is wrong")
        if dev.type == "cuda" and launches != {"mol-bfloat16": 1}:
            raise AssertionError(f"tts launched {launches}")
        out["serve"] = {"wall_s": secs, "mel_frames": int(mel.shape[0])}
        out["launches"] = launches

    with phase(f"taco_train (d): TacotronBatcher device store vs host "
               f"path, {TACO_STORE_BATCHES} batches"):
        host = iter(TacotronBatcher(dirs, cfg))
        st = TacotronBatcher(dirs, cfg, device_store=True, device=dev)
        store = iter(st)
        walls = {"host": [], "store": []}
        for _ in range(TACO_STORE_BATCHES):
            t0 = time.perf_counter()
            h = next(host)
            walls["host"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            s_b = next(store)
            torch.cuda.synchronize()
            walls["store"].append(time.perf_counter() - t0)
            h = batch_to_device(h, dev, cfg.train.transfer_dtype)
            for k in h:
                if not (h[k].dtype == s_b[k].dtype and h[k].shape ==
                        s_b[k].shape and torch.equal(h[k], s_b[k])):
                    raise AssertionError(f"store batch differs in {k}")
        # A group's examples are read at its first batch: the mean over
        # the group is the cost per batch.
        ms = {k: 1e3 * float(np.mean(v)) for k, v in walls.items()}
        first = {k: 1e3 * v[0] for k, v in walls.items()}
        log(f"  {TACO_STORE_BATCHES} batches (one group) equal draw for "
            f"draw; next(), mean over the group: host {ms['host']:.2f} ms, "
            f"store {ms['store']:.2f} ms (x{ms['host'] / ms['store']:.1f}); "
            f"the group's first: host {first['host']:.1f} ms, store "
            f"{first['store']:.1f} ms; store_bytes {st.store_bytes:,} "
            f"[{smi}]")
        out["store"] = {"next_ms_host": ms["host"],
                        "next_ms_store": ms["store"],
                        "first_next_ms_host": first["host"],
                        "first_next_ms_store": first["store"],
                        "store_bytes": st.store_bytes}
        del st, store

    with phase(f"taco_train (a): the trained state the CLI left, one f32 "
               f"step, card vs CPU, B={TACO_CMP_B}, the same dropout "
               f"masks"):
        t0 = time.perf_counter()
        with CheckpointReader(run) as reader:
            tree = reader.restore(items=None)
        read_s = time.perf_counter() - t0
        tasks = {d.type: TacotronTask(cfg32, vocab, True, d)
                 for d in (dev, cpu)}
        template = tasks["cpu"].init_state(0)
        trained = from_jax_tree(template, tasks["cpu"].from_jax_tree(
            template, tree))
        del tree
        log(f"  the run's train state (step {int(trained.step)}, "
            f"{sum(v.numel() for v in trained.params.values()):,} params, "
            f"batch_stats, Adam) read in {read_s:.2f} s")
        cmp_cfg = C.overlay(cfg, tacotron={"batch_size": TACO_CMP_B})
        batch = next(iter(TacotronBatcher(dirs, cmp_cfg)))
        b_cpu = batch_to_device(batch, cpu, cfg.train.transfer_dtype)
        draws = tasks["cpu"].draw(b_cpu, torch.Generator().manual_seed(0),
                                  trained.step)
        res = {}
        for d in (dev, cpu):
            mv = lambda x, d=d: x.to(d)
            res[d.type] = tasks[d.type].train_step(
                map_tensors(trained, mv), map_tensors(b_cpu, mv),
                map_tensors(draws, mv))
        torch.cuda.synchronize()
        (s_card, m_card), (s_cpu, m_cpu) = res[dev.type], res["cpu"]
        errs = {
            "loss_rel": abs(float(m_card["loss"]) - float(m_cpu["loss"]))
            / abs(float(m_cpu["loss"])),
            "params": leaf_error(s_card.params, s_cpu.params),
            "update": leaf_error(
                {k: s_card.params[k] - trained.params[k].to(dev)
                 for k in trained.params},
                {k: s_cpu.params[k] - trained.params[k]
                 for k in trained.params}),
            "batch_stats": leaf_error(s_card.batch_stats, s_cpu.batch_stats),
            "adam_mu": leaf_error(s_card.opt_state[1][0]["mu"],
                                  s_cpu.opt_state[1][0]["mu"]),
            "adam_nu": leaf_error(s_card.opt_state[1][0]["nu"],
                                  s_cpu.opt_state[1][0]["nu"])}
        log(f"  T_in={tuple(b_cpu['inputs'].shape)[1]} T_out="
            f"{tuple(b_cpu['mel_targets'].shape)[1]}: loss card "
            f"{float(m_card['loss']):.6f} CPU {float(m_cpu['loss']):.6f}; "
            f"errors {errs} (bounds: loss {TACO_LOSS_TOL:g}, params "
            f"{TACO_PARAM_TOL:g}, batch_stats {TACO_STATS_TOL:g}) [{smi}]")
        if not (errs["loss_rel"] <= TACO_LOSS_TOL
                and errs["params"] <= TACO_PARAM_TOL
                and errs["batch_stats"] <= TACO_STATS_TOL
                and np.isfinite(float(m_card["loss"]))):
            raise AssertionError("the card's training step differs from "
                                 "the CPU's")
        out["card_vs_cpu"] = dict(errs, loss=float(m_card["loss"]),
                                  step=int(trained.step))
        # Why the task runs without cuDNN: the gradient at seeded weights
        # on the card with cuDNN's convolutions and without, each against
        # the CPU's (the same batch, dropout off).
        from tacotron_wavenet_vocoder_korean_tpu_torch.device import no_tf32

        class WithCudnn(TacotronTask):
            def _precision(self):
                return no_tf32()

        class WithoutOneDNN(TacotronTask):
            """The CPU's convolutions without oneDNN: another summation
            order on the same device."""
            def _precision(self):
                stack = super()._precision()
                stack.enter_context(torch.backends.mkldnn.flags(
                    enabled=False))
                return stack
        cfg0 = dataclasses.replace(cfg32, tacotron=dataclasses.replace(
            cfg32.tacotron, dropout_prob=0.0))
        rng = np.random.RandomState(0)
        syn = {"inputs": rng.randint(2, 70, (2, 16)),
               "input_lengths": np.array([16, 11]),
               "loss_coeff": np.ones(2, np.float32),
               "mel_targets": rng.randn(2, 50, cfg.audio.num_mels),
               "linear_targets": rng.randn(2, 50, cfg.audio.num_freq),
               "speaker_id": np.array([0, 1])}
        grads = {}
        for name, cls, d in (("cpu", TacotronTask, cpu),
                             ("cpu_without_onednn", WithoutOneDNN, cpu),
                             ("card", TacotronTask, dev),
                             ("card_cudnn", WithCudnn, dev)):
            t = cls(cfg0, vocab, True, d)
            st = t.init_state(0)
            grads[name] = {k: v.double().cpu() for k, v in t.grads(
                st.params, st.batch_stats,
                batch_to_device(syn, d, cfg.train.transfer_dtype))[1]
                .items()}
        norm = sum(float((g ** 2).sum()) for g in grads["cpu"].values())
        dist = {name: (sum(float(((grads[name][k] - g) ** 2).sum())
                           for k, g in grads["cpu"].items()) / norm) ** 0.5
                for name in ("card", "card_cudnn", "cpu_without_onednn")}
        log(f"  seeded gradient (B=2, T_out 50), card vs CPU in the L2 "
            f"norm: the task's (no cuDNN) {dist['card']:.3e} (bound "
            f"{TACO_GRAD_TOL:g}); with cuDNN's convolutions "
            f"{dist['card_cudnn']:.3e}; the CPU's own with oneDNN's "
            f"convolutions off {dist['cpu_without_onednn']:.3e} [{smi}]")
        if not dist["card"] <= TACO_GRAD_TOL:
            raise AssertionError("the card's gradient differs from the CPU's")
        out["card_vs_cpu"]["seeded_grad_l2"] = dist["card"]
        out["card_vs_cpu"]["seeded_grad_l2_with_cudnn"] = dist["card_cudnn"]
        out["card_vs_cpu"]["seeded_grad_l2_cpu_without_onednn"] = dist[
            "cpu_without_onednn"]
        del grads
        trained = map_tensors(trained, lambda x: x.to(dev))
        out["trained_loss"] = corpus_loss(TacotronTask(cfg, vocab, True,
                                                       dev), trained)
        log(f"  its loss on the corpus batch of the seeded gate: "
            f"{out['trained_loss']:.4f} (seeded {out['seeded_loss']:.4f})")
        del res, s_card, s_cpu, tasks

    with phase("taco_train (b): the step's time at full width (CUDA "
               "events, after a warm-up)"):
        timing = {}
        for B, T_in, T_out in TACO_TIMING_SHAPES:
            rng = np.random.RandomState(1)
            syn = {"inputs": rng.randint(2, 70, (B, T_in)),
                   "input_lengths": np.full(B, T_in),
                   "loss_coeff": np.ones(B, np.float32),
                   "mel_targets": rng.randn(B, T_out, cfg.audio.num_mels),
                   "linear_targets": rng.randn(B, T_out, cfg.audio.num_freq),
                   "speaker_id": np.arange(B) % 2}
            b = batch_to_device(syn, dev, cfg.train.transfer_dtype)
            last = (B, T_in, T_out) == TACO_TIMING_SHAPES[-1]
            for name, c in (("float32", cfg32), ("bfloat16", cfg)):
                profiled = last and name == "bfloat16"   # the served type
                task = TacotronTask(c, vocab, True, dev)
                gen = torch.Generator(dev).manual_seed(0)
                state, m = task.train_step(trained, b, generator=gen)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times = []
                holder = [state, m]

                def step():
                    holder[0], holder[1] = task.train_step(
                        holder[0], b, generator=gen)
                for _ in range(TACO_TRAIN_REPS):
                    times.append(cuda_ms(step))
                state, m = holder
                peak = torch.cuda.max_memory_allocated()
                times.sort()
                med = times[len(times) // 2]
                key = f"{name}_B{B}_T{T_out}"
                timing[key] = {
                    "ms_min": times[0], "ms_median": med, "ms_max": times[-1],
                    "peak_mem_gb": peak / 1e9, "loss": float(m["loss"])}
                counted = ""
                if profiled:
                    kernels, _, device_us = kernel_count(
                        lambda: task.train_step(state, b, generator=gen),
                        host=False)
                    timing[key].update(
                        kernels_per_step=kernels,
                        device_ms_per_step=device_us / 1e3,
                        busy_share=device_us / 1e3 / med)
                    counted = (f"; {kernels} CUDA kernels, device busy "
                               f"{device_us / 1e3:.1f} ms "
                               f"({device_us / 1e3 / med:.1%})")
                log(f"  {name} B={B} T_in={T_in} T_out={T_out}: "
                    f"{times[0]:.1f} / {med:.1f} / {times[-1]:.1f} ms per "
                    f"step (min / median / max of {TACO_TRAIN_REPS}); peak "
                    f"{peak / 1e9:.2f} GB{counted}; loss "
                    f"{float(m['loss']):.4f} [{smi}]")
                if not np.isfinite(float(m["loss"])):
                    raise AssertionError(f"{key}: loss not finite")
                del task, state, m, holder
        out["step_time"] = timing
    return out


def attention_phases(dev, smi, tmp, dirs: list) -> dict:
    """Every attention type, and simple speakers, at the both_r2 width
    (seeded weights): (a) served and timed on the card, (b) the decode
    and (c) a training step's gradient, card against CPU, for each; (d)
    train_tacotron --model_type simple from seeded weights on ``dirs``,
    served through the tts CLI (one kernel launch, counted).  Returns the
    ``attention`` line, with the serving launches under ``launches``."""
    from tacotron_wavenet_vocoder_korean_tpu_torch import config as C
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        seeded_tacotron_params)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import (
        load_wav)
    from tacotron_wavenet_vocoder_korean_tpu_torch.models.attention import (
        ATTENTION_TYPES)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.synthesizer import (
        Synthesizer)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.tacotron_task import (
        TacotronTask, batch_to_device)

    cpu = torch.device("cpu")
    base = C.load_config(WN_MOON)
    iters = ATT_SERVE_STEPS
    out = {"card": smi, "types": {}}
    for name in ATTENTION_TYPES + ("simple",):
        t16 = (dataclasses.replace(C.BOTH_R2, model_type="simple")
               if name == "simple" else
               dataclasses.replace(C.BOTH_R2, attention_type=name))
        t32 = dataclasses.replace(t16, compute_dtype="float32")
        cfg = dataclasses.replace(base, tacotron=t16)
        cfg32 = dataclasses.replace(base, tacotron=t32)
        params = seeded_tacotron_params(t16, seed=0, audio=cfg.audio)
        row = out["types"][name] = {}
        with phase(f"attention {name} (a): served on the card, B=4 bf16, "
                   f"{iters} steps, prenet dropout; timed"), torch.no_grad():
            synth = Synthesizer(cfg, params, device=dev)
            mech = type(synth.model.decoder.step.attention).__name__
            inputs, lengths = synth._prepare_inputs(TEXTS)
            res = synth.synthesize(TEXTS, speaker_ids=SPEAKERS,
                                   max_iters=iters, rng_seed=0)
            masked = max(float(x["alignment"][int(n):].max(initial=0.0))
                         for x, n in zip(res, lengths))
            finite = all(np.isfinite(x["mel"]).all() and np.isfinite(
                x["alignment"]).all() for x in res)
            frames = [x["mel"].shape[0] for x in res]
            log(f"  {mech}: kept frames {frames}; padded positions' "
                f"largest alignment {masked:.2e} (bound {ATT_MASKED_TOL:g})")
            if not finite or masked >= ATT_MASKED_TOL:
                raise AssertionError(f"{name}: served decode not finite or "
                                     "attends to padding")
            model = synth.model
            x = torch.from_numpy(inputs).long().to(dev)
            ln = torch.from_numpy(lengths).long().to(dev)
            sp = torch.from_numpy(np.asarray(SPEAKERS)).to(dev)
            g = torch.Generator(dev).manual_seed(0)
            enc = model.encode(x, ln, sp)
            masks = model.draw_prenet_masks(iters, len(TEXTS), g)
            loop = lambda: model.decoder(enc, iters, masks)
            loop()
            reps = sorted(cuda_ms(loop) / iters for _ in range(ATT_REPS))
            row.update(mechanism=mech, masked_max=masked,
                       ms_per_step_min=reps[0],
                       ms_per_step_median=reps[len(reps) // 2],
                       ms_per_step_max=reps[-1])
            log(f"  decoder loop {reps[0]:.3f} / {reps[len(reps) // 2]:.3f} "
                f"/ {reps[-1]:.3f} ms per step (min / median / max of "
                f"{ATT_REPS}) [{smi}]")
            del synth, model, enc, masks

        with phase(f"attention {name} (b): deterministic decode, card vs "
                   f"CPU, B={ATT_CMP_B}, {ATT_CMP_STEPS} steps, f32 and "
                   f"bf16"), torch.no_grad():
            B = ATT_CMP_B
            run = {}
            for c in (cfg32, cfg):
                for d in (dev, cpu):
                    m = Synthesizer(c, params, device=d).model
                    o = m(torch.from_numpy(inputs[:B]).long().to(d),
                          torch.from_numpy(lengths[:B]).long().to(d),
                          torch.from_numpy(np.asarray(SPEAKERS[:B])).to(d),
                          max_iters=ATT_CMP_STEPS)
                    run[c.tacotron.compute_dtype, d.type] = {
                        k: v.float().cpu().numpy() for k, v in o.items()}
            if any(not np.isfinite(v).all() for o in run.values()
                   for v in o.values()):
                raise AssertionError(f"{name}: decode not finite")
            card, ref = run["float32", dev.type], run["float32", "cpu"]
            errs, bf16 = {}, {}
            for k in ref:
                scale = max(1.0, float(np.abs(
                    ref["alignments" if k == "alignments"
                        else "mel_outputs"]).max()))
                errs[k] = float(np.abs(card[k] - ref[k]).max()) / scale
                d_card = float(np.abs(run["bfloat16", dev.type][k]
                                      - run["bfloat16", "cpu"][k]).mean())
                d_noise = float(np.abs(run["bfloat16", "cpu"][k]
                                       - ref[k]).mean())
                bf16[k] = {"card_vs_cpu": d_card, "cpu_bf16_vs_f32": d_noise}
            log(f"  f32 card vs CPU, of the largest |value|: {errs} (bound "
                f"{ATT_F32_TOL:g}); bf16 mean abs card vs CPU / CPU bf16 vs "
                f"f32: " + ", ".join(
                    f"{k} {v['card_vs_cpu']:.3e} / {v['cpu_bf16_vs_f32']:.3e}"
                    for k, v in bf16.items())
                + f" (bound {TACO_BF16_RATIO:g}x) [{smi}]")
            if max(errs.values()) > ATT_F32_TOL:
                raise AssertionError(f"{name}: the card's f32 decode "
                                     "differs from the CPU's")
            if any(not v["cpu_bf16_vs_f32"] > 0 or v["card_vs_cpu"]
                   > TACO_BF16_RATIO * v["cpu_bf16_vs_f32"]
                   for v in bf16.values()):
                raise AssertionError(f"{name}: the card's bf16 decode is "
                                     "farther from the CPU's than bf16 "
                                     "rounding")
            row.update(decode_f32_err=errs, decode_bf16=bf16)

        with phase(f"attention {name} (c): one f32 training step's "
                   f"gradient, card vs CPU, B={ATT_CMP_B}, T_out "
                   f"{ATT_GRAD_T_OUT}, the same dropout masks"):
            rng = np.random.RandomState(0)
            syn = {"inputs": inputs[:ATT_CMP_B],
                   "input_lengths": lengths[:ATT_CMP_B],
                   "loss_coeff": np.ones(ATT_CMP_B, np.float32),
                   "mel_targets": rng.randn(ATT_CMP_B, ATT_GRAD_T_OUT,
                                            cfg.audio.num_mels),
                   "linear_targets": rng.randn(ATT_CMP_B, ATT_GRAD_T_OUT,
                                               cfg.audio.num_freq),
                   "speaker_id": np.asarray(SPEAKERS[:ATT_CMP_B])}
            task = TacotronTask(cfg32, is_randomly_initialized=True,
                                device=cpu)
            st = task.init_state(0)
            b = batch_to_device(syn, cpu, base.train.transfer_dtype)
            draws = task.draw(b, torch.Generator().manual_seed(0), st.step)

            def grads(t, *args) -> tuple:
                losses, g, _ = t.grads(*args)
                return float(losses["loss"]), {k: v.double().cpu()
                                               for k, v in g.items()}
            l_cpu, g_cpu = grads(task, st.params, st.batch_stats, b, draws)
            # How far the CPU's own gradient moves when its convolutions
            # sum in another order (oneDNN's off): printed, not bounded.
            with torch.backends.mkldnn.flags(enabled=False):
                _, g_own = grads(task, st.params, st.batch_stats, b, draws)
            mv = lambda v: v.to(dev)
            l_card, g_card = grads(
                TacotronTask(cfg32, is_randomly_initialized=True, device=dev),
                *map_tensors((st.params, st.batch_stats, b, draws), mv))
            norm = sum(float((v ** 2).sum()) for v in g_cpu.values())
            dist = lambda g: (sum(float(((g[k] - v) ** 2).sum())
                                  for k, v in g_cpu.items()) / norm) ** 0.5
            l2, own = dist(g_card), dist(g_own)
            bound = ATT_GMM_GRAD_TOL if name == "gmm" else TACO_GRAD_TOL
            loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
            log(f"  loss card {l_card:.6f} CPU {l_cpu:.6f} ({loss_rel:.2e} "
                f"relative, bound {TACO_LOSS_TOL:g}); gradient card vs CPU "
                f"in the L2 norm {l2:.3e} (bound {bound:g}); the CPU's own "
                f"with oneDNN's convolutions off {own:.3e} [{smi}]")
            if not (np.isfinite(l_card) and loss_rel <= TACO_LOSS_TOL
                    and l2 <= bound):
                raise AssertionError(f"{name}: the card's gradient differs "
                                     "from the CPU's")
            row.update(grad_loss_rel=loss_rel, grad_l2=l2, grad_l2_bound=bound,
                       grad_l2_cpu_without_onednn=own)
            del task, st, g_card, g_cpu, g_own

    run = os.path.join(tmp, "simple_run")
    served = os.path.join(tmp, "simple_served")
    with phase(f"attention simple (d): train_tacotron --model_type simple "
               f"from seeded weights, {ATT_CLI_STEPS} steps; the tts CLI "
               f"serves it with trained wn_moon, speakers 0 and 1, one "
               f"kernel launch"):
        rc, text, secs = run_cli("train_tacotron", [
            "--data_paths", ",".join(dirs), "--log_dir", run, "--model_type",
            "simple", "--skip_path_filter", "--num_steps", str(ATT_CLI_STEPS),
            "--hparams", ATT_CLI_HPARAMS, *TACO_CLI_ARGS], dev)
        require_rc0("train_tacotron --model_type simple", rc, text)
        s_cfg = C.load_config(run)
        rows = read_metrics(run)
        vals = [r[k] for r in rows for k in ("loss", "test_loss") if k in r]
        with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
            lines = step_lines(f.read())
        log(f"  rc 0 in {secs:.1f} s wall; model_type "
            f"{s_cfg.tacotron.model_type}, {s_cfg.tacotron.num_speakers} "
            f"speakers, {s_cfg.tacotron.compute_dtype}; Step lines {lines}; "
            f"losses {vals} [{smi}]")
        if not (s_cfg.tacotron.model_type == "simple"
                and s_cfg.tacotron.num_speakers == 2 and vals and lines
                and np.isfinite(vals).all() and os.path.isdir(
                    os.path.join(run, "ckpt", str(ATT_CLI_STEPS)))):
            raise AssertionError(f"the simple run is wrong:\n"
                                 f"{text[-4000:]}")
        out["simple_cli"] = {"wall_s": secs, "losses": vals,
                             "sec_per_step_window": lines[-1][1]}
        script = (
            "import json, sys\n"
            f"from {PKG} import tts\n"
            f"from {PKG}.ops.wavenet_gen import wavenet_generate\n"
            "tts.main(sys.argv[1:])\n"
            "print(json.dumps(dict(wavenet_generate.variant_launches)))\n")
        extra = [] if dev.type == "cuda" else ["--device", "cpu"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", script, "--tacotron", run, "--wavenet",
             WN_MOON, "--text", TEXT0, "--speaker_id", "0", "--text", TEXT0,
             "--speaker_id", "1", "--out_dir", served, *extra], cwd=REPO,
            capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
        secs = time.perf_counter() - t0
        require_rc0("tts (the simple run)", proc.returncode,
                    proc.stdout + proc.stderr)
        launches = json.loads([ln for ln in proc.stdout.splitlines()
                               if ln.startswith("{")][-1])
        mels = [np.load(os.path.join(served, f"{i}.mel.npy"))
                for i in range(2)]
        wavs = [load_wav(os.path.join(served, f"{i}.wavenet.wav"),
                         cfg.audio.sample_rate) for i in range(2)]
        log(f"  tts rc 0 in {secs:.1f} s wall; launches {launches}; mels "
            f"{[m.shape for m in mels]}, wavs {[len(w) for w in wavs]} "
            f"samples, peaks {[float(np.abs(w).max()) for w in wavs]}")
        if not all(np.isfinite(m).all() and m.ndim == 2 and len(w)
                   and np.isfinite(w).all() and np.abs(w).max() <= 1
                   for m, w in zip(mels, wavs)):
            raise AssertionError("the simple run's served mel or wav is "
                                 "wrong")
        if dev.type == "cuda" and launches != {"mol-bfloat16": 1}:
            raise AssertionError(f"tts launched {launches}")
        out["simple_cli"]["serve_wall_s"] = secs
        out["launches"] = launches
    return out


def tts_phases(dev, smi, tmp) -> dict:
    """The port's entry point with both trained checkpoints: one
    ``TTSPipeline.tts`` call on 4 texts (Tacotron, Griffin-Lim and vocoder
    times split), the MCD of text 0's Griffin-Lim wav to the JAX system's
    against the seeded Tacotron's, then the ``tts`` and ``synthesizer``
    CLIs in subprocesses.  Returns the numbers for the ``tts`` line, with
    the kernel launches of the ``tts`` call under ``launches``."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.config import BOTH_R2 as B2
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        seeded_tacotron_params)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.audio_io import (
        load_wav)
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
        wavenet_generate)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.e2e import (
        TTSPipeline)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.synthesizer import (
        Synthesizer)
    from tacotron_wavenet_vocoder_korean_tpu_torch.text import TextCodec
    from tacotron_wavenet_vocoder_korean_tpu_torch.utils.metrics import mcd
    from tacotron_wavenet_vocoder_korean_tpu_torch.utils.plot import (
        image_size)

    out = {}
    with phase("TTSPipeline.from_checkpoint (both trained checkpoints)"):
        t0 = time.perf_counter()
        pipe = TTSPipeline.from_checkpoint(BOTH_R2, WN_MOON, device=dev)
        out["load_s"] = time.perf_counter() - t0
        log(f"  loaded in {out['load_s']:.2f}s (Tacotron step "
            f"{pipe.synth.step}, WaveNet step {pipe.vocoder.step})")
    out["griffin_lim"] = griffin_lim_phases(dev, smi, pipe.synth, tmp)
    a = pipe.synth.cfg.audio
    hop, sr = a.hop_size, a.sample_rate
    codec = TextCodec(pipe.synth.cfg.tacotron.cleaners)
    iters = pipe.synth.cfg.tacotron.max_iters

    with phase("TTSPipeline.tts: 4 texts, text -> mel -> GL wav and WaveNet "
               "wav, one call"):
        base = os.path.join(tmp, "tts")
        gl_s, voc_s = [], []
        timed_calls(pipe.synth, "griffin_lim_wav", gl_s)
        timed_calls(pipe.vocoder, "generate", voc_s)
        wavenet_generate.launches = 0
        wavenet_generate.variant_launches.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.tts(TTS_TEXTS, base_path=base, speaker_ids=TTS_SPEAKERS)
        wall = time.perf_counter() - t0
        launches = dict(wavenet_generate.variant_launches)
        log(f"  launches: {launches}")
        if launches != {"mol-bfloat16": 1}:
            raise AssertionError("TTSPipeline.tts did not launch the bf16 "
                                 "MoL kernel once for 4 texts")
        for i, r in enumerate(res):
            n = r["mel"].shape[0] * hop
            if r["wav"].shape != (n,) or r["wavenet_wav"].shape != (n,):
                raise AssertionError(f"text {i}: wavs {r['wav'].shape}, "
                                     f"{r['wavenet_wav'].shape}, want {n}")
            if not (np.isfinite(r["wav"]).all()
                    and np.isfinite(r["wavenet_wav"]).all()
                    and np.abs(r["wavenet_wav"]).max() <= 1):
                raise AssertionError(f"text {i}: wavs not finite, or the "
                                     "WaveNet wav outside [-1, 1]")
            names = [f"{i}.wav", f"{i}.wavenet.wav", f"{i}.mel.npy",
                     f"{i}.png"]
            missing = [f for f in names
                       if not os.path.isfile(os.path.join(base, f))]
            if missing:
                raise AssertionError(f"text {i}: not written: {missing}")
        audio_s = sum(len(r["wav"]) for r in res) / sr
        gl, voc = sum(gl_s), sum(voc_s)
        taco = wall - gl - voc
        log(f"  4 texts -> {audio_s:.3f} s of audio in {wall:.3f} s = "
            f"{audio_s / wall:.3f}x realtime aggregate: Tacotron and host "
            f"{taco:.3f} s, Griffin-Lim {gl:.3f} s ({len(gl_s)} renders), "
            f"vocoder {voc:.3f} s; frames "
            f"{[r['mel'].shape[0] for r in res]} [{smi}]")
        out["request"] = {"texts": len(res), "audio_s": audio_s,
                          "wall_s": wall, "x_realtime": audio_s / wall,
                          "tacotron_and_host_s": taco, "griffin_lim_s": gl,
                          "vocoder_s": voc,
                          "griffin_lim_share": gl / wall,
                          "frames": [int(r["mel"].shape[0]) for r in res]}

    with phase("MCD of text 0's GL wav to the JAX system's GL wav"):
        ref_gl = load_wav(E2E_GL_WAV, sr)
        ref_wn = load_wav(E2E_WAV, sr)
        seeded = Synthesizer(
            dataclasses.replace(pipe.synth.cfg, tacotron=B2),
            seeded_tacotron_params(B2, seed=0, audio=a), device=dev)
        seeded_wav = seeded.synthesize([TEXT0], speaker_ids=[0])[0]["wav"]
        mcd_t = mcd(res[0]["wav"], ref_gl, a)
        mcd_s = mcd(seeded_wav, ref_gl, a)
        mcd_wn = mcd(res[0]["wavenet_wav"], ref_wn, a)
        log(f"  GL wav MCD to samples/e2e_both_r2_wn_moon/0.wav: trained "
            f"{mcd_t:.3f} dB, seeded Tacotron {mcd_s:.3f} dB (gate: trained "
            f"< seeded); WaveNet wav MCD to 0.wavenet.wav {mcd_wn:.3f} dB")
        if not mcd_t < mcd_s:
            raise AssertionError("the trained GL wav is no closer to the JAX "
                                 "system's than the seeded Tacotron's")
        out["mcd"] = {"gl_trained_db": mcd_t, "gl_seeded_db": mcd_s,
                      "wavenet_trained_db": mcd_wn}
    del pipe, seeded

    with phase("the tts and synthesizer CLIs, in subprocesses on the card"):
        dirs = {"tts": os.path.join(tmp, "cli_tts"),
                "synthesizer": os.path.join(tmp, "cli_synth")}
        cmds = {
            "tts": ["--tacotron", BOTH_R2, "--wavenet", WN_MOON, "--text",
                    TEXT0, "--speaker_id", "0", "--out_dir", dirs["tts"]],
            "synthesizer": ["--load_path", BOTH_R2, "--text", TEXT0,
                            "--speaker_id", "0", "--manual_attention_mode",
                            "1", "--max_iters", "60", "--base_path",
                            dirs["synthesizer"]]}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.{k}", *v], cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for k, v in cmds.items()}
        cli = {}
        for k, proc in procs.items():
            text, _ = proc.communicate(timeout=CLI_TIMEOUT_S)
            cli[k] = {"rc": proc.returncode,
                      "wall_s": time.perf_counter() - t0}
            log(f"  {k} (rc {proc.returncode}, {cli[k]['wall_s']:.1f}s): "
                + " | ".join(text.strip().splitlines()[-3:]))
            if proc.returncode != 0:
                raise AssertionError(f"the {k} CLI failed:\n{text}")
        n_ids = len(codec.encode(TEXT0))
        for k, stem, steps in (("tts", "0", iters),
                               ("synthesizer", "0_manual", 60)):
            want = {f"{stem}.wav", f"{stem}.mel.npy", f"{stem}.png"}
            if k == "tts":
                want.add("0.wavenet.wav")
            got = set(os.listdir(dirs[k]))
            size = png_size(os.path.join(dirs[k], f"{stem}.png"))
            log(f"  {k}: wrote {sorted(got)}; PNG {size[1]} x {size[0]} "
                f"(alignment {n_ids} x {steps})")
            if got != want or size != image_size(n_ids, steps):
                raise AssertionError(f"the {k} CLI wrote {sorted(got)}, PNG "
                                     f"{size}; want {sorted(want)}, "
                                     f"{image_size(n_ids, steps)}")
            cli[k]["files"] = sorted(got)
        out["cli"] = cli
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# The mesh: multi-rank training on the one card
# ---------------------------------------------------------------------------

def _rank_entry(fn, rank: int, world: int, port: int, args, out) -> None:
    """One rank: the variables torch.distributed.run sets (and its one
    host thread per rank), then ``fn(*args)``; its result (or its
    traceback) goes to ``out``."""
    import traceback
    import torch.distributed as dist
    os.environ.update({
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
        "RANK": str(rank), "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)})
    torch.set_num_threads(1)
    try:
        out.put((rank, fn(*args), None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args) -> list:
    """``fn(*args)`` in ``world`` ranks forked from a fork server that has
    imported the port (no CUDA in the server); their results by rank.  A
    rank that raises, dies or gives no result within MESH_RANK_TIMEOUT_S
    raises here, and every rank is ended."""
    import queue
    import socket
    ctx = torch.multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([f"{PKG}.train.wavenet_task",
                                f"{PKG}.train.tacotron_task"])
    out = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world, port, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.perf_counter() + MESH_RANK_TIMEOUT_S
    try:
        while len(results) < world:
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{fn.__name__}: no result in "
                                   f"{MESH_RANK_TIMEOUT_S} s")
            try:
                rank, value, err = out.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"{fn.__name__}: ranks {dead} died")
                continue
            if err is not None:
                raise RuntimeError(f"{fn.__name__} rank {rank}:\n{err}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
    return [results[r] for r in range(world)]


def stop_children() -> None:
    """End every process this script started that is still running: the
    fork server of run_ranks, then the resource tracker it holds open
    (each stopped and reaped as multiprocessing's own tests stop them),
    then any other child, which is named, ended and reaped.  Without this
    the fork server outlives the script by the time it takes to exit."""
    import signal
    from multiprocessing import forkserver, resource_tracker
    for helper in (forkserver._forkserver, resource_tracker._resource_tracker):
        if hasattr(helper, "_stop"):
            helper._stop()
    me = str(os.getpid())
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat", encoding="utf-8") as f:
                stat = f.read()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if stat[stat.rindex(")") + 2:].split()[1] != me:
            continue
        print(f"chip_smoke: ending child {pid}: {cmd[:200]}", file=sys.stderr)
        with contextlib.suppress(ProcessLookupError):
            os.kill(int(pid), signal.SIGKILL)
        with contextlib.suppress(ChildProcessError):
            os.waitpid(int(pid), 0)


def timed_steps(step, reps: int, device) -> dict:
    """Host seconds per call of ``step`` over ``reps`` calls (the device
    synchronised around them), then the same with the collective clock
    on: its share of those seconds."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.parallel import (
        CollectiveClock)
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))
    out = {}
    for clocked in (False, True):
        CollectiveClock.reset(clocked)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        sync()
        out["clocked" if clocked else "plain"] = (time.perf_counter()
                                                  - t0) / reps
    out["s_per_step"] = out.pop("plain")
    out["collective_s_per_step"] = CollectiveClock.seconds / reps
    out["collective_share"] = CollectiveClock.seconds / reps / out["clocked"]
    out["collectives_per_step"] = CollectiveClock.calls / reps
    CollectiveClock.reset(False)
    return out


def _wavenet_cfg():
    from tacotron_wavenet_vocoder_korean_tpu_torch import config as C
    cfg = C.load_config(WN_MOON)
    return C.overlay(cfg, wavenet=DATA_OVERRIDES) if DATA_OVERRIDES else cfg


def graph_grads(task, params: dict, b: dict, cot: torch.Tensor) -> dict:
    """The gradient of ``<raw_output, cot>`` in every parameter (f32, TF32
    off): the training graph's backward without the MoL loss, whose f32
    gradient is ill-conditioned."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.device import no_tf32
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with no_tf32():
        o = task.model(leaves, b["input_wav"], b["local_condition"])
        g = torch.autograd.grad(o["raw_output"], list(leaves.values()),
                                grad_outputs=cot, allow_unused=True)
    return {k: torch.zeros_like(v) if x is None else x
            for (k, v), x in zip(leaves.items(), g)}


def wavenet_grads64(task, params: dict, b: dict, cot: torch.Tensor):
    """The graph's gradient under ``cot`` and the loss's gradient, in
    float64, on the first MESH_F64_T samples of the batch."""
    hop = task.cfg.audio.hop_size
    p64 = {k: v.double() for k, v in params.items()}
    b64 = {"input_wav": b["input_wav"][:, :MESH_F64_T].double(),
           "local_condition": b["local_condition"][
               :, :MESH_F64_T // hop].double()}
    return (graph_grads(task, p64, b64, cot.double()),
            task.grads(p64, b64)[1])


def mesh_wavenet_rank(n_data: int, n_model: int, tree: dict, batch: dict,
                      cot: np.ndarray, device: str) -> dict:
    """A rank of (c): the resumed wn_moon state ``tree`` (JAX's layout),
    this rank's shard and rows of it; in float64 the graph's gradient
    under this rank's rows of the cotangent ``cot`` (summed over the data
    group) and the loss's gradient (averaged), both gathered; one f32
    step, then the step timed."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        from_jax_tree)
    from tacotron_wavenet_vocoder_korean_tpu_torch.parallel import (
        all_reduce_mean, gather_tree, make_mesh)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
        WaveNetTask, batch_to_device)
    mesh = make_mesh(n_data, n_model, device=device)
    task = WaveNetTask(_wavenet_cfg(), mesh=mesh)
    state = task.shard_state(from_jax_tree(task.init_state(0), tree))
    n = len(batch["input_wav"]) // n_data
    d = mesh.coords[0]
    b = batch_to_device({k: v[d * n:(d + 1) * n] for k, v in batch.items()},
                        mesh.device)
    graph, grads = wavenet_grads64(task, state.params, b, torch.from_numpy(
        cot[d * n:(d + 1) * n]).to(mesh.device))
    graph, grads = all_reduce_mean(mesh, graph, grads)
    graph = gather_tree(mesh, {k: v * n_data for k, v in graph.items()},
                        task.placements.params)
    grads = gather_tree(mesh, grads, task.placements.params)
    new, metrics = task.train_step(state, b)
    holder = [new]

    def step():
        holder[0], m = task.train_step(holder[0], b)
        float(m["loss"])
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "shapes": {k: tuple(v.shape) for k, v in new.params.items()
                      if k in ("layer_0_skip_kernel", "layer_0_skip_bias",
                               "post_1/kernel", "post_2/kernel")},
           "backend": mesh.backend,
           "timing": timed_steps(step, MESH_REPS, mesh.device)}
    if mesh.is_main:
        out["grads"] = {k: v.cpu().numpy() for k, v in grads.items()}
        out["graph"] = {k: v.cpu().numpy() for k, v in graph.items()}
    return out


def _tacotron_cfg():
    from tacotron_wavenet_vocoder_korean_tpu_torch import config as C
    cfg = C.overlay(C.load_config(BOTH_R2), tacotron=TACO_OVERRIDES)
    return C.overlay(cfg, tacotron={"compute_dtype": "float32"})


def mesh_tacotron_rank(batch: dict, device: str) -> dict:
    """A rank of (d): seeded both_r2-width weights in f32, this rank's rows
    of the global batch, the global batch's dropout masks from a seeded
    generator; the gradient averaged over the ranks and the new running
    statistics, then the step timed."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.parallel import (
        all_reduce_mean, make_mesh)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.tacotron_task import (
        TacotronTask, batch_to_device)
    mesh = make_mesh(device=device)
    task = TacotronTask(_tacotron_cfg(), is_randomly_initialized=True,
                        mesh=mesh)
    state = task.init_state(MESH_TACO_SEED)
    n = len(batch["inputs"]) // mesh.n_data
    d = mesh.coords[0]
    b = batch_to_device({k: v[d * n:(d + 1) * n] for k, v in batch.items()},
                        mesh.device)
    draws = task.draw(b, torch.Generator(mesh.device).manual_seed(
        MESH_TACO_SEED), state.step)
    losses, grads, stats = task.grads(state.params, state.batch_stats, b,
                                      draws)
    grads, losses = all_reduce_mean(mesh, grads, losses)
    gen = torch.Generator(mesh.device).manual_seed(MESH_TACO_SEED)
    holder = [state]

    def step():
        holder[0], m = task.train_step(holder[0], b, generator=gen)
        float(m["loss"])
    out = {"loss": float(losses["loss"]), "backend": mesh.backend,
           "timing": timed_steps(step, MESH_REPS, mesh.device)}
    if mesh.is_main:
        out["grads"] = {k: v.cpu().numpy() for k, v in grads.items()}
        out["stats"] = {k: v.cpu().numpy() for k, v in stats.items()}
    return out


def metric_rows(run: str) -> dict:
    """metrics.jsonl of a run: ``{step: {key: value}}``, lines of one step
    merged."""
    rows = {}
    for r in read_metrics(run):
        rows.setdefault(r["step"], {}).update(
            {k: v for k, v in r.items() if k not in ("step", "time")})
    return rows


def hold_runs(name: str, got: str, want: str, first_tol: float,
              loss_tol: float, other_tol: float = None) -> dict:
    """The metrics of run ``got`` beside run ``want``'s, step by step: the
    first step's loss within ``first_tol`` relative, every loss after
    within ``loss_tol``, the other values (grad_norm, the learning rate,
    the train-test gap against the test loss) within ``other_tol`` when
    it is given, else printed; returns the largest relative
    differences."""
    g, w = metric_rows(got), metric_rows(want)
    if sorted(g) != sorted(w) or not w:
        raise AssertionError(f"{name}: steps {sorted(g)} vs {sorted(w)}")
    steps = sorted(w)
    first = abs(g[steps[0]]["loss"] / w[steps[0]]["loss"] - 1)
    worst = {"loss": 0.0, "other": 0.0}
    for s in steps:
        if sorted(g[s]) != sorted(w[s]):
            raise AssertionError(f"{name}: step {s} keys {sorted(g[s])}")
        for k, v in w[s].items():
            scale = abs(w[s]["test_loss"]) if k == "gap_test_train" else abs(v)
            kind = "loss" if k.endswith("loss") else "other"
            worst[kind] = max(worst[kind],
                              abs(g[s][k] - v) / max(scale, 1e-30))
    log(f"  {name}: loss by step " + ", ".join(
        f"{s}: {g[s]['loss']:.7f} / {w[s]['loss']:.7f}" for s in steps
        if "loss" in w[s]) + f"; first step {first:.3e} (bound "
        f"{first_tol:g}); losses {worst['loss']:.3e} (bound {loss_tol:g}), "
        f"other values {worst['other']:.3e} ("
        + (f"bound {other_tol:g})" if other_tol else "printed)"))
    if not (first <= first_tol and worst["loss"] <= loss_tol
            and (other_tol is None or worst["other"] <= other_tol)):
        raise AssertionError(f"{name}: outside the bounds")
    return {"first_step_rel": first, "losses_rel": worst["loss"],
            "others_rel": worst["other"]}


def mesh_phases(dev, smi, tmp, data: str, dirs: list) -> dict:
    """Multi-rank training on the one card: (a) ``train_vocoder
    --use_mesh`` as one plain process (a one-rank mesh) beside the same
    run without it; (b) the same on two gloo ranks
    (``torch.distributed.run``), served by the generate CLI (one kernel
    launch); (c) the WaveNet mesh step at the wn_moon width, (1, 2) and
    (2, 1), against the one-process step; (d) Tacotron data parallel at
    both_r2's width, the library step on 2 ranks against 1, and
    ``train_tacotron --use_mesh`` on 2 ranks beside 1; (e) the steps'
    times and the collectives' share.  The commands of (a), (b) and (d)
    run side by side first, then the library steps (timed), then the
    serving.  Two ranks share the card: nothing here measures scaling
    across cards.  Returns the ``mesh`` line, with the serving launches
    under ``launches``."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        to_jax_tree)
    from tacotron_wavenet_vocoder_korean_tpu_torch.data import (
        TacotronBatcher, WaveNetBatcher)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        restore_into_state)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.tacotron_task import (
        TacotronTask, batch_to_device as taco_to_device)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
        WaveNetTask, batch_to_device)

    out = {"card": smi, "note": "two ranks share one card over gloo: "
           "correctness and overheads, not scaling across cards"}
    size_args = [a for k, v in DATA_OVERRIDES.items()
                 for a in (f"--{k}", str(v))]
    runs = {k: os.path.join(tmp, f"mesh_{k}")
            for k in ("plain", "one_rank", "two_ranks")}
    vocoder = ["--data_dir", data, "--load_path", WN_MOON, "--num_steps",
               str(DATA_START + MESH_CLI_STEPS), "--hparams", MESH_HPARAMS,
               *size_args]
    launch2 = ["-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2"]
    taco_runs = {k: os.path.join(tmp, f"mesh_taco_{k}")
                 for k in ("one", "two")}
    tacotron = ["--data_paths", ",".join(dirs), "--num_steps",
                str(MESH_CLI_STEPS), "--hparams", MESH_TACO_HPARAMS,
                *TACO_CLI_ARGS]
    with phase(f"mesh (a), (b) and (d), side by side: resume wn_moon for "
               f"{MESH_CLI_STEPS} steps through train_vocoder, plain, "
               f"--use_mesh as one process, --use_mesh on 2 gloo ranks; "
               f"train_tacotron --use_mesh from seeded weights, "
               f"{MESH_CLI_STEPS} steps, on 2 ranks and on 1"):
        done = run_side_by_side({
            "plain": ["-m", f"{PKG}.train_vocoder", "--log_dir",
                      runs["plain"], *vocoder],
            "one_rank": ["-m", f"{PKG}.train_vocoder", "--log_dir",
                         runs["one_rank"], *vocoder, "--use_mesh"],
            "two_ranks": [*launch2, "-m", f"{PKG}.train_vocoder",
                          "--log_dir", runs["two_ranks"], *vocoder,
                          "--use_mesh"],
            "taco_one": ["-m", f"{PKG}.train_tacotron", "--log_dir",
                         taco_runs["one"], *tacotron],
            "taco_two": [*launch2, "-m", f"{PKG}.train_tacotron",
                         "--log_dir", taco_runs["two"], *tacotron,
                         "--use_mesh"]}, dev, tmp)
        for k, (text, secs) in done.items():
            backend = [ln for ln in text.splitlines() if "backend " in ln]
            log(f"  {k}: rc 0 in {secs:.1f} s wall; {backend}")
            out.setdefault("cli_wall_s", {})[k] = secs
        one_backend = "nccl" if dev.type == "cuda" else "gloo"
        if f"backend {one_backend}" not in done["one_rank"][0] or any(
                "backend gloo" not in done[k][0]
                for k in ("two_ranks", "taco_two")):
            raise AssertionError("the backend rule was not followed")
        out["a"] = hold_runs("(a) one-rank mesh vs plain", runs["one_rank"],
                             runs["plain"], MESH_FIRST_TOL, MESH_LATER_TOL)
        out["b"] = hold_runs("(b) 2 ranks vs the one-rank mesh",
                             runs["two_ranks"], runs["one_rank"],
                             MESH_FIRST_TOL, MESH_LATER_TOL)
        out["d_cli"] = hold_runs("(d) train_tacotron, 2 ranks vs 1",
                                 taco_runs["two"], taco_runs["one"],
                                 MESH_FIRST_TOL, MESH_LATER_TOL)
        for run in (runs["two_ranks"], taco_runs["two"]):
            with open(os.path.join(run, "train.log"), encoding="utf-8") as f:
                if f.read().count("first loss fetched") != 1:
                    raise AssertionError(f"{run}: train.log is not rank "
                                         "0's alone")

    mel_path = os.path.join(tmp, "mesh_serve.mel.npy")
    np.save(mel_path, np.load(E2E_MEL)[:MESH_SERVE_FRAMES])
    serve = (
        "import json, sys\n"
        f"from {PKG} import generate\n"
        f"from {PKG}.ops.wavenet_gen import wavenet_generate\n"
        "generate.main(sys.argv[1:])\n"
        "print(json.dumps(dict(wavenet_generate.variant_launches)))\n")

    cfg = _wavenet_cfg()
    with phase("mesh (c): the WaveNet mesh step at the wn_moon width, "
               "resumed, f32: (1, 2) and (2, 1) on 2 gloo ranks vs one "
               "process"):
        batch = next(iter(WaveNetBatcher([data], cfg, seed=13)))
        batch = {"input_wav": batch.input_wav,
                 "local_condition": batch.local_condition}
        task = WaveNetTask(cfg, device=dev)
        state, _ = restore_into_state(task.init_state(0), WN_MOON, None)
        tree = to_jax_tree(state)
        b = batch_to_device(batch, dev)
        o_shape = (len(batch["input_wav"]),
                   min(MESH_F64_T, batch["input_wav"].shape[1])
                   - cfg.wavenet.receptive_field, cfg.wavenet.out_channels)
        cot = np.random.RandomState(5).standard_normal(o_shape).astype(
            np.float32)
        graph1, one = wavenet_grads64(task, state.params, b,
                                      torch.from_numpy(cot).to(dev))
        new, want = task.train_step(state, b)
        holder = [new]

        def step():
            holder[0], m = task.train_step(holder[0], b)
            float(m["loss"])
        timing = {"1": timed_steps(step, MESH_REPS, dev)}
        del task, state, new, holder, b
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        S = cfg.wavenet.skip_channels
        for n_data, n_model in ((1, 2), (2, 1)):
            res = run_ranks(mesh_wavenet_rank, 2, n_data, n_model, tree,
                            batch, cot, dev.type)
            r = res[0]
            t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
            err = leaf_error(t(r["graph"]), graph1)
            loss_err = leaf_error(t(r["grads"]), one)
            rel = {k: abs(r["metrics"][k] / float(want[k]) - 1)
                   for k in ("loss", "grad_norm")}
            shapes = res[0]["shapes"]
            log(f"  ({n_data}, {n_model}) {r['backend']}: float64 "
                f"gradients of each leaf's largest: the graph's {err:.3e}, "
                f"the loss's {loss_err:.3e} (bound {MESH_GRAD_TOL:g}); the "
                f"f32 step's loss {rel['loss']:.3e}, grad_norm "
                f"{rel['grad_norm']:.3e} relative; rank 0 holds {shapes}; "
                f"{r['timing']} [{smi}]")
            split = (shapes["layer_0_skip_kernel"][1] == S // n_model
                     and shapes["layer_0_skip_bias"] == (S // n_model,)
                     and shapes["post_1/kernel"][0] == S // n_model
                     and shapes["post_2/kernel"][0] == S)
            same = all(abs(x["metrics"][k] - v) <= 1e-6 * abs(v)
                       for x in res for k, v in r["metrics"].items())
            if not (max(err, loss_err) <= MESH_GRAD_TOL
                    and rel["loss"] <= 1e-5 and split and same):
                raise AssertionError(f"({n_data}, {n_model}) disagrees "
                                     "with one process")
            timing[f"{n_data}x{n_model}"] = r["timing"]
            out[f"c_{n_data}x{n_model}"] = {
                "graph_grad_err_f64": err, "loss_grad_err_f64": loss_err,
                "loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
                "rank0_shapes": shapes}
        out["e_wavenet"] = timing

    tcfg = _tacotron_cfg()
    with phase("mesh (d): Tacotron data parallel at the both_r2 width, f32, "
               f"B={MESH_TACO_B}: the library step on 2 ranks vs 1 with the "
               "same global masks"):
        tb = next(iter(TacotronBatcher(dirs, tcfg, batch_size=MESH_TACO_B)))
        tb = {k: np.asarray(v) for k, v in vars(tb).items()}
        task = TacotronTask(tcfg, is_randomly_initialized=True, device=dev)
        state = task.init_state(MESH_TACO_SEED)
        b = taco_to_device(tb, dev)
        draws = task.draw(b, torch.Generator(dev).manual_seed(
            MESH_TACO_SEED), state.step)
        losses, one, stats = task.grads(state.params, state.batch_stats, b,
                                        draws)
        gen = torch.Generator(dev).manual_seed(MESH_TACO_SEED)
        holder = [state]

        def step():
            holder[0], m = task.train_step(holder[0], b, generator=gen)
            float(m["loss"])
        timing = {"1": timed_steps(step, MESH_REPS, dev)}
        one = {k: v.cpu().numpy() for k, v in one.items()}
        stats = {k: v.cpu().numpy() for k, v in stats.items()}
        loss1 = float(losses["loss"])
        del task, state, holder, b, draws
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        res = run_ranks(mesh_tacotron_rank, 2, tb, dev.type)
        r = res[0]
        diff = sum(float(((r["grads"][k] - g) ** 2).sum())
                   for k, g in one.items())
        norm = sum(float((g ** 2).sum()) for g in one.values())
        grad_l2 = (diff / norm) ** 0.5
        # A running mean is 0.01 x a batch mean that may cancel: means are
        # held against the largest of them all (tests/test_torch_cuda.py).
        means = max(float(np.abs(v).max()) for k, v in stats.items()
                    if k.endswith("running_mean"))
        stat_err = max(float(np.abs(r["stats"][k] - v).max()) / (
            means if k.endswith("running_mean") else float(np.abs(v).max()))
            for k, v in stats.items())
        loss_rel = abs(r["loss"] / loss1 - 1)
        log(f"  2 ranks ({r['backend']}) vs 1: loss {loss_rel:.3e} "
            f"relative, gradient {grad_l2:.3e} in L2 (bound "
            f"{TACO_GRAD_TOL:g}), batch_stats {stat_err:.3e} (bound "
            f"{MESH_STATS_TOL:g}); {r['timing']} [{smi}]")
        if not (grad_l2 <= TACO_GRAD_TOL and stat_err <= MESH_STATS_TOL
                and loss_rel <= 1e-5
                and abs(res[1]["loss"] / r["loss"] - 1) <= 1e-6):
            raise AssertionError("(d) 2 ranks disagree with 1")
        timing["2x1"] = r["timing"]
        out["d"] = {"loss_rel": loss_rel, "grad_l2_rel": grad_l2,
                    "batch_stats_err": stat_err}
        out["e_tacotron"] = timing

    with phase("mesh (b): the generate CLI serves the 2-rank vocoder run, "
               "one kernel launch"):
        done = run_side_by_side({
            "generate": ["-c", serve, "--load_path", runs["two_ranks"],
                         "--mel", mel_path, "--out",
                         os.path.join(tmp, "mesh_served.wav")]}, dev, tmp)
        text, secs = done["generate"]
        launches = json.loads(text.strip().splitlines()[-1])
        log(f"  rc 0 in {secs:.1f} s wall; launches {launches}")
        if dev.type == "cuda" and launches != {"mol-bfloat16": 1}:
            raise AssertionError(f"generate launched {launches}")
        out["launches"] = launches

    with phase("mesh (e): times, two ranks sharing the card"):
        for name in ("e_wavenet", "e_tacotron"):
            for k, t in out[name].items():
                log(f"  {name[2:]} {k}: {t['s_per_step']:.4f} s/step, "
                    f"collectives {t['collective_share']:.1%} of a clocked "
                    f"step ({t['collectives_per_step']:.0f} per step) "
                    f"[{smi}]")
    return out


def width_configs(w) -> dict:
    """The widths the ``widths`` phases hold, from wn_moon's config ``w``."""
    rep = dataclasses.replace
    softmax = dict(input_type="mulaw-quantize", scalar_input=False)
    twice = rep(w, residual_channels=64, dilation_channels=64)
    wide = rep(w, residual_channels=128, dilation_channels=128)
    tiny = rep(w, dilations=(1, 2, 4, 1, 2, 4), residual_channels=8,
               dilation_channels=8, skip_channels=16, out_channels=12,
               initial_filter_width=8)
    return {
        "twice": twice,
        "twice_softmax": rep(twice, out_channels=w.quantization_channels,
                             **softmax),
        "wide": wide,
        "wide_softmax": rep(wide, out_channels=w.quantization_channels,
                            **softmax),
        "r64_d32": rep(w, dilations=w.dilations[:10], residual_channels=64),
        "r32_d64": rep(w, dilations=w.dilations[:10], dilation_channels=64),
        "tiny": tiny,
        "r12_d12_s20": rep(tiny, residual_channels=12, dilation_channels=12,
                           skip_channels=20),
        "w40_mol40": rep(tiny, residual_channels=16, dilation_channels=16,
                         skip_channels=24, initial_filter_width=40,
                         out_channels=120),
        "softmax_q300": rep(tiny, quantization_channels=300,
                            out_channels=300, **softmax),
    }


def widths_phases(dev, smi, cfg, mels) -> dict:
    """The generation kernel at other widths than wn_moon's, on seeded
    weights and the committed mels through each width's own upsampler and
    lc projection, primed as the full-width phases prime: 2x wn_moon's
    residual width (R = D = 64, its 50 layers, S = 512, MoL of 10 and the
    256-way softmax head; f32 takes one weight slot), 4x (R = D = 128, the
    same stack and heads: over one block's shared memory, the cluster
    instance, 4 blocks per stream), R != D at 10
    layers, TINY's widths, widths off the 8-channel grid (padded by the
    wrapper), 40 front taps with 40 components, a 300-way softmax head.
    Each: the library's shared-memory size equal to ``kernel_smem``'s and
    its plan (blocks per stream, slots, bytes) to ``kernel_plan``'s; f32
    kernel vs
    twin teacher-forced (WIDTH_T steps) and free-running (WIDTH_FREE);
    bf16 kernel vs twin teacher-forced over WIDTH_BF16_T steps within
    compare_bf16's bounds, its early steps held, as the trained phase holds
    them, to BF16_RATIO times the twin's own distance from f32 there (but
    never tighter than BF16_EARLY_TOL), component flips left to the flip
    share (a wider network meets near-tied components early: at 2x the
    twin and the f32 kernel part by flips in the first steps too); at 2x
    the four variants timed at B
    = TIME_B over WIDTH_TIME_T steps, and one ``WaveNetGenerator`` request
    per head; at 4x the four cluster variants timed at B = TIME_B over
    CLUSTER_TIME_T steps (the bf16 twin's time too), and one request per
    head and weight type, the launch counts set to 0 before each and read
    after (the cluster instance's own serving path).  A config over the
    8-block ceiling (R = D = 256) is refused at construction with nothing
    allocated.  Returns, per variant, the widths held and the 2x and 4x
    numbers."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        seeded_params)
    from tacotron_wavenet_vocoder_korean_tpu_torch.dsp.mulaw import (
        mulaw_quantize)
    from tacotron_wavenet_vocoder_korean_tpu_torch.models.wavenet import (
        Upsampler)
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.build import (
        load_library)
    from tacotron_wavenet_vocoder_korean_tpu_torch.ops.wavenet_gen import (
        WEIGHT_DTYPES, generate_bytes, generate_flops, generate_plain,
        kernel_plan, kernel_smem, kernel_variant, pack_params,
        precompute_lc_proj, wavenet_generate)
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
        WaveNetGenerator)
    w, hop, sr = cfg.wavenet, cfg.audio.hop_size, cfg.audio.sample_rate
    lib = load_library("wavenet_gen")
    lib.wavenet_gen_plan.restype = ctypes.c_int

    def c_plan(*args):
        """The library's (blocks, slots, bytes per block)."""
        k, n = ctypes.c_int(), ctypes.c_int()
        nbytes = lib.wavenet_gen_plan(*args, ctypes.byref(k), ctypes.byref(n))
        return k.value, n.value, nbytes

    out = {}                 # variant -> list of widths held

    def held(v, entry):
        out.setdefault(v, []).append(entry)

    def inputs(c, params, packed, B, T, seed):
        """lc projection [B, T, L*2D] of the mels, and a primed stream: a
        sine with noise (mu-law classes for the softmax head)."""
        f = -(-T // hop)
        mel = np.stack([np.resize(mels[b % len(mels)], (f, mels[0].shape[1]))
                        for b in range(B)]).astype(np.float32)
        lc = Upsampler(c).load_params(params).to(dev)(
            torch.from_numpy(mel).to(dev))[:, :T]
        rng = np.random.default_rng(seed)
        x = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 300, (1, B))
                          * np.arange(T)[:, None] / sr)
             + 0.05 * rng.standard_normal((T, B)))
        primed = torch.from_numpy(x.astype(np.float32)).to(dev)
        if not c.scalar_input:
            primed = mulaw_quantize(primed, c.quantization_channels).float()
        return precompute_lc_proj(packed, lc), primed.contiguous()

    for name, c in width_configs(w).items():
        W = c.initial_filter_width if c.scalar_input else c.filter_width
        C = c.out_channels if c.scalar_input else c.quantization_channels
        dims = (len(c.dilations), c.residual_channels, c.dilation_channels,
                c.skip_channels, C, W)
        shape = dict(zip(("L", "R", "D", "S", "C", "W"), dims))
        for wdt in WEIGHT_DTYPES:
            bf = int(wdt == torch.bfloat16)
            c_side = (lib.wavenet_gen_smem_bytes(*dims, bf),
                      lib.wavenet_gen_slots(*dims, bf))
            if c_side != kernel_smem(*dims, wdt):
                raise AssertionError(f"{name}: the library's shared memory "
                                     f"{c_side} != kernel_smem's "
                                     f"{kernel_smem(*dims, wdt)}")
            if c_plan(*dims, bf) != kernel_plan(*dims, wdt):
                raise AssertionError(f"{name}: the library's plan "
                                     f"{c_plan(*dims, bf)} != kernel_plan's "
                                     f"{kernel_plan(*dims, wdt)}")
        plans = {wdt: kernel_plan(*dims, wdt) for wdt in WEIGHT_DTYPES}
        slots = {str(wdt)[6:]: plans[wdt][1] for wdt in WEIGHT_DTYPES}
        blocks = {str(wdt)[6:]: plans[wdt][0] for wdt in WEIGHT_DTYPES}
        cluster = name.startswith("wide")
        with phase(f"widths {name}: {shape}, weight slots {slots}, blocks "
                   f"per stream {blocks}"), torch.no_grad():
            params = seeded_params(c, seed=0, device=dev)
            f32, b16 = (pack_params(c, params, wdt) for wdt in WEIGHT_DTYPES)
            v32, v16 = kernel_variant(f32), kernel_variant(b16)
            B = TIME_B
            proj, primed = inputs(c, params, f32, WIDTH_BF16_B, WIDTH_BF16_T,
                                  31)
            entry = dict(name=name, **shape)
            # f32: teacher-forced, then free-running.
            span = proj[:B, :WIDTH_T].contiguous()
            prime_span = primed[:WIDTH_T, :B].contiguous()
            kw = dict(deterministic=True, primed=prime_span,
                      prime_len=WIDTH_T)
            k32 = wavenet_generate(f32, span, **kw)
            res = {}
            plain_ms = cuda_ms(lambda: res.update(
                p=generate_plain(f32, span, **kw)))
            span_ms = cuda_ms(lambda: wavenet_generate(f32, span, **kw))
            free = proj[:B, :WIDTH_FREE].contiguous()
            kf = wavenet_generate(f32, free, deterministic=True)
            pf = generate_plain(f32, free, deterministic=True)
            e32 = dict(entry, blocks=blocks["float32"],
                       slots=slots["float32"],
                       smem_bytes=plans[torch.float32][2])
            if c.scalar_input:
                err = compare(f"f32 teacher-forced {WIDTH_T}", k32, res["p"])
                err_free = compare(f"f32 free-running {WIDTH_FREE}", kf, pf,
                                   tol=FREE_RUN_TOL, max_share=0.0)
                if float(kf.std()) == 0.0:
                    raise AssertionError(f"{name}: constant free run")
                held(v32, dict(e32, max_abs_err=err,
                               max_abs_err_free=err_free))
            else:
                err, agree = compare_classes(
                    f"f32 teacher-forced {WIDTH_T}", k32, res["p"],
                    CLASS_AGREE_F32, C)
                _, agree_free = compare_classes(
                    f"f32 free-running {WIDTH_FREE}", kf, pf,
                    CLASS_AGREE_F32, C)
                held(v32, dict(e32, class_agreement=agree,
                               class_agreement_free=agree_free,
                               **({"max_abs_err": err} if cluster else {})))
            # bf16: teacher-forced, against the twin and the f32 kernel.
            kw = dict(deterministic=True, primed=primed,
                      prime_len=WIDTH_BF16_T)
            k32 = wavenet_generate(f32, proj, **kw)
            k16 = wavenet_generate(b16, proj, **kw)
            res16 = {}
            plain16_ms = cuda_ms(lambda: res16.update(
                p=generate_plain(b16, proj, **kw)))
            t16 = res16.pop("p")
            early_noise = early_max((t16 - k32).abs(), skip_flips=True)
            early_tol = max(BF16_EARLY_TOL, BF16_RATIO * early_noise)
            err16, agree16 = compare_bf16(
                f"bf16 teacher-forced {WIDTH_BF16_T}", k16, t16, k32,
                classes=not c.scalar_input, early_tol=early_tol,
                early_skip_flips=True)
            e16 = dict(entry, blocks=blocks["bfloat16"],
                       slots=slots["bfloat16"],
                       smem_bytes=plans[torch.bfloat16][2])
            if cluster:
                e16.update(plain_ms=plain16_ms, plain_steps=WIDTH_BF16_T,
                           plain_batch=WIDTH_BF16_B)
            held(v16, dict(e16, **({"max_abs_err": err16,
                                    "early_tol": early_tol}
                                   if agree16 is None
                                   else {"class_agreement": agree16,
                                         "max_abs_err": err16})))
            del proj, primed, span, free, k32, k16, t16, res
            if not name.startswith(("twice", "wide")):
                continue
            temp = 1.0 if c.scalar_input else 0.7
            steps = CLUSTER_TIME_T if cluster else WIDTH_TIME_T
            for v, pk in ((v32, f32), (v16, b16)):
                p_t, _ = inputs(c, params, pk, B, steps, 32)
                gen_t = torch.Generator(dev).manual_seed(33)
                wavenet_generate(pk, p_t[:, :64].contiguous(),
                                 generator=gen_t, temperature=temp)
                ms = cuda_ms(lambda: wavenet_generate(
                    pk, p_t, generator=gen_t, temperature=temp))
                flops = generate_flops(pk, B, steps)
                nbytes = generate_bytes(pk, B, steps)
                t_ops = flops / PEAK_FLOPS_S[pk["w_tap"].dtype] * 1e3
                t_bytes = nbytes / HBM_BYTES_S * 1e3
                out[v][-1].update(
                    us_per_step=ms / steps * 1e3, ms=ms,
                    timing_batch=B, timing_steps=steps,
                    bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
                span = ""
                if v == v32:
                    out[v][-1].update(plain_ms=plain_ms,
                                      ms_plain_steps=span_ms,
                                      plain_steps=WIDTH_T)
                    span = (f"; {WIDTH_T} steps: kernel {span_ms:.2f} ms, "
                            f"plain twin {plain_ms:.1f} ms")
                log(f"  {v} B={B} T={steps}: {ms:.1f} ms "
                    f"({ms / steps * 1e3:.1f} us per step); bound "
                    f"{max(t_ops, t_bytes):.3f} ms ({flops:.3e} FLOP, "
                    f"{nbytes:.3e} B){span} [{smi}]")
                del p_t
            # One request per head (and, for the cluster instance, per
            # weight type), its launches counted from 0.
            for wdt in (WEIGHT_DTYPES if cluster else (None,)):
                gen = WaveNetGenerator(dataclasses.replace(cfg, wavenet=c),
                                       params, device="cuda",
                                       weight_dtype=wdt)
                v = kernel_variant(gen.packed)
                wavenet_generate.launches = 0
                wavenet_generate.variant_launches.clear()
                mel = mels[0][:WIDTH_FRAMES]
                t0 = time.perf_counter()
                wav = gen.generate(mel, seed=5, temperature=temp)
                dt = time.perf_counter() - t0
                launches = wavenet_generate.launches
                if launches != 1 or wavenet_generate.variant_launches[v] != 1:
                    raise AssertionError(
                        f"{name}: the generator launched {launches} times "
                        f"({dict(wavenet_generate.variant_launches)})")
                if cluster and not v.endswith("-cluster"):
                    raise AssertionError(f"{name}: served by {v}")
                if wav.shape != (WIDTH_FRAMES * hop,) or not (
                        np.isfinite(wav).all() and np.abs(wav).max() <= 1):
                    raise AssertionError(f"{name}: generator wav not finite "
                                         "in [-1, 1]")
                out[v][-1].update(generator_launches=launches,
                                  generator_s=dt)
                log(f"  WaveNetGenerator ({gen.weight_dtype}, {v}): "
                    f"{mel.shape[0]} frames -> {wav.shape[0]} samples in "
                    f"{dt:.3f}s, one launch, std {wav.std():.4f}")
                del gen
            del params, f32, b16

    with phase("widths: over the 8-block cluster's shared-memory ceiling, "
               "refused at construction"):
        over = dataclasses.replace(w, residual_channels=256,
                                   dilation_channels=256)
        params = seeded_params(over, seed=0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        for wdt in WEIGHT_DTYPES:
            try:
                WaveNetGenerator(dataclasses.replace(cfg, wavenet=over),
                                 params, device="cuda", weight_dtype=wdt)
            except ValueError as e:
                log(f"  R = D = 256, L = 50, {wdt}: ValueError ({e})")
            else:
                raise AssertionError("R = D = 256 was not refused")
        if torch.cuda.memory_allocated(dev) != before:
            raise AssertionError("the refused generator allocated memory")
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
        build.load_libraries("wavenet_gen")

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
    spans = {}   # variant -> (kernel ms, twin ms, steps) of one span

    def timed_pair(v, kernel, plain, steps):
        """kernel() and plain(), each timed: the variant's span times."""
        res = {}
        spans[v] = (cuda_ms(lambda: res.update(k=kernel())),
                    cuda_ms(lambda: res.update(p=plain())), steps)
        return res["k"], res["p"]
    with phase("MoL head, f32: kernel vs plain twin, full width, B=4"), \
            torch.no_grad():
        packed = packs["mol-float32"]
        B, T = 4, 512
        proj = lc_proj_for("mol-float32", B, T)
        primed = prime_signal(B, T, 1)
        kw = dict(deterministic=True, primed=primed, prime_len=T)
        k, p = timed_pair("mol-float32",
                          lambda: wavenet_generate(packed, proj, **kw),
                          lambda: generate_plain(packed, proj, **kw), T)
        torch.cuda.synchronize()
        errors["mol-float32"].append(compare(
            f"(a) deterministic, teacher-forced {T}", k, p))

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
            f"(c) stochastic, same noise, teacher-forced {T}", k, p))

        B, T = 8, 512
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
        log(f"  (d) Philox vs torch.Generator, {B} x {T} teacher-forced: "
            f"KS={ks:.4f} (bound {bound:.4f}), std kernel "
            f"{float(k.std()):.4f} plain {float(p.std()):.4f}")
        if not ks < bound:
            raise AssertionError("(d) Philox samples differ in distribution")
        del proj, primed, k, p

    with phase("softmax head, f32: kernel vs plain twin, full width, B=4"), \
            torch.no_grad():
        packed = packs["softmax-float32"]
        B, T = 4, 512
        proj = lc_proj_for("softmax-float32", B, T)
        primed = prime_classes(B, T, 11)
        kw = dict(deterministic=True, primed=primed, prime_len=T)
        k, p = timed_pair("softmax-float32",
                          lambda: wavenet_generate(packed, proj, **kw),
                          lambda: generate_plain(packed, proj, **kw), T)
        err, agree_a = compare_classes(
            f"(a) deterministic, teacher-forced {T}", k, p, CLASS_AGREE_F32)
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
            f"(c) stochastic T=0.7, same noise, teacher-forced {T}", k, p,
            CLASS_AGREE_F32)
        errors["softmax-float32"].append(err)
        agreement["softmax-float32"] = min(agree_a, agree_c)

        B, T = 8, 512
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
        log(f"  (d) Philox vs torch.Generator, {B} x {T} classes "
            f"teacher-forced: chi2={stat:.1f} on {dof} dof (bound {bound:.1f}"
            f" at alpha={ALPHA}); distinct classes kernel "
            f"{len(torch.unique(k))} plain {len(torch.unique(p))}")
        if not stat < bound:
            raise AssertionError("(d) Philox classes differ in distribution")
        del proj, primed, noise, k, p

    with phase("bf16 weights: kernel vs bf16 twin, full width, B=4"), \
            torch.no_grad():
        B, T = 4, 512
        signals = {"mol": prime_signal(B, T, 21),
                   "softmax": prime_classes(B, T, 22)}
        for head, primed in signals.items():
            proj = lc_proj_for(f"{head}-bfloat16", B, T)
            run = lambda fn, dt: fn(packs[f"{head}-{dt}"], proj,
                                    deterministic=True, primed=primed,
                                    prime_len=T)
            k16, t16 = timed_pair(f"{head}-bfloat16",
                                  lambda: run(wavenet_generate, "bfloat16"),
                                  lambda: run(generate_plain, "bfloat16"), T)
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

    widths = widths_phases(dev, smi, cfg, mels)

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
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        trained = trained_phases(dev, gen, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    trained_launches = trained.pop("launches")
    trained_errors = trained.pop("max_abs_err")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        tts = tts_phases(dev, smi, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tts_launches = tts.pop("launches")

    timing = {}
    with phase(f"kernel timing, B={TIME_B} T={TIME_T}"), torch.no_grad():
        B, T = TIME_B, TIME_T
        for v, packed in packs.items():
            temp = 0.7 if v.startswith("softmax") else 1.0
            proj = lc_proj_for(v, B, T)
            gen_t = torch.Generator(dev).manual_seed(6)
            ms = cuda_ms(lambda: wavenet_generate(
                packed, proj, generator=gen_t, temperature=temp))
            del proj
            # The twin launches hundreds of small ops per sample: it and
            # the kernel were timed on the comparison phases' span.
            span_ms, plain_ms, steps = spans[v]
            flops = generate_flops(packed, B, T)
            nbytes = generate_bytes(packed, B, T)
            t_ops = flops / PEAK_FLOPS_S[packed["w_tap"].dtype] * 1e3
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            timing[v] = dict(ms=ms, plain_ms=plain_ms, span_ms=span_ms,
                             steps=steps, t_ops=t_ops, t_bytes=t_bytes)
            log(f"  wavenet_generate[{v}] B={B} T={T}: {ms:.1f} ms "
                f"({ms / T * 1e3:.1f} us per step, {B * T / ms * 1e3:.0f} "
                f"samples/s aggregate); bound {max(t_ops, t_bytes):.2f} ms "
                f"({flops:.3e} FLOP, {nbytes:.3e} B); {steps} steps "
                f"teacher-forced: kernel {span_ms:.2f} ms, plain twin "
                f"{plain_ms:.1f} ms [{smi}]")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        corpus, preprocess = preprocess_phase(dev, smi, tmp)
        train = training_phases(dev, smi, tmp, corpus)
        data = data_phases(dev, smi, tmp, corpus,
                           train["step_time"]["float32"]["ms_median"],
                           train["seeded_eval_loss"])
        dirs = taco_speaker_dirs(tmp, corpus)
        evals = eval_phases(dev, smi, tmp, dirs)
        taco_train = taco_train_phases(dev, smi, tmp, dirs)
        attention = attention_phases(dev, smi, tmp, dirs)
        mesh = mesh_phases(dev, smi, tmp, corpus, dirs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    data["preprocess"] = preprocess
    cli_launches = data.pop("launches")
    eval_launches = evals.pop("launches")
    taco_cli_launches = taco_train.pop("launches")
    simple_cli_launches = attention.pop("launches")
    mesh_cli_launches = mesh.pop("launches")

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
            "plain_steps": t["steps"],
            "ms_plain_steps": t["span_ms"],
            "bound_ms": max(t["t_ops"], t["t_bytes"]),
            "bound_by": "operations" if t["t_ops"] >= t["t_bytes"] else "bytes",
            "library_ms": None,
            "launches_text_to_wav": text_launches.get(v, 0),
            "launches_tts": tts_launches.get(v, 0),
            "timing_batch": TIME_B,
            "timing_steps": TIME_T,
            "us_per_step": t["ms"] / TIME_T * 1e3,
        }
        if v in agreement:
            entry["class_agreement"] = agreement[v]
        entry["widths"] = widths[v]
        if v in train["serve"]["launches"]:
            entry["launches_train_serve"] = train["serve"]["launches"][v]
        if v in cli_launches:
            entry["launches_train_cli"] = cli_launches[v]
        if v in taco_cli_launches:
            entry["launches_tacotron_train_cli"] = taco_cli_launches[v]
        if v in simple_cli_launches:
            entry["launches_simple_cli"] = simple_cli_launches[v]
        if v in mesh_cli_launches:
            entry["launches_mesh_cli"] = mesh_cli_launches[v]
        if v in eval_launches:
            entry["launches_eval"] = eval_launches[v]
        if f"{v}_max_abs_err" in trained_errors:
            entry["trained_max_abs_err"] = trained_errors[f"{v}_max_abs_err"]
            entry["launches_trained"] = sum(
                x.get(v, 0) for x in trained_launches.values())
        kernels.append(entry)
    # The cluster instance (4x wn_moon's residual width): its launches are
    # the serving requests' of the widths phases, counted from 0 there.
    for v, held in widths.items():
        if not v.endswith("-cluster"):
            continue
        (c,) = held
        if c.get("generator_launches", 0) < 1:
            raise AssertionError(f"the serving path did not launch {v}")
        kernels.append({
            "name": f"wavenet_generate[{v}]",
            "route": "cuda",
            "source": f"{PKG}/csrc/wavenet_gen.cu",
            "replaces": TPU_KERNEL,
            "launches": c["generator_launches"],
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"],
            "plain_ms": c["plain_ms"],
            "plain_steps": c["plain_steps"],
            "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"],
            "library_ms": None,
            "blocks_per_stream": c["blocks"],
            "slots": c["slots"],
            "smem_bytes_per_block": c["smem_bytes"],
            "timing_batch": c["timing_batch"],
            "timing_steps": c["timing_steps"],
            "us_per_step": c["us_per_step"],
            "widths": held,
        })
    log(f"total wall time {time.perf_counter() - t_all:.1f}s")
    print(json.dumps({"tacotron": taco}))
    print(json.dumps({"trained": trained}))
    print(json.dumps({"tts": dict(tts, card=smi)}))
    print(json.dumps({"train": train}))
    print(json.dumps({"data": data}))
    print(json.dumps({"taco_train": taco_train}))
    print(json.dumps({"attention": attention}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"eval": evals}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
