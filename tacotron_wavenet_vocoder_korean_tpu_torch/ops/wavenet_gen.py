"""WaveNet generation kernel: packing, lc projection, the CUDA kernel's
wrapper and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/wavenet_pallas.py``
(``pack_params``, ``precompute_lc_proj``, ``pallas_generate``,
``pallas_incremental_generate``).  The kernel, ``csrc/wavenet_gen.cu``,
replaces the Pallas kernel ``pallas_generate`` with both of its sampling
heads (mixture of logistics for scalar input, Q-way softmax for
``mulaw-quantize``) and both weight types (f32, bf16), at any width whose
layout fits a block's shared memory or, with each stream's gate channels
split over a thread-block cluster of up to 8 blocks, the cluster's
(``kernel_plan``, ``kernel_limits_error``); it computes the same function
on an unfused packed layout of its own:

  w_tap     [L, 2D, 2R]  row 2j+f (f=0 filter, 1 gate) of channel j over
                         [old tap (h[t-d]) | current tap (h[t])]
  w_res_t   [L, R, D]    residual kernels, transposed
  b_res     [L, R]
  front_t   [R, W]       scalar input: front causal conv taps, transposed
  front_oh  [W, Q, R]    quantized input: the taps per class; the one-hot
                         product is a gather of W rows
  w_skip    [L*D, S]     every layer's skip kernel, stacked (one product)
  skip_bias [S]          the layers' skip biases, summed
  post1 [S, S], b1 [S], post2_t [C, S], b2 [C]
  w_lc_all  [C_lc, L*2D], lc_bias [L*2D], w_gc_all [G, L*2D]: consumed by
                         precompute_lc_proj, per layer [filter D | gate D]
  dilations [L] int32

The layer filter/gate biases and the speaker row live in the lc projection;
the residual bias is added per layer; the skip biases are summed once.

Weights (``WEIGHTS``) are stored in ``weight_dtype``; biases and the lc
projection stay f32, the set the Pallas kernel keeps in f32.  With bf16
weights every product rounds its activation to bf16 and accumulates in f32,
as the Pallas kernel does.

The kernel reads this layout with R, D and S zero-padded to multiples of 8
(``kernel_layout``, made by the wrapper; the lc projection keeps the
caller's D).  Split over k > 1 blocks, D is padded to a multiple of 8k and
``w_res_t`` and ``w_skip`` are repacked so that each block's share is
contiguous (``cluster_layout``).  ``pack_params``, the twin and
``generate_flops`` / ``generate_bytes`` keep the caller's widths.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from ..config import WaveNetConfig
from ..models.mixture import U_MAX, U_MIN, sample_from_discretized_mix_logistic
from ..models.wavenet import Params
from .build import load_library

Packed = Dict[str, torch.Tensor]

# The matrices stored in the weight type; every other packed tensor is f32.
WEIGHTS = ("w_tap", "w_res_t", "front_t", "front_oh", "w_skip", "post1",
           "post2_t")
WEIGHT_DTYPES = (torch.float32, torch.bfloat16)

# The kernel's widths are padded to whole 16-byte chunks: PAD channels.
PAD = 8
# Shared memory one thread block may use on an H100 (sm_90).
SMEM_LIMIT = 232_448
_THREADS = 512
_MAX_SKIP = 8 * _THREADS      # the kernel's partial sums: S <= 4096
_MAX_SLOTS = {torch.bfloat16: 8, torch.float32: 4}
# Blocks per stream: one, or a thread-block cluster (8 is the portable most).
CLUSTER_SIZES = (1, 2, 4, 8)


def pack_params(cfg: WaveNetConfig, params: Params,
                weight_dtype: torch.dtype = torch.float32) -> Packed:
    """The port's kernel layout from the flat parameter dict, its matrices
    in ``weight_dtype`` (f32 or bf16)."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype {weight_dtype} is not one of "
                         f"{WEIGHT_DTYPES}")
    if not cfg.scalar_input and cfg.out_channels != cfg.quantization_channels:
        raise ValueError(
            f"the softmax head needs out_channels == quantization_channels, "
            f"got {cfg.out_channels} and {cfg.quantization_channels}")
    L = len(cfg.dilations)
    R, D, S = (cfg.residual_channels, cfg.dilation_channels,
               cfg.skip_channels)
    ref = params["causal_kernel"]
    zeros = lambda *s: torch.zeros(*s, dtype=torch.float32, device=ref.device)
    bias = lambda name, n: (params[name] if cfg.use_biases else zeros(n))
    w_tap, w_res_t, b_res, w_skip, w_lc, lc_bias = [], [], [], [], [], []
    skip_bias = zeros(S)
    for i in range(L):
        wf = params[f"layer_{i}_filter_kernel"]             # [2, R, D]
        wg = params[f"layer_{i}_gate_kernel"]
        f_rows = torch.cat([wf[0], wf[1]], dim=0).T         # [D, 2R]
        g_rows = torch.cat([wg[0], wg[1]], dim=0).T
        w_tap.append(torch.stack([f_rows, g_rows], dim=1).reshape(2 * D, 2 * R))
        w_res_t.append(params[f"layer_{i}_res_kernel"].T)   # [R, D]
        b_res.append(bias(f"layer_{i}_res_bias", R))
        w_skip.append(params[f"layer_{i}_skip_kernel"])     # [D, S]
        skip_bias = skip_bias + bias(f"layer_{i}_skip_bias", S)
        w_lc.append(torch.cat([params[f"layer_{i}_lc_filter"],
                               params[f"layer_{i}_lc_gate"]], dim=-1))
        lc_bias.append(torch.cat([bias(f"layer_{i}_filter_bias", D),
                                  bias(f"layer_{i}_gate_bias", D)]))
    C = params["post_2/kernel"].shape[-1]
    packed = {
        "w_tap": torch.stack(w_tap),
        "w_res_t": torch.stack(w_res_t),
        "b_res": torch.stack(b_res),
        "w_skip": torch.cat(w_skip, dim=0),
        "skip_bias": skip_bias,
        "post1": params["post_1/kernel"],
        "b1": bias("post_1/bias", S),
        "post2_t": params["post_2/kernel"].T,
        "b2": bias("post_2/bias", C),
        "w_lc_all": torch.cat(w_lc, dim=-1),
        "lc_bias": torch.cat(lc_bias),
        "dilations": torch.tensor(cfg.dilations, dtype=torch.int32,
                                  device=ref.device),
    }
    if cfg.scalar_input:
        packed["front_t"] = ref[:, 0, :].T
    else:
        packed["front_oh"] = ref                            # [W, Q, R]
    if "layer_0_gc_filter" in params:
        packed["w_gc_all"] = torch.cat([
            torch.cat([params[f"layer_{i}_gc_filter"],
                       params[f"layer_{i}_gc_gate"]], dim=-1)
            for i in range(L)], dim=-1)
    dtype = lambda k: weight_dtype if k in WEIGHTS else torch.float32
    return {k: v.to(dtype(k)).contiguous() if v.is_floating_point()
            else v.contiguous() for k, v in packed.items()}


def kernel_widths(packed: Packed) -> Tuple[int, int, int, int, int, int]:
    """(L, R, D, S, C, W) of a packed layout, the caller's widths."""
    L, two_d, two_r = packed["w_tap"].shape
    W = (packed["front_oh"].shape[0] if "front_oh" in packed
         else packed["front_t"].shape[1])
    return (L, two_r // 2, two_d // 2, packed["w_skip"].shape[1],
            packed["b2"].shape[0], W)


def kernel_variant(packed: Packed, blocks: Optional[int] = None) -> str:
    """The kernel variant a packed layout runs: its head and weight type,
    e.g. ``"softmax-bfloat16"``, and ``-cluster`` when its stream is split
    over ``blocks`` > 1 blocks (by default ``kernel_plan``'s)."""
    head = "softmax" if "front_oh" in packed else "mol"
    dtype = packed["w_tap"].dtype
    if blocks is None:
        blocks = (kernel_plan(*kernel_widths(packed), dtype)[0]
                  if dtype in WEIGHT_DTYPES else 1)
    name = f"{head}-{str(dtype).replace('torch.', '')}"
    return name if blocks == 1 else f"{name}-cluster"


def precompute_lc_proj(packed: Packed, lc: torch.Tensor,
                       gc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, C_lc] -> [B, T, L*2D]: one matrix product outside the sampling
    loop, plus the layer biases and, with ``gc [B, G]``, the speaker row."""
    proj = lc @ packed["w_lc_all"] + packed["lc_bias"]
    if gc is not None:
        proj = proj + (gc @ packed["w_gc_all"])[:, None, :]
    return proj.contiguous()


def _mol_sample(logits: torch.Tensor, deterministic: bool,
                u: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's mixture-of-logistics head.  Deterministic: the mean of
    the most probable component, tied maxima sharing the weight as the
    Pallas kernel shares it, clipped to [-1, 1].  Stochastic: the port's
    MoL sampler on the uniforms ``u [B, nr+1]`` (component draws, then the
    logistic draw); ties of Gumbel scores have probability zero."""
    nr = logits.shape[-1] // 3
    if not deterministic:
        return sample_from_discretized_mix_logistic(
            logits, uniforms=(u[:, :nr], u[:, nr]))
    scores = logits[:, :nr]
    sel = (scores >= scores.max(dim=-1, keepdim=True).values).to(logits.dtype)
    mean = (logits[:, nr:2 * nr] * sel).sum(-1) / sel.sum(-1)
    return mean.clamp(-1.0, 1.0)


def _softmax_sample(logits: torch.Tensor, deterministic: bool,
                    temperature: float,
                    u: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's softmax head: scores ``log(softmax + 1e-20) / T`` (the
    Pallas kernel's and the scan sampler's formula), plus Gumbel noise
    ``-log(-log(u))`` from the uniforms ``u [B, Q]`` clipped to
    [1e-5, 1-1e-5] when stochastic; the lowest class among tied maxima
    wins.  Returns the class ids as floats."""
    scores = torch.log(torch.softmax(logits, dim=-1) + 1e-20) / temperature
    if not deterministic:
        scores = scores - torch.log(-torch.log(u.clamp(U_MIN, U_MAX)))
    Q = logits.shape[-1]
    classes = torch.arange(Q, device=logits.device).expand_as(scores)
    top = scores >= scores.max(dim=-1, keepdim=True).values
    return torch.where(top, classes, Q).min(dim=-1).values.to(torch.float32)


def _rounding(weight_dtype: torch.dtype):
    """What a product does to its activation: round it to the weight type
    (identity for f32)."""
    if weight_dtype == torch.float32:
        return lambda x: x
    return lambda x: x.to(weight_dtype).to(torch.float32)


@torch.no_grad()
def generate_plain(packed: Packed, lc_proj: torch.Tensor,
                   deterministic: bool = False,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   primed: Optional[torch.Tensor] = None,
                   prime_len: int = 0,
                   temperature: float = 1.0) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same inputs and math, step by
    step.  ``lc_proj [B, T, L*2D]``; ``noise`` (uniforms ``[T, B, nr+1]``
    for the MoL head, ``[T, B, Q]`` for the softmax head) replaces
    ``generator``; ``primed [T, B]`` (samples, or class ids for the softmax
    head) is the input for ``t < prime_len``.  Returns [B, T]: samples, or
    class ids as floats."""
    B, T, _ = lc_proj.shape
    f32 = {k: v.to(torch.float32) for k, v in packed.items()
           if k in WEIGHTS}
    rnd = _rounding(packed["w_tap"].dtype)
    L, two_d, two_r = f32["w_tap"].shape
    D, R = two_d // 2, two_r // 2
    quantized = "front_oh" in packed
    C = packed["b2"].shape[0]
    if quantized:
        W = f32["front_oh"].shape[0]
        n_noise = C
    else:
        W = f32["front_t"].shape[1]
        n_noise = C // 3 + 1
    dil = packed["dilations"].tolist()
    dev = lc_proj.device
    rings = [torch.zeros(B, d, R, device=dev) for d in dil]
    # Quantized: -1 marks "no sample yet"; it selects no tap.
    win = torch.full((B, W), -1.0 if quantized else 0.0, device=dev)
    out = torch.empty(B, T, device=dev)
    for t in range(T):
        if t < prime_len:
            win[:, W - 1] = primed[t]
        if quantized:
            h = torch.zeros(B, R, device=dev)
            for w in range(W):
                cls = win[:, w].long()
                row = f32["front_oh"][w, cls.clamp(min=0)]
                h = h + torch.where((cls >= 0)[:, None], row, 0.0)
        else:
            h = rnd(win) @ f32["front_t"].T
        lc_t = lc_proj[:, t].view(B, L, 2, D)
        gated = []
        for l, d in enumerate(dil):
            slot = t % d
            x = rnd(torch.cat([rings[l][:, slot], h], dim=-1))  # [B, 2R]
            fg = (x @ f32["w_tap"][l].T).view(B, D, 2)
            gt = rnd(torch.tanh(fg[..., 0] + lc_t[:, l, 0])
                     * torch.sigmoid(fg[..., 1] + lc_t[:, l, 1]))
            rings[l][:, slot] = h
            h = h + gt @ f32["w_res_t"][l].T + packed["b_res"][l]
            gated.append(gt)
        z = rnd(torch.relu(torch.cat(gated, -1) @ f32["w_skip"]
                           + packed["skip_bias"]))
        z = rnd(torch.relu(z @ f32["post1"] + packed["b1"]))
        logits = z @ f32["post2_t"].T + packed["b2"]
        u = None
        if not deterministic:
            u = (noise[t] if noise is not None else
                 torch.rand(B, n_noise, generator=generator, device=dev))
        x = (_softmax_sample(logits, deterministic, temperature, u)
             if quantized else _mol_sample(logits, deterministic, u))
        out[:, t] = x
        win = torch.cat([win[:, 1:], x[:, None]], dim=-1)
    return out


def _pad(n: int, to: int = PAD) -> int:
    return -(-n // to) * to


def _smem_total(L: int, R: int, D: int, S: int, C: int, W: int,
                slots: int, wsize: int, blocks: int = 1) -> int:
    """``smem_layout(...).total`` of ``csrc/wavenet_gen.cu`` at padded
    widths (D a block's share when ``blocks`` > 1): the weight ring, its
    mbarriers (and one per layer; with a cluster, another per layer), the
    f32 buffers (with a cluster, the two exchange buffers [2][k][R], the
    partial skip vector and the sample's slot), the int tables."""
    split = blocks > 1
    bars = slots * 5 * R * D * wsize
    f32s = (bars + 8 * (2 * slots + L + (L if split else 0)) + 15) & ~15
    floats = (_pad(W, 4) + 2 * R + L * R + 2 * L * D + L * D + 2 * S
              + _pad(C, 4) + L * R + 8 * _THREADS
              + (2 * blocks * R + S + 4 if split else 0))
    return f32s + 4 * floats + 12 * L


def _block_smem(L: int, R: int, D: int, S: int, C: int, W: int,
                blocks: int, weight_dtype: torch.dtype) -> Tuple[int, int]:
    """(bytes, weight slots) of one block when a stream runs on ``blocks``
    blocks: as many slots as fit in ``SMEM_LIMIT``, up to 8 (bf16) or 4
    (f32); (bytes with one slot, 0) when not even one fits."""
    R, S, Dl = _pad(R), _pad(S), _pad(D, PAD * blocks) // blocks
    wsize = torch.finfo(weight_dtype).bits // 8
    for slots in range(_MAX_SLOTS[weight_dtype], 0, -1):
        total = _smem_total(L, R, Dl, S, C, W, slots, wsize, blocks)
        if total <= SMEM_LIMIT:
            return total, slots
    return total, 0


def kernel_smem(L: int, R: int, D: int, S: int, C: int, W: int,
                weight_dtype: torch.dtype) -> Tuple[int, int]:
    """(shared memory bytes, weight slots) of one block of the kernel at the
    caller's widths with one block per stream, as ``wavenet_gen_smem_bytes``
    / ``wavenet_gen_slots`` of ``csrc/wavenet_gen.cu`` compute them: as
    many slots of the weight ring as fit in ``SMEM_LIMIT``, up to 8 (bf16)
    or 4 (f32); (bytes with one slot, 0) when not even one fits."""
    return _block_smem(L, R, D, S, C, W, 1, weight_dtype)


def kernel_plan(L: int, R: int, D: int, S: int, C: int, W: int,
                weight_dtype: torch.dtype) -> Tuple[int, int, int]:
    """(blocks per stream, weight slots, shared memory bytes per block) the
    kernel runs the caller's widths with, as ``wavenet_gen_plan`` of
    ``csrc/wavenet_gen.cu`` computes it: one block whenever its layout fits
    (with ``kernel_smem``'s slots and bytes); else, of the cluster sizes 2,
    4 and 8 whose per-block layout fits, the fewest that leave each chain
    lane at most one gate channel (D/k <= 32), or the fewest when none does
    (R = D = 128 at 50 layers: 4 blocks in either weight type, though 2
    fit in bf16; see PERF.md); (8, 0, bytes at 8 blocks with one slot)
    when none fits."""
    fits = []
    for blocks in CLUSTER_SIZES:
        nbytes, slots = _block_smem(L, R, D, S, C, W, blocks, weight_dtype)
        if slots:
            if blocks == 1:
                return 1, slots, nbytes
            fits.append((blocks, slots, nbytes))
    if not fits:
        return blocks, 0, nbytes
    narrow = [f for f in fits if _pad(D, PAD * f[0]) // f[0] <= 32]
    return (narrow or fits)[0]


def _limits_error(L: int, R: int, D: int, W: int, S: int, C: int,
                  quantized: bool, weight_dtype: torch.dtype
                  ) -> Optional[str]:
    """Why the CUDA kernel cannot run these widths, or None when it can."""
    if weight_dtype not in WEIGHT_DTYPES:
        return (f"the CUDA kernel takes weights of {WEIGHT_DTYPES}, got "
                f"{weight_dtype}")
    if _pad(S) > _MAX_SKIP:
        return (f"the CUDA kernel takes up to {_MAX_SKIP} skip channels, "
                f"got S={S}")
    if not quantized and (C < 3 or C % 3):
        return f"the MoL head takes 3 * nr_mix channels, got {C}"
    blocks, slots, nbytes = kernel_plan(L, R, D, S, C, W, weight_dtype)
    if slots == 0:
        return (f"the CUDA kernel needs {nbytes:,} bytes of shared memory "
                f"per block at L={L}, R={R}, D={D}, S={S} with "
                f"{str(weight_dtype).replace('torch.', '')} weights, one "
                f"weight slot and the gate channels split over {blocks} "
                f"blocks of a cluster, over the {SMEM_LIMIT:,} bytes a block "
                "may use")
    return None


def kernel_limits_error(cfg: WaveNetConfig,
                        weight_dtype: torch.dtype = torch.bfloat16
                        ) -> Optional[str]:
    """Why the CUDA kernel cannot run ``cfg``'s widths with ``weight_dtype``
    weights (the message names the limit), or None when it can.  The kernel
    takes any R, D, front taps, MoL components and softmax classes, and S
    up to 4096, as long as a block's shared memory (``kernel_plan``: the
    weight ring of at least one layer slot, 5RD/k weights, plus L(3R +
    3D/k) + 2S + C + W + 4096 floats of buffers, with the gate channels
    split over a cluster of k = 1, 2, 4 or 8 blocks) fits in the 232,448
    bytes an H100 block may use; and, as the JAX package's kernel, two taps
    per dilated layer (``filter_width`` 2).  The plain twin takes any
    width."""
    if cfg.filter_width != 2:
        return (f"the generation kernel takes filter_width 2 (two taps per "
                f"dilated layer), got {cfg.filter_width}")
    scalar = cfg.scalar_input
    return _limits_error(
        len(cfg.dilations), cfg.residual_channels, cfg.dilation_channels,
        cfg.initial_filter_width if scalar else cfg.filter_width,
        cfg.skip_channels,
        cfg.out_channels if scalar else cfg.quantization_channels,
        not scalar, weight_dtype)


def kernel_layout(packed: Packed, blocks: int = 1) -> Packed:
    """``packed`` with R, D and S zero-padded to multiples of 8, the layout
    the CUDA kernel reads (every weight row a whole number of 16-byte
    chunks in either weight type); ``packed`` itself when no width needs
    it.  Padding is exact: a padded gate channel has zero weights and zero
    lc, so it gates tanh(0) * sigmoid(0) = 0; a padded residual row stays
    0; a padded skip column gives relu(0) = 0 into zero post rows.  The lc
    weights are left as they are: the kernel takes the caller's projection
    and stages it into the padded layout.  For a stream split over
    ``blocks`` blocks D is padded to a multiple of 8 * ``blocks``."""
    L, two_d, two_r = packed["w_tap"].shape
    D, R, S = two_d // 2, two_r // 2, packed["w_skip"].shape[1]
    Rp, Dp, Sp = _pad(R), _pad(D, PAD * blocks), _pad(S)
    if (Rp, Dp, Sp) == (R, D, S):
        return packed

    def pad(key, shape, view=None):
        x = packed[key] if view is None else packed[key].view(view)
        out = x.new_zeros(shape)
        out[tuple(slice(0, n) for n in x.shape)] = x
        return out

    C = packed["b2"].shape[0]
    out = dict(packed)
    out["w_tap"] = pad("w_tap", (L, Dp, 2, 2, Rp),
                       (L, D, 2, 2, R)).view(L, 2 * Dp, 2 * Rp)
    out["w_res_t"] = pad("w_res_t", (L, Rp, Dp))
    out["b_res"] = pad("b_res", (L, Rp))
    out["w_skip"] = pad("w_skip", (L, Dp, Sp), (L, D, S)).view(L * Dp, Sp)
    out["skip_bias"] = pad("skip_bias", (Sp,))
    out["post1"] = pad("post1", (Sp, Sp))
    out["b1"] = pad("b1", (Sp,))
    out["post2_t"] = pad("post2_t", (C, Sp))
    if "front_t" in packed:
        out["front_t"] = pad("front_t", (Rp, packed["front_t"].shape[1]))
    else:
        W, Q, _ = packed["front_oh"].shape
        out["front_oh"] = pad("front_oh", (W, Q, Rp))
    return out


def cluster_layout(packed: Packed, blocks: int) -> Packed:
    """``kernel_layout(packed, blocks)`` with each block's share of the
    residual and skip weights contiguous, the layout the cluster instance
    reads: ``w_res_t`` [L, k, R, D/k] (block c's residual columns
    [c D/k, (c+1) D/k) of each layer) and ``w_skip`` [k, L*D/k, S] (block
    c's rows of each layer's skip kernel), k = ``blocks``.  ``w_tap``'s
    rows 2j+f are already contiguous per block.  ``kernel_layout(packed)``
    itself for one block."""
    padded = kernel_layout(packed, blocks)
    if blocks == 1:
        return padded
    L, R, D = padded["w_res_t"].shape
    S = padded["w_skip"].shape[1]
    Dl = D // blocks
    out = dict(padded)
    out["w_res_t"] = (padded["w_res_t"].view(L, R, blocks, Dl)
                      .permute(0, 2, 1, 3).contiguous())
    out["w_skip"] = (padded["w_skip"].view(L, blocks, Dl, S)
                     .permute(1, 0, 2, 3).reshape(blocks, L * Dl, S)
                     .contiguous())
    return out


_PACKED_ORDER = ("w_tap", "w_res_t", "b_res", "front", "w_skip",
                 "skip_bias", "post1", "b1", "post2_t", "b2")


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound on first use."""
    fn = load_library("wavenet_gen").wavenet_gen_launch
    fn.argtypes = ([ctypes.c_void_p] * 16
                   + [ctypes.c_uint64, ctypes.c_int64] + [ctypes.c_int] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           device: torch.device, shape=None) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")


def wavenet_generate(packed: Packed, lc_proj: torch.Tensor,
                     deterministic: bool = False,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None,
                     primed: Optional[torch.Tensor] = None,
                     prime_len: int = 0,
                     temperature: float = 1.0) -> torch.Tensor:
    """Generate [B, T] samples (class ids for the softmax head) for
    ``lc_proj [B, T, L*2D]``.

    On a CUDA tensor this launches ``csrc/wavenet_gen.cu`` (one block per
    stream on ``kernel_layout(packed)``, or a cluster of ``kernel_plan``'s
    blocks per stream on ``cluster_layout``) and counts the launch in
    ``wavenet_generate.launches`` and, by ``kernel_variant``, in
    ``wavenet_generate.variant_launches``; widths the kernel does not take,
    and a launch the card refuses, raise.  On a CPU tensor it runs
    ``generate_plain``.  Stochastic mode takes its noise from ``noise`` if
    given, else from Philox seeded by ``generator``.  ``temperature`` scales
    the softmax head's scores; the MoL head takes only 1.0."""
    return _generate(packed, lc_proj, deterministic, generator, noise,
                     primed, prime_len, temperature)


def _generate(packed: Packed, lc_proj: torch.Tensor,
              deterministic: bool = False,
              generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None,
              primed: Optional[torch.Tensor] = None,
              prime_len: int = 0, temperature: float = 1.0,
              blocks: Optional[int] = None) -> torch.Tensor:
    """``wavenet_generate``, with ``blocks`` forcing the blocks per stream
    on the card (1, 2, 4 or 8, for timing; ``kernel_plan``'s by default)."""
    quantized = "front_oh" in packed
    if not deterministic and noise is None and generator is None:
        raise ValueError("stochastic generation needs a generator or noise")
    if prime_len and primed is None:
        raise ValueError("prime_len > 0 needs the primed stream")
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if not quantized and temperature != 1.0:
        raise ValueError("temperature applies to the softmax head only; the "
                         "mixture-of-logistics head takes 1.0")
    dev = lc_proj.device
    if dev.type == "cpu":
        return generate_plain(packed, lc_proj, deterministic, generator,
                              noise, primed, prime_len, temperature)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    B, T, LD2 = lc_proj.shape
    L, two_d, two_r = packed["w_tap"].shape
    R, D = two_r // 2, two_d // 2
    S = packed["w_skip"].shape[1]
    C = packed["b2"].shape[0]
    wdt = packed["w_tap"].dtype
    if wdt not in WEIGHT_DTYPES:
        raise TypeError(f"weights have dtype {wdt}, expected one of "
                        f"{WEIGHT_DTYPES}")
    if quantized:
        W = packed["front_oh"].shape[0]
        front_shape, n_noise = (W, C, _pad(R)), C
    else:
        W = packed["front_t"].shape[1]
        front_shape, n_noise = (_pad(R), W), C // 3 + 1
    error = _limits_error(L, R, D, W, S, C, quantized, wdt)
    if error is not None:
        raise ValueError(error)
    if blocks is None:
        blocks = kernel_plan(L, R, D, S, C, W, wdt)[0]
    elif blocks not in CLUSTER_SIZES or not _block_smem(
            L, R, D, S, C, W, blocks, wdt)[1]:
        raise ValueError(f"{blocks} blocks per stream do not take L={L}, "
                         f"R={R}, D={D}, S={S}")
    if LD2 != L * two_d:
        raise ValueError(f"lc_proj {tuple(lc_proj.shape)} does not match "
                         f"L={L} layers of 2D={two_d}")
    if not 0 <= prime_len <= T:
        raise ValueError(f"prime_len={prime_len} outside [0, {T}]")
    f32 = torch.float32
    _check("lc_proj", lc_proj, f32, dev)
    padded = cluster_layout(packed, blocks)
    args = dict(padded, front=padded["front_oh" if quantized else "front_t"])
    for k in _PACKED_ORDER:
        _check(k, args[k], wdt if k in WEIGHTS + ("front",) else f32, dev,
               front_shape if k == "front" else None)
    _check("dilations", packed["dilations"], torch.int32, dev, (L,))
    if primed is not None:
        _check("primed", primed, f32, dev, (T, B))
    if noise is not None:
        _check("noise", noise, f32, dev, (T, B, n_noise))

    dil = packed["dilations"]
    ring_stride = int(dil.sum().item()) * _pad(R)
    ring = torch.zeros(B, blocks, ring_stride, dtype=f32, device=dev)
    out = torch.empty(B, T, dtype=f32, device=dev)
    seed = 0
    if not deterministic and noise is None:
        seed = int(torch.randint(2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _launcher()(
        ptr(lc_proj), *(args[k].data_ptr() for k in _PACKED_ORDER),
        dil.data_ptr(), ptr(primed), ptr(noise), ring.data_ptr(),
        out.data_ptr(), seed, ring_stride, B, T, L, R, D, W, S, C,
        int(prime_len), int(deterministic), int(quantized),
        int(wdt == torch.bfloat16), float(temperature), blocks,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc <= -1000:
        raise RuntimeError(
            f"wavenet_gen kernel launch refused: the card holds {-1000 - rc} "
            f"clusters of {blocks} blocks at once, fewer than B={B} streams")
    if rc != 0:
        raise RuntimeError(f"wavenet_gen kernel launch failed: CUDA error {rc}")
    wavenet_generate.launches += 1
    wavenet_generate.variant_launches[kernel_variant(packed, blocks)] += 1
    return out


wavenet_generate.launches = 0
wavenet_generate.variant_launches = collections.Counter()


def incremental_generate_cuda(cfg: WaveNetConfig, packed: Packed,
                              lc: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              gc: Optional[torch.Tensor] = None,
                              seed_audio: Optional[torch.Tensor] = None,
                              deterministic: bool = False,
                              noise: Optional[torch.Tensor] = None,
                              temperature: float = 1.0) -> torch.Tensor:
    """The JAX package's ``incremental_generate`` through the kernel (on
    CPU tensors, through its plain twin): upsampled ``lc [B, T, C_lc]`` ->
    [B, T] samples, or class ids as floats for ``mulaw-quantize``, B streams
    in one launch.  ``seed_audio`` teacher-forces the first T_seed steps:
    ``[B, T_seed, 1]`` samples for scalar input, ``[B, T_seed, Q]`` one-hot
    classes otherwise (the scan sampler's convention)."""
    B, T, _ = lc.shape
    lc_proj = precompute_lc_proj(packed, lc, gc)
    primed, prime_len = None, 0
    if seed_audio is not None:
        prime_len = seed_audio.shape[1]
        if prime_len > T:
            raise ValueError(f"seed of {prime_len} samples exceeds T={T}")
        vals = (seed_audio[:, :, 0] if cfg.scalar_input
                else seed_audio.argmax(dim=-1).to(torch.float32))
        primed = torch.zeros(T, B, dtype=torch.float32, device=lc.device)
        primed[:prime_len] = vals.T
    return wavenet_generate(packed, lc_proj, deterministic, generator, noise,
                            primed, prime_len, temperature)


def generate_flops(packed: Packed, B: int, T: int) -> float:
    """Operations of one launch, in the arithmetic the kernel does them
    with (multiply-adds count two): the front conv (for the softmax head a
    gather, W*R adds), per layer the [2R]x[2R,2D] tap and [D]x[D,R]
    residual products, the skip, post1 and post2 products.  The sampling
    heads' elementwise work (under 0.1% of it) is left out."""
    L, two_d, two_r = packed["w_tap"].shape
    S = packed["w_skip"].shape[1]
    C = packed["b2"].shape[0]
    D, R = two_d // 2, two_r // 2
    if "front_oh" in packed:
        front = packed["front_oh"].shape[0] * R
    else:
        front = 2 * packed["front_t"].shape[1] * R
    per = front + 2 * (L * (two_r * two_d + D * R) + L * D * S + S * S
                       + S * C)
    return float(per) * B * T


def generate_bytes(packed: Packed, B: int, T: int) -> float:
    """Bytes an unprimed launch with Philox noise must move: each input read
    once (lc projection, weights at their stored width, biases), the output
    written once."""
    weights = sum(v.numel() * v.element_size() for k, v in packed.items()
                  if k in WEIGHTS or k in _PACKED_ORDER)
    lc = B * T * packed["w_tap"].shape[0] * packed["w_tap"].shape[1] * 4
    return float(weights + lc + B * T * 4)
