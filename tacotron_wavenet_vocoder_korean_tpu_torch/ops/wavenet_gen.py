"""WaveNet generation kernel: packing, lc projection, the CUDA kernel's
wrapper and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/wavenet_pallas.py``
(``pack_params``, ``precompute_lc_proj``, ``pallas_generate``,
``pallas_incremental_generate``).  The kernel, ``csrc/wavenet_gen.cu``,
replaces the Pallas kernel ``pallas_generate``; it computes the same
function on an unfused packed layout of its own:

  w_tap     [L, 2D, 2R]  row 2j+f (f=0 filter, 1 gate) of channel j over
                         [old tap (h[t-d]) | current tap (h[t])]
  w_res_t   [L, R, D]    residual kernels, transposed
  b_res     [L, R]
  front_t   [R, W]       front causal conv taps, transposed
  w_skip    [L*D, S]     every layer's skip kernel, stacked (one product)
  skip_bias [S]          the layers' skip biases, summed
  post1 [S, S], b1 [S], post2_t [C, S], b2 [C]
  w_lc_all  [C_lc, L*2D], lc_bias [L*2D], w_gc_all [G, L*2D]: consumed by
                         precompute_lc_proj, per layer [filter D | gate D]
  dilations [L] int32

The layer filter/gate biases and the speaker row live in the lc projection;
the residual bias is added per layer; the skip biases are summed once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from ..config import WaveNetConfig
from ..models.mixture import sample_from_discretized_mix_logistic
from ..models.wavenet import Params, require_scalar_input
from .build import load_library

Packed = Dict[str, torch.Tensor]


def pack_params(cfg: WaveNetConfig, params: Params) -> Packed:
    """The port's kernel layout from the flat parameter dict (f32)."""
    require_scalar_input(cfg)
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
        "front_t": params["causal_kernel"][:, 0, :].T,
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
    if "layer_0_gc_filter" in params:
        packed["w_gc_all"] = torch.cat([
            torch.cat([params[f"layer_{i}_gc_filter"],
                       params[f"layer_{i}_gc_gate"]], dim=-1)
            for i in range(L)], dim=-1)
    return {k: v.to(torch.float32).contiguous() if v.is_floating_point()
            else v.contiguous() for k, v in packed.items()}


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
    """The kernel's sampling head.  Deterministic: the mean of the most
    probable component, tied maxima sharing the weight as the Pallas kernel
    shares it, clipped to [-1, 1].  Stochastic: the port's MoL sampler on
    the uniforms ``u [B, nr+1]`` (component draws, then the logistic draw);
    ties of Gumbel scores have probability zero."""
    nr = logits.shape[-1] // 3
    if not deterministic:
        return sample_from_discretized_mix_logistic(
            logits, uniforms=(u[:, :nr], u[:, nr]))
    scores = logits[:, :nr]
    sel = (scores >= scores.max(dim=-1, keepdim=True).values).to(logits.dtype)
    mean = (logits[:, nr:2 * nr] * sel).sum(-1) / sel.sum(-1)
    return mean.clamp(-1.0, 1.0)


@torch.no_grad()
def generate_plain(packed: Packed, lc_proj: torch.Tensor,
                   deterministic: bool = False,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None,
                   primed: Optional[torch.Tensor] = None,
                   prime_len: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same inputs and math, step by
    step.  ``lc_proj [B, T, L*2D]``; ``noise [T, B, nr+1]`` uniforms replace
    ``generator``; ``primed [T, B]`` is the input for ``t < prime_len``.
    Returns [B, T]."""
    B, T, _ = lc_proj.shape
    w_tap = packed["w_tap"]
    L, two_d, two_r = w_tap.shape
    D, R = two_d // 2, two_r // 2
    W = packed["front_t"].shape[1]
    nr = packed["b2"].shape[0] // 3
    dil = packed["dilations"].tolist()
    dev = lc_proj.device
    w_pair = w_tap.view(L, D, 2, two_r)
    rings = [torch.zeros(B, d, R, device=dev) for d in dil]
    win = torch.zeros(B, W, device=dev)
    out = torch.empty(B, T, device=dev)
    for t in range(T):
        if t < prime_len:
            win[:, W - 1] = primed[t]
        h = win @ packed["front_t"].T
        lc_t = lc_proj[:, t].view(B, L, 2, D)
        gated = []
        for l, d in enumerate(dil):
            slot = t % d
            x = torch.cat([rings[l][:, slot], h], dim=-1)      # [B, 2R]
            f = x @ w_pair[l, :, 0].T + lc_t[:, l, 0]
            g = x @ w_pair[l, :, 1].T + lc_t[:, l, 1]
            gt = torch.tanh(f) * torch.sigmoid(g)
            rings[l][:, slot] = h
            h = h + gt @ packed["w_res_t"][l].T + packed["b_res"][l]
            gated.append(gt)
        z = torch.relu(torch.cat(gated, -1) @ packed["w_skip"]
                       + packed["skip_bias"])
        z = torch.relu(z @ packed["post1"] + packed["b1"])
        logits = z @ packed["post2_t"].T + packed["b2"]
        u = None
        if not deterministic:
            u = (noise[t] if noise is not None else
                 torch.rand(B, nr + 1, generator=generator, device=dev))
        x = _mol_sample(logits, deterministic, u)
        out[:, t] = x
        win = torch.cat([win[:, 1:], x[:, None]], dim=-1)
    return out


_PACKED_ORDER = ("w_tap", "w_res_t", "b_res", "front_t", "w_skip",
                 "skip_bias", "post1", "b1", "post2_t", "b2")


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound on first use."""
    fn = load_library("wavenet_gen").wavenet_gen_launch
    fn.argtypes = ([ctypes.c_void_p] * 16
                   + [ctypes.c_uint64, ctypes.c_int64] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
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
                     prime_len: int = 0) -> torch.Tensor:
    """Generate [B, T] samples for ``lc_proj [B, T, L*2D]``.

    On a CUDA tensor this launches ``csrc/wavenet_gen.cu`` (one block per
    stream) and counts the launch in ``wavenet_generate.launches``; on a CPU
    tensor it runs ``generate_plain``.  Stochastic mode takes its noise from
    ``noise [T, B, nr+1]`` if given, else from Philox seeded by
    ``generator``."""
    if not deterministic and noise is None and generator is None:
        raise ValueError("stochastic generation needs a generator or noise")
    if prime_len and primed is None:
        raise ValueError("prime_len > 0 needs the primed stream")
    dev = lc_proj.device
    if dev.type == "cpu":
        return generate_plain(packed, lc_proj, deterministic, generator,
                              noise, primed, prime_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")

    B, T, LD2 = lc_proj.shape
    L, two_d, two_r = packed["w_tap"].shape
    W = packed["front_t"].shape[1]
    S = packed["w_skip"].shape[1]
    C = packed["b2"].shape[0]
    if two_d != 64 or two_r != 64:
        raise ValueError("the CUDA kernel is laid out for R = D = 32")
    if LD2 != L * two_d or W > 32 or S % 4 or C % 3 or C > 96:
        raise ValueError(f"unsupported shapes: lc_proj {tuple(lc_proj.shape)}"
                         f", L={L}, W={W}, S={S}, C={C}")
    if not 0 <= prime_len <= T:
        raise ValueError(f"prime_len={prime_len} outside [0, {T}]")
    f32 = torch.float32
    _check("lc_proj", lc_proj, f32, dev)
    for k in _PACKED_ORDER:
        _check(k, packed[k], f32, dev)
    _check("dilations", packed["dilations"], torch.int32, dev, (L,))
    if primed is not None:
        _check("primed", primed, f32, dev, (T, B))
    if noise is not None:
        _check("noise", noise, f32, dev, (T, B, C // 3 + 1))

    dil = packed["dilations"]
    ring_stride = int(dil.sum().item()) * (two_r // 2)
    ring = torch.zeros(B, ring_stride, dtype=f32, device=dev)
    out = torch.empty(B, T, dtype=f32, device=dev)
    seed = 0
    if not deterministic and noise is None:
        seed = int(torch.randint(2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _launcher()(
        ptr(lc_proj), *(packed[k].data_ptr() for k in _PACKED_ORDER),
        dil.data_ptr(), ptr(primed), ptr(noise), ring.data_ptr(),
        out.data_ptr(), seed, ring_stride, B, T, L, W, S, C, int(prime_len),
        int(deterministic), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wavenet_gen kernel launch failed: CUDA error {rc}")
    wavenet_generate.launches += 1
    return out


wavenet_generate.launches = 0


def incremental_generate_cuda(cfg: WaveNetConfig, packed: Packed,
                              lc: torch.Tensor,
                              generator: Optional[torch.Generator] = None,
                              gc: Optional[torch.Tensor] = None,
                              seed_audio: Optional[torch.Tensor] = None,
                              deterministic: bool = False,
                              noise: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The JAX package's ``incremental_generate`` through the kernel (on
    CPU tensors, through its plain twin): upsampled ``lc [B, T, C_lc]`` ->
    [B, T], B streams in one launch.  ``seed_audio [B, T_seed, 1]``
    teacher-forces the first T_seed steps."""
    require_scalar_input(cfg)
    B, T, _ = lc.shape
    lc_proj = precompute_lc_proj(packed, lc, gc)
    primed, prime_len = None, 0
    if seed_audio is not None:
        prime_len = seed_audio.shape[1]
        if prime_len > T:
            raise ValueError(f"seed of {prime_len} samples exceeds T={T}")
        primed = torch.zeros(T, B, dtype=torch.float32, device=lc.device)
        primed[:prime_len] = seed_audio[:, :, 0].T
    return wavenet_generate(packed, lc_proj, deterministic, generator, noise,
                            primed, prime_len)


def generate_flops(packed: Packed, B: int, T: int) -> float:
    """Floating-point operations of one launch (multiply-adds count two):
    the front conv, per layer the [2R]x[2R,2D] tap and [D]x[D,R] residual
    products, the skip, post1 and post2 products."""
    L, two_d, two_r = packed["w_tap"].shape
    W = packed["front_t"].shape[1]
    S = packed["w_skip"].shape[1]
    C = packed["b2"].shape[0]
    D, R = two_d // 2, two_r // 2
    per = W * R + L * (two_r * two_d + D * R) + L * D * S + S * S + S * C
    return 2.0 * per * B * T


def generate_bytes(packed: Packed, B: int, T: int) -> float:
    """Bytes an unprimed launch must move: each input read once (lc
    projection, weights), the output written once."""
    weights = sum(packed[k].numel() * 4 for k in _PACKED_ORDER)
    lc = B * T * packed["w_tap"].shape[0] * packed["w_tap"].shape[1] * 4
    return float(weights + lc + B * T * 4)

