"""WaveNet generation kernel: packing, lc projection, the CUDA kernel's
wrapper and its plain PyTorch twin.

Counterpart of the JAX package's ``ops/wavenet_pallas.py``
(``pack_params``, ``precompute_lc_proj``, ``pallas_generate``,
``pallas_incremental_generate``).  The kernel, ``csrc/wavenet_gen.cu``,
replaces the Pallas kernel ``pallas_generate`` with both of its sampling
heads (mixture of logistics for scalar input, 256-way softmax for
``mulaw-quantize``) and both weight types (f32, bf16); it computes the same
function on an unfused packed layout of its own:

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
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Optional

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


def kernel_variant(packed: Packed) -> str:
    """The kernel variant a packed layout runs: its head and weight type,
    e.g. ``"softmax-bf16"``."""
    head = "softmax" if "front_oh" in packed else "mol"
    return f"{head}-{str(packed['w_tap'].dtype).replace('torch.', '')}"


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


def _limits_error(R: int, D: int, W: int, S: int, C: int,
                  quantized: bool) -> Optional[str]:
    """Why the CUDA kernel cannot run these widths, or None when it can."""
    if R != 32 or D != 32:
        return (f"the CUDA kernel is laid out for R = D = 32 channels, got "
                f"R={R}, D={D}")
    if W > 32:
        return f"the CUDA kernel takes up to 32 front taps, got W={W}"
    if S % 8 or S > 4096:
        return (f"the CUDA kernel takes S <= 4096 skip channels, a multiple "
                f"of 8, got S={S}")
    if quantized and C > 256:
        return f"the softmax head takes up to 256 classes, got {C}"
    if not quantized and (C % 3 or C > 96):
        return f"the MoL head takes 3 * nr_mix <= 96 channels, got {C}"
    return None


def kernel_limits_error(cfg: WaveNetConfig) -> Optional[str]:
    """Why the CUDA kernel cannot run ``cfg``'s widths (the message names
    the limit), or None when it can.  The kernel takes R = D = 32, at most
    32 front taps, S <= 4096 skip channels (a multiple of 8), a MoL head of
    up to 96 channels and a softmax head of up to 256 classes; the plain
    twin takes any width."""
    scalar = cfg.scalar_input
    return _limits_error(
        cfg.residual_channels, cfg.dilation_channels,
        cfg.initial_filter_width if scalar else cfg.filter_width,
        cfg.skip_channels,
        cfg.out_channels if scalar else cfg.quantization_channels,
        not scalar)


_PACKED_ORDER = ("w_tap", "w_res_t", "b_res", "front", "w_skip",
                 "skip_bias", "post1", "b1", "post2_t", "b2")


@functools.cache
def _launcher():
    """The kernel's C entry point, built and bound on first use."""
    fn = load_library("wavenet_gen").wavenet_gen_launch
    fn.argtypes = ([ctypes.c_void_p] * 16
                   + [ctypes.c_uint64, ctypes.c_int64] + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
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
    stream) and counts the launch in ``wavenet_generate.launches`` and, by
    ``kernel_variant``, in ``wavenet_generate.variant_launches``; on a CPU
    tensor it runs ``generate_plain``.  Stochastic mode takes its noise from
    ``noise`` if given, else from Philox seeded by ``generator``.
    ``temperature`` scales the softmax head's scores; the MoL head takes
    only 1.0."""
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
    S = packed["w_skip"].shape[1]
    C = packed["b2"].shape[0]
    wdt = packed["w_tap"].dtype
    if quantized:
        front = packed["front_oh"]
        W = front.shape[0]
        front_shape, n_noise = (W, C, two_r // 2), C
    else:
        front = packed["front_t"]
        W = front.shape[1]
        front_shape, n_noise = (two_r // 2, W), C // 3 + 1
    error = _limits_error(two_r // 2, two_d // 2, W, S, C, quantized)
    if error is not None:
        raise ValueError(error)
    if LD2 != L * two_d:
        raise ValueError(f"lc_proj {tuple(lc_proj.shape)} does not match "
                         f"L={L} layers of 2D={two_d}")
    if wdt not in WEIGHT_DTYPES:
        raise TypeError(f"weights have dtype {wdt}, expected one of "
                        f"{WEIGHT_DTYPES}")
    if not 0 <= prime_len <= T:
        raise ValueError(f"prime_len={prime_len} outside [0, {T}]")
    f32 = torch.float32
    _check("lc_proj", lc_proj, f32, dev)
    args = dict(packed, front=front)
    for k in _PACKED_ORDER:
        _check(k, args[k], wdt if k in WEIGHTS + ("front",) else f32, dev,
               front_shape if k == "front" else None)
    _check("dilations", packed["dilations"], torch.int32, dev, (L,))
    if primed is not None:
        _check("primed", primed, f32, dev, (T, B))
    if noise is not None:
        _check("noise", noise, f32, dev, (T, B, n_noise))

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
        ptr(lc_proj), *(args[k].data_ptr() for k in _PACKED_ORDER),
        dil.data_ptr(), ptr(primed), ptr(noise), ring.data_ptr(),
        out.data_ptr(), seed, ring_stride, B, T, L, W, S, C, int(prime_len),
        int(deterministic), int(quantized), int(wdt == torch.bfloat16),
        float(temperature), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wavenet_gen kernel launch failed: CUDA error {rc}")
    wavenet_generate.launches += 1
    wavenet_generate.variant_launches[kernel_variant(packed)] += 1
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
