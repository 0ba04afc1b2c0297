"""Plain PyTorch WaveNet: the reference the benchmark judges the port by.

It follows the published architecture (hccho2/Tacotron-Wavenet-Vocoder-
Korean, after ibab/tensorflow-wavenet and r9y9/wavenet_vocoder): a
transposed-convolution upsampler of the mel, a causal front convolution,
gated dilated layers with a local-condition projection, residual and skip
outputs, two post layers and a discretized mixture-of-logistics head
(PixelCNN++'s likelihood).  It imports nothing of the program and runs in
float32 on whatever device its tensors are on; ``rnd`` rounds every
product's two inputs when a lower precision is asked for (the control).

Two alignments of the same network:

- ``causal=True``, serving: step ``t`` sees the samples before ``t`` and
  the local condition of ``t``; each layer's history starts at zero (the
  generation kernel's zeroed rings).
- ``causal=False``, training: the crop's convolutions are VALID, the input
  is ``audio[:-1]`` beside ``lc[:-1]``, and the outputs cover the last
  ``T - receptive_field`` positions, whose targets are ``audio[rf:]``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (its largest
    magnitude at 448, e4m3's largest finite value), as an fp8 path stores
    a tensor."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa (to nearest), for a CPU
    that has no TF32 products; the gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x.detach())


def receptive_field(w: dict) -> int:
    rf = (w["filter_width"] - 1) * sum(w["dilations"]) + 1
    return rf + (w["initial_filter_width"] if w["scalar_input"]
                 else w["filter_width"]) - 1


def upsample(mel: torch.Tensor, params: Params, w: dict,
             rnd: Round = identity) -> torch.Tensor:
    """[B, F, M] -> [B, F * prod(factors), M].  Each stage is a transposed
    convolution of stride ``(f, 1)`` and kernel ``(f, filter_width)``
    with SAME padding: output row ``m*f + r`` takes kernel row ``f-1-r``
    over input frame ``m``, across ``filter_width`` neighbouring mel
    channels (``ceil((fw-1)/2)`` of them below)."""
    x = mel
    fw = w["filter_width"]
    below = math.ceil((fw - 1) / 2)
    for i, f in enumerate(w["upsample_factor"]):
        k = params[f"upsampler/upsample_{i}/kernel"][:, :, 0, 0].flip(0)
        B, n, M = x.shape
        win = F.pad(x, (below, fw - 1 - below)).unfold(-1, fw, 1)
        x = torch.einsum("bfmj,rj->bfrm", rnd(win), rnd(k)).reshape(
            B, n * f, M)
    return x


def _conv(x: torch.Tensor, kernel: torch.Tensor, rnd: Round,
          dilation: int = 1) -> torch.Tensor:
    """NCW cross-correlation with a kernel stored [W, Cin, Cout]."""
    return F.conv1d(rnd(x), rnd(kernel.permute(2, 1, 0)), dilation=dilation)


def _dense(x: torch.Tensor, kernel: torch.Tensor, rnd: Round
           ) -> torch.Tensor:
    """[B, Cin, T] by a [Cin, Cout] kernel -> [B, Cout, T]."""
    return F.conv1d(rnd(x), rnd(kernel.t()[:, :, None]))


def forward(params: Params, w: dict, x: torch.Tensor, lc: torch.Tensor,
            causal: bool, rnd: Round = identity) -> torch.Tensor:
    """The network's outputs [B, T_out, C].

    ``x`` [B, T]: the input samples (causal: the sample before each step,
    0 at the first); ``lc`` [B, T, M] the upsampled local condition beside
    them.  Causal: T_out = T.  VALID: T_out = T + 1 - receptive_field, the
    outputs at the last T_out positions."""
    if not w["scalar_input"]:
        raise ValueError("the reference runs the scalar-input MoL head")
    D = w["dilation_channels"]
    bias = w["use_biases"]
    W = w["initial_filter_width"]
    lc = lc.transpose(1, 2)
    h = x[:, None, :]
    if causal:
        h = F.pad(h, (W - 1, 0))
    else:
        lc = lc[:, :, W - 1:]
    h = _conv(h, params["causal_kernel"], rnd)
    T_out = h.shape[-1] - (0 if causal else
                           (w["filter_width"] - 1) * sum(w["dilations"]))
    skip = None
    for i, d in enumerate(w["dilations"]):
        taps = torch.cat([params[f"layer_{i}_filter_kernel"],
                          params[f"layer_{i}_gate_kernel"]], 2)
        span = d * (w["filter_width"] - 1)
        z = _conv(F.pad(h, (span, 0)) if causal else h, taps, rnd, d)
        if not causal:
            lc = lc[:, :, span:]
        z = z + _dense(lc, torch.cat([params[f"layer_{i}_lc_filter"],
                                      params[f"layer_{i}_lc_gate"]], 1), rnd)
        if bias:
            z = z + torch.cat([params[f"layer_{i}_filter_bias"],
                               params[f"layer_{i}_gate_bias"]])[:, None]
        gated = torch.tanh(z[:, :D]) * torch.sigmoid(z[:, D:])
        s = _dense(gated[:, :, -T_out:], params[f"layer_{i}_skip_kernel"],
                   rnd)
        if bias:
            s = s + params[f"layer_{i}_skip_bias"][:, None]
        skip = s if skip is None else skip + s
        res = _dense(gated, params[f"layer_{i}_res_kernel"], rnd)
        if bias:
            res = res + params[f"layer_{i}_res_bias"][:, None]
        h = (h if causal else h[:, :, span:]) + res
    out = _dense(torch.relu(skip), params["post_1/kernel"], rnd)
    if bias:
        out = out + params["post_1/bias"][:, None]
    raw = _dense(torch.relu(out), params["post_2/kernel"], rnd)
    if bias:
        raw = raw + params["post_2/bias"][:, None]
    return raw.transpose(1, 2)


# ----------------------------------------------------------------------
# The mixture-of-logistics head
# ----------------------------------------------------------------------
LOG_SCALE_MIN = math.log(1e-14)


def mol_nll(raw: torch.Tensor, y: torch.Tensor, num_class: int = 65536
            ) -> torch.Tensor:
    """Per-position negative log-likelihood of targets ``y`` [...] in
    [-1, 1] under the discretized mixture ``raw`` [..., 3 * nr]
    (PixelCNN++'s, with its edge cases at +-0.999, the density's midpoint
    where a bin holds under 1e-5, and the 1e-12 floor)."""
    nr = raw.shape[-1] // 3
    logit = raw[..., :nr]
    mean = raw[..., nr:2 * nr]
    log_s = torch.clamp(raw[..., 2 * nr:], min=LOG_SCALE_MIN)
    y = y[..., None]
    centered = y - mean
    inv_s = torch.exp(-log_s)
    half = 1.0 / (num_class - 1)
    plus, minus = inv_s * (centered + half), inv_s * (centered - half)
    cdf_delta = torch.sigmoid(plus) - torch.sigmoid(minus)
    log_cdf_plus = plus - F.softplus(plus, threshold=1e9)
    log_one_minus_cdf_min = -F.softplus(minus, threshold=1e9)
    mid = inv_s * centered
    log_pdf_mid = mid - log_s - 2.0 * F.softplus(mid, threshold=1e9)
    inner = torch.where(cdf_delta > 1e-5,
                        torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid - math.log((num_class - 1) / 2))
    log_p = torch.where(y < -0.999, log_cdf_plus,
                        torch.where(y > 0.999, log_one_minus_cdf_min, inner))
    log_p = log_p + torch.log_softmax(logit, dim=-1)
    return -torch.logsumexp(log_p, dim=-1)


def greedy_gap(raw: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """Per step, how far a greedily served sample lies from the
    reference's greedy choice.  The greedy rule: the mean of the most
    probable component, clipped to [-1, 1]; components tied at the top
    share the weight (their means averaged), which rounding can make
    happen where the reference has a near-tie.  So each component, and
    each pair of components, is a candidate: its mean (the pair's average)
    clipped, and its logit distance below the best (a pair's larger one).
    The gap is the least, over candidates, of the larger of that distance
    and the candidate's distance from the served sample: 0 when the sample
    is the reference's own choice, small where rounding picked a near-tied
    component or moved a mean, large where nothing the reference would
    serve explains the sample.  ``raw`` [T, 3 * nr], ``served`` [T]."""
    nr = raw.shape[-1] // 3
    logit = raw[:, :nr]
    mean = raw[:, nr:2 * nr]
    below = logit.max(dim=-1, keepdim=True).values - logit
    a, b = torch.triu_indices(nr, nr, offset=1, device=raw.device)
    below = torch.cat([below, torch.maximum(below[:, a], below[:, b])], -1)
    mean = torch.cat([mean, (mean[:, a] + mean[:, b]) / 2], -1)
    off = (mean.clamp(-1.0, 1.0) - served[:, None]).abs()
    return torch.maximum(below, off).min(dim=-1).values


def greedy_pick(raw: torch.Tensor) -> torch.Tensor:
    """The greedy sample a network of outputs ``raw`` [T, 3 * nr] puts
    first: the clipped mean of its most probable component."""
    nr = raw.shape[-1] // 3
    top = raw[:, :nr].argmax(dim=-1, keepdim=True)
    return raw[:, nr:2 * nr].gather(-1, top)[:, 0].clamp(-1.0, 1.0)


# ----------------------------------------------------------------------
# Training: loss, gradient, Adam and the EMA
# ----------------------------------------------------------------------
def train_loss(params: Params, w: dict, audio: torch.Tensor,
               mel: torch.Tensor, rnd: Round = identity) -> torch.Tensor:
    """The mean NLL of a crop batch: ``audio`` [B, T], ``mel`` [B, T /
    hop, M]."""
    rf = receptive_field(w)
    lc = upsample(mel, params, w, rnd)
    raw = forward(params, w, audio[:, :-1], lc[:, :-1], causal=False,
                  rnd=rnd)
    return mol_nll(raw, audio[:, rf:]).mean()


def adam_steps(params: Params, w: dict,
               batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               rnd: Round = identity) -> dict:
    """Adam (eps outside the square root, bias-corrected, the learning
    rate ``lr * decay_rate ** (step / decay_steps)`` at steps 0, 1, ...)
    and the parameters' EMA over ``batches``.  Returns each step's loss,
    the first step's gradient, and the parameters and EMA after the
    last."""
    p = {k: v.detach().clone() for k, v in params.items()}
    ema = {k: v.clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[float] = []
    first: Optional[Params] = None
    decay = w["ema_decay"]
    for step, (audio, mel) in enumerate(batches):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        loss = train_loss(leaves, w, audio, mel, rnd)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        g = {k: torch.zeros_like(v) if gr is None else gr
             for (k, v), gr in zip(p.items(), grads)}
        losses.append(float(loss.detach()))
        if first is None:
            first = g
        lr = w["learning_rate"] * w["decay_rate"] ** (step / w["decay_steps"])
        n = step + 1
        for k in p:
            mu[k] = (1 - b1) * g[k] + b1 * mu[k]
            nu[k] = (1 - b2) * g[k] * g[k] + b2 * nu[k]
            m_hat = mu[k] / (1 - b1 ** n)
            v_hat = nu[k] / (1 - b2 ** n)
            p[k] = p[k] - lr * m_hat / (torch.sqrt(v_hat) + eps)
            ema[k] = (1 - decay) * p[k] + decay * ema[k]
    return {"losses": losses, "first_grad": first, "params": p, "ema": ema}
