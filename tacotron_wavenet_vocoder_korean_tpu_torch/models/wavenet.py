"""WaveNet: the training graph and its losses, weight-norm folding and the
mel ``Upsampler``.

Counterpart of the JAX package's ``models/wavenet.py`` (``WaveNet``,
``wavenet_loss``, ``optax_softmax_ce``, ``wn_weight``,
``materialize_wn_params``, ``Upsampler``).  The sampler itself lives in
``ops/wavenet_gen.py``: the generation kernel's wrapper and its plain
twin ``generate_plain``, which is the CPU path and the reference the kernel
is held against.

Parameters are a flat dict of tensors keyed by the JAX package's flat
names, nested flax names joined by ``/`` (``post_1/kernel``,
``upsampler/upsample_0/kernel``); ``convert.py`` builds it.  Serving reads
the folded layout; training keeps weight-norm pairs (``<name>_v`` /
``<name>_g``, and flat ``post_N_kernel`` / ``post_N_bias``) as the JAX
training tree holds them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WaveNetConfig
from ..parallel.mesh import (MODEL_AXIS, Mesh, all_reduce_sum, copy_to_model,
                             reduce_from_model)
from .mixture import discretized_mix_logistic_loss

Params = Dict[str, torch.Tensor]


def wn_weight(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight normalization: w = g * v / ||v||, the norm reduced over every
    axis but the last (output features)."""
    norm = torch.sqrt(torch.sum(torch.square(v), dim=tuple(range(v.ndim - 1)),
                                keepdim=True) + 1e-12)
    return v * (g / norm)


def _wn_fold(v, g) -> np.ndarray:
    return wn_weight(torch.as_tensor(np.asarray(v, np.float32)),
                     torch.as_tensor(np.asarray(g, np.float32))).numpy()


def materialize_wn_params(cfg: WaveNetConfig, params: dict) -> dict:
    """Fold ``<name>_v`` / ``<name>_g`` pairs of a weight-normalized tree
    into ``<name>`` and restore the nested ``post_N`` layout.  No-op when
    ``cfg.weight_normalization`` is off."""
    if not cfg.weight_normalization:
        return params
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = v
        elif k.endswith("_v"):
            out[k[:-2]] = _wn_fold(v, params[k[:-2] + "_g"])
        elif not k.endswith("_g"):
            out[k] = v
    for p in ("post_1", "post_2"):
        if p + "_kernel" in out:
            sub = {"kernel": out.pop(p + "_kernel")}
            if p + "_bias" in out:
                sub["bias"] = out.pop(p + "_bias")
            out[p] = sub
    return out


def _conv_transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """Before/after padding of a SAME transposed convolution, as
    ``lax.conv_transpose`` computes it (asymmetric for even kernels)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class Upsampler(torch.nn.Module):
    """mel (frame rate) -> sample-rate local condition: stacked transposed
    convolutions, kernel (factor, filter_width), stride (factor, 1), SAME
    padding, no bias, one input and one output channel.

    Written out by hand: the input is dilated by the stride, padded as
    ``lax.conv_transpose`` pads it, and cross-correlated with the kernel as
    it is stored (flax does not flip it; ``conv_transpose2d`` would)."""

    def __init__(self, cfg: WaveNetConfig):
        super().__init__()
        self.factors = tuple(cfg.upsample_factor)
        self.kernels = torch.nn.ParameterList(
            torch.nn.Parameter(torch.zeros(f, cfg.filter_width),
                               requires_grad=False)
            for f in self.factors)

    def load_params(self, params: Params) -> "Upsampler":
        """Take ``upsampler/upsample_i/kernel`` [factor, fw, 1, 1]."""
        for i, k in enumerate(self.kernels):
            k.data.copy_(params[f"upsampler/upsample_{i}/kernel"][:, :, 0, 0])
        return self

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, frames, num_mels] -> [B, frames*hop, num_mels]."""
        return upsample(mel, self.kernels, self.factors)


def upsample(mel: torch.Tensor, kernels: Sequence[torch.Tensor],
             factors: Sequence[int]) -> torch.Tensor:
    """The ``Upsampler``'s transposed convolutions with the kernels given
    ([factor, filter_width] each), differentiable in them."""
    x = mel[:, None]                                      # [B, 1, F, M]
    for f, k in zip(factors, kernels):
        B, _, H, W = x.shape
        kh, kw = k.shape
        dil = x.new_zeros(B, 1, (H - 1) * f + 1, W)
        dil[:, :, ::f] = x
        ph = _conv_transpose_padding(kh, f)
        pw = _conv_transpose_padding(kw, 1)
        x = F.conv2d(F.pad(dil, (pw[0], pw[1], ph[0], ph[1])),
                     k[None, None].to(x.dtype))
    return x[:, 0]


def _matrix(w: torch.Tensor) -> torch.Tensor:
    """A [Cin, Cout] matrix as a width-1 ``conv1d`` weight [Cout, Cin, 1]."""
    return w.t()[:, :, None]


class WaveNet(torch.nn.Module):
    """The training graph: one teacher-forced pass over a crop (JAX
    ``WaveNet.__call__``), called with the parameters as JAX's ``apply``
    is: ``model(params, audio, mel, speaker_id)``.

    The stack runs in NCW: each VALID dilated convolution is ``F.conv1d``
    with the JAX kernel [W, Cin, Cout] read as [Cout, Cin, W] (both are
    cross-correlations).  The local condition is aligned to the input as in
    JAX: ``lc_full[:, :-1]``, then ``[width-1:]`` after the front conv and
    ``[d:]`` at each layer.  The filter and gate convolutions of a layer
    run as one, and the 50 skip projections as one product of the
    concatenated layer outputs with the stacked skip kernels.

    ``compute_dtype='bfloat16'``: weights, ``lc``, ``gc`` and biases are
    cast to bf16 and every product and sum of the stack and post layers is
    rounded to bf16 as JAX rounds it; parameters, targets and the loss stay
    f32.  Where PyTorch rounds otherwise: a bf16 convolution or product
    accumulates in f32 and rounds once (XLA on a CPU may round partial
    sums), and the skip sum is one bf16 product with f32 accumulation
    where JAX adds 50 bf16 terms one by one.

    With a ``mesh`` of ``n_model`` > 1 the skip/post stack is tensor
    parallel, as the JAX task's ``WAVENET_TP_RULES`` place it: ``params``
    holds this rank's ``S / n_model`` columns of every
    ``layer_i_skip_kernel`` (and ``_bias``) and rows of ``post_1``'s
    kernel.  The layer outputs enter through ``copy_to_model``, the relu
    runs on the local skip channels, and ``post_1``'s partial products
    are summed by ``reduce_from_model`` in float32 before the bias and
    the cast to the compute type.  Weight norm: a split skip kernel's
    column norms stay local and take their slice of the replicated
    ``_g``; ``post_1``'s norm runs over the split rows, so its sum of
    squares is summed over the model group.  A replicated leaf used in
    the split part enters through ``copy_to_model``, so its gradient is
    whole on every rank.  Everything else is replicated and computed on
    every rank.
    """

    def __init__(self, cfg: WaveNetConfig, mesh: Optional[Mesh] = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.n_model > 1 else None
        if self.mesh and cfg.skip_channels % self.mesh.n_model:
            raise ValueError(f"skip_channels={cfg.skip_channels} does not "
                             f"split over {self.mesh.n_model} model ranks")

    def _weight(self, params: Params, name: str, dt: torch.dtype
                ) -> torch.Tensor:
        if not self.cfg.weight_normalization:
            return params[name].to(dt)
        v, g = params[name + "_v"], params[name + "_g"]
        mesh = self.mesh
        if mesh is None:
            return wn_weight(v, g).to(dt)
        if name == "post_1_kernel":               # rows split
            sq = torch.sum(torch.square(v), dim=0, keepdim=True)
            norm = torch.sqrt(all_reduce_sum(sq, mesh, MODEL_AXIS) + 1e-12)
            return (v * (copy_to_model(g, mesh) / norm)).to(dt)
        if v.shape[-1] < g.shape[-1]:             # columns split
            n, m = v.shape[-1], mesh.index(MODEL_AXIS)
            g = copy_to_model(g, mesh)[m * n:(m + 1) * n]
        return wn_weight(v, g).to(dt)

    def forward(self, params: Params, audio: torch.Tensor, mel: torch.Tensor,
                speaker_id: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """audio [B, T, 1] in [-1, 1] (class ids for ``mulaw-quantize``);
        mel [B, T // hop, num_mels].  Returns ``raw_output`` [B, T - rf, C]
        (in the parameters' dtype), ``target`` ([B, T - rf, 1] samples or [B, T - rf] class
        ids) and ``local_condition`` [B, T, num_mels]."""
        cfg = self.cfg
        rf = cfg.receptive_field
        # float32 parameters compute in float32 (float64 ones, as a test's
        # reference, in float64) unless the config asks for bf16.
        pdt = params["causal_kernel" if "causal_kernel" in params
                     else "causal_kernel_v"].dtype
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else pdt
        w = lambda name: self._weight(params, name, dt)
        D = cfg.dilation_channels

        lc_full = upsample(mel, [
            params[f"upsampler/upsample_{i}/kernel"][:, :, 0, 0]
            for i in range(len(cfg.upsample_factor))], cfg.upsample_factor)

        gc = None
        if cfg.num_speakers > 1 and speaker_id is not None:
            gc = params["gc_embedding"][speaker_id].to(dt)          # [B, G]

        if cfg.scalar_input:
            x = audio[:, :-1, :].to(dt)
            target = audio[:, rf:, :]
        else:
            # The batch holds mu-law class ids as floats: one-hot them.
            ids = torch.round(audio[..., 0]).long()
            x = F.one_hot(ids[:, :-1], cfg.quantization_channels).to(dt)
            target = ids[:, rf:]
        x = x.transpose(1, 2)                                        # NCW
        lc = lc_full[:, :-1, :].to(dt).transpose(1, 2)

        width = (cfg.initial_filter_width if cfg.scalar_input
                 else cfg.filter_width)
        h = F.conv1d(x, w("causal_kernel").permute(2, 1, 0))
        lc = lc[:, :, width - 1:]

        output_width = audio.shape[1] - rf
        outs = []
        for i, d in enumerate(cfg.dilations):
            z = F.conv1d(h, torch.cat([w(f"layer_{i}_filter_kernel"),
                                       w(f"layer_{i}_gate_kernel")],
                                      2).permute(2, 1, 0), dilation=d)
            if cfg.use_biases:
                z = z + torch.cat([params[f"layer_{i}_filter_bias"],
                                   params[f"layer_{i}_gate_bias"]]
                                  ).to(dt)[:, None]
            lc = lc[:, :, d:]                                 # input-aligned
            z = z + F.conv1d(lc, _matrix(torch.cat(
                [w(f"layer_{i}_lc_filter"), w(f"layer_{i}_lc_gate")], 1)))
            if gc is not None:
                z = z + (gc @ torch.cat([w(f"layer_{i}_gc_filter"),
                                         w(f"layer_{i}_gc_gate")], 1)
                         )[:, :, None]
            out = torch.tanh(z[:, :D]) * torch.sigmoid(z[:, D:])
            outs.append(out[:, :, -output_width:])
            res = F.conv1d(out, _matrix(w(f"layer_{i}_res_kernel")))
            if cfg.use_biases:
                res = res + params[f"layer_{i}_res_bias"].to(dt)[:, None]
            h = h[:, :, d:] + res                                # residual

        n = len(cfg.dilations)
        w_skip = torch.cat([w(f"layer_{i}_skip_kernel") for i in range(n)])
        outs = torch.cat(outs, 1)
        if self.mesh is not None:
            outs = copy_to_model(outs, self.mesh)
        skip = torch.matmul(w_skip.t(), outs)            # [B, S_local, ow]
        if cfg.use_biases:
            skip = skip + torch.stack([params[f"layer_{i}_skip_bias"]
                                       for i in range(n)]).sum(0).to(dt)[:, None]
        skip = torch.relu(skip).transpose(1, 2)                # [B, ow, S]

        if cfg.weight_normalization:
            names = [("post_1_kernel", "post_1_bias"),
                     ("post_2_kernel", "post_2_bias")]
        else:
            names = [("post_1/kernel", "post_1/bias"),
                     ("post_2/kernel", "post_2/bias")]
        k1, b1 = names[0]
        if self.mesh is None:
            out = skip @ w(k1)
        else:
            acc = torch.float32 if dt == torch.bfloat16 else dt
            out = reduce_from_model(skip.to(acc) @ w(k1).to(acc),
                                    self.mesh).to(dt)
        if cfg.use_biases:
            out = out + params[b1].to(dt)
        k2, b2 = names[1]
        raw = torch.relu(out) @ w(k2)
        if cfg.use_biases:
            raw = raw + params[b2].to(dt)
        return {"raw_output": raw.to(pdt), "target": target,
                "local_condition": lc_full}


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of class ids under softmax logits, per position."""
    return -torch.gather(torch.log_softmax(logits, -1), -1,
                         labels[..., None])[..., 0]


def wavenet_loss(cfg: WaveNetConfig, outputs: Dict[str, torch.Tensor],
                 params: Optional[Params] = None, sharded: Sequence[str] = (),
                 mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """Mean discretized-MoL NLL (scalar input, 65,536 bins) or mean softmax
    cross-entropy (``mulaw-quantize``), plus, when
    ``l2_regularization_strength`` > 0 and ``params`` are given, that times
    the sum of ``p**2 / 2`` over every parameter whose name lacks
    ``"bias"``.  Returns ``loss`` (the total) and, with L2, ``l2_loss``.
    The leaves named in ``sharded`` are this rank's slices: their sum is
    summed over ``mesh``'s model group, the replicated ones counted
    once."""
    raw, target = outputs["raw_output"], outputs["target"]
    if cfg.scalar_input:
        loss = torch.mean(discretized_mix_logistic_loss(
            raw, target, num_class=2 ** 16, reduce=False))
    else:
        loss = torch.mean(softmax_ce(raw, target))
    metrics = {"loss": loss}
    if params is not None and cfg.l2_regularization_strength > 0:
        l2 = sum(torch.sum(p ** 2) / 2 for name, p in params.items()
                 if "bias" not in name and name not in sharded)
        if sharded:
            l2 = l2 + reduce_from_model(sum(
                torch.sum(params[name] ** 2) / 2 for name in sharded
                if "bias" not in name), mesh)
        metrics["l2_loss"] = l2
        metrics["loss"] = loss + cfg.l2_regularization_strength * l2
    return metrics
