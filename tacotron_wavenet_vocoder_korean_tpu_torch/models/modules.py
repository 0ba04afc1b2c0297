"""Tacotron building blocks: prenet, highway, batch-normed conv1d, the
fused GRU, CBHG (counterpart of the JAX package's ``models/modules.py``).

Sequences are [B, T, C], as in the JAX package; CBHG's convolutions run on
torch's [B, C, T] and transpose back.  Parameters are float32 in torch's
layout (``convert.py`` maps the flax names onto them).  A module built with
``dtype=torch.bfloat16`` casts its parameters and its input to bf16 on each
call, as flax's ``dtype=`` does (mixed precision); with ``dtype=None`` it
computes in float32, as flax promotes a bf16 input to float32 parameters.

Only the fused GRU layout is ported (one [3H, D] input product, one
[3H, H] recurrent product per step, gate blocks ordered r, z, n); a tree of
flax ``GRUCell``s is fused by ``convert.fuse_gru_params`` first.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Dtype = Optional[torch.dtype]


def compute_dtype(dtype: Dtype) -> torch.dtype:
    return torch.float32 if dtype is None else dtype


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Dtype = None
          ) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias in the compute
    type, the product, then the bias added."""
    dt = compute_dtype(dtype)
    y = x.to(dt) @ layer.weight.to(dt).t()
    if layer.bias is not None:
        y = y + layer.bias.to(dt)
    return y


def gru_step(h: torch.Tensor, xp: torch.Tensor, w_hh: torch.Tensor,
             b_hn: torch.Tensor) -> torch.Tensor:
    """One GRU step from the input projection ``xp = x W_ih^T + b_ih``:
    flax ``GRUCell``'s math with ``b_hn`` inside ``r * (W_hn h + b_hn)``."""
    hr, hz, hn = (h @ w_hh.t()).chunk(3, dim=-1)
    xr, xz, xn = xp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * (hn + b_hn))
    return (1.0 - z) * n + z * h


class _FusedGRUParams(nn.Module):
    """``w_ih`` [3H, D], ``w_hh`` [3H, H], ``b_ih`` [3H], ``b_hn`` [H]."""

    def __init__(self, in_dim: int, units: int, dtype: Dtype = None):
        super().__init__()
        self.units = units
        self.dtype = dtype
        self.w_ih = nn.Parameter(torch.empty(3 * units, in_dim))
        self.w_hh = nn.Parameter(torch.empty(3 * units, units))
        self.b_ih = nn.Parameter(torch.zeros(3 * units))
        self.b_hn = nn.Parameter(torch.zeros(units))
        nn.init.xavier_uniform_(self.w_ih)
        nn.init.orthogonal_(self.w_hh)

    def _weights(self):
        dt = compute_dtype(self.dtype)
        return (self.w_ih.to(dt), self.w_hh.to(dt), self.b_ih.to(dt),
                self.b_hn.to(dt))


class FusedGRUCell(_FusedGRUParams):
    """One step: ``(h, x) -> h'`` (the new state is also the output)."""

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        w_ih, w_hh, b_ih, b_hn = self._weights()
        dt = w_ih.dtype
        return gru_step(h.to(dt), x.to(dt) @ w_ih.t() + b_ih, w_hh, b_hn)


def flip_sequences(x: torch.Tensor, lengths: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """Reverse each row of [B, T, ...] within its length, as flax's
    ``flip_sequences`` does: out[t] = x[(T - 1 - t + len) % T], so the
    valid part is reversed in place and the padding behind it is reversed
    too.  An involution; without lengths, a plain flip."""
    if lengths is None:
        return x.flip(1)
    T = x.shape[1]
    rev = torch.arange(T - 1, -1, -1, device=x.device)
    idx = (rev[None, :] + lengths.to(x.device)[:, None]) % T
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


class GRU(_FusedGRUParams):
    """Unidirectional GRU over [B, T, D]: the input projection is one
    product over the whole sequence, then one [H, 3H] product per step.

    Like the JAX fused GRU, the forward direction runs through padded steps
    unmasked; with ``reverse=True`` the sequence is flipped within
    ``seq_lengths`` (padding stays behind), and the outputs flipped back."""

    def __init__(self, in_dim: int, units: int, reverse: bool = False,
                 dtype: Dtype = None):
        super().__init__(in_dim, units, dtype)
        self.reverse = reverse

    def forward(self, x: torch.Tensor,
                seq_lengths: Optional[torch.Tensor] = None,
                initial_state: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        w_ih, w_hh, b_ih, b_hn = self._weights()
        xp = x.to(w_ih.dtype) @ w_ih.t() + b_ih
        if self.reverse:
            xp = flip_sequences(xp, seq_lengths)
        if initial_state is None:
            h = xp.new_zeros(x.shape[0], self.units)
        else:
            h = initial_state.to(xp.dtype)
        ys = []
        for t in range(xp.shape[1]):
            h = gru_step(h, xp[:, t], w_hh, b_hn)
            ys.append(h)
        ys = torch.stack(ys, dim=1)
        if self.reverse:
            ys = flip_sequences(ys, seq_lengths)
        return ys


class Prenet(nn.Module):
    """Dense + relu (+ dropout) stack, layers ``dense_1``, ``dense_2``, ...

    Dropout is applied only where the caller passes ``scales``: one tensor
    per layer broadcastable to its output, 0 where a unit is dropped and
    1 / keep_prob where it is kept (see :meth:`scales_from_masks`), the
    values flax's ``Dropout`` multiplies by."""

    def __init__(self, in_dim: int, layer_sizes: Sequence[int],
                 dropout_rate: float = 0.5, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.keep_prob = 1.0 - dropout_rate
        self.sizes = tuple(layer_sizes)
        for i, size in enumerate(self.sizes):
            self.add_module(f"dense_{i + 1}", nn.Linear(in_dim, size))
            in_dim = size

    @property
    def layers(self) -> List[nn.Linear]:
        return [getattr(self, f"dense_{i + 1}") for i in range(len(self.sizes))]

    def scales_from_masks(self, masks: Sequence[torch.Tensor]
                          ) -> List[torch.Tensor]:
        """Keep-masks (bool, one per layer) -> the multipliers ``forward``
        takes, in the compute type: x / keep_prob where kept, else 0."""
        dt = compute_dtype(self.dtype)
        return [m.to(dt) / self.keep_prob for m in masks]

    def draw_masks(self, shape: Sequence[int], generator: torch.Generator,
                   device: torch.device) -> List[torch.Tensor]:
        """One keep-mask per layer, [*shape, size], each unit kept with
        probability keep_prob, from ``generator``."""
        return [torch.rand((*shape, size), generator=generator,
                           device=device) < self.keep_prob
                for size in self.sizes]

    def forward(self, x: torch.Tensor,
                scales: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = F.relu(dense(layer, x, self.dtype))
            if scales is not None:
                x = x * scales[i]
        return x


class HighwayLayer(nn.Module):
    """H * T + x * (1 - T), H = relu(Dense), T = sigmoid(Dense)."""

    def __init__(self, dim: int, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.H = nn.Linear(dim, dim)
        self.T = nn.Linear(dim, dim)
        nn.init.constant_(self.T.bias, -1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(dense(self.H, x, self.dtype))
        t = torch.sigmoid(dense(self.T, x, self.dtype))
        return h * t + x.to(t.dtype) * (1.0 - t)


class BatchNormConv1d(nn.Module):
    """SAME conv1d -> activation -> batch norm from its running statistics
    (inference), on [B, C, T].  SAME pads (k-1)//2 on the left and k//2 on
    the right, as flax does (asymmetric for even k).  The norm is computed
    in float32 as flax's is (x - mean, times rsqrt(var + eps) * scale, plus
    bias) and rounded to the compute type.  flax's momentum 0.99 is
    torch's 0.01; eps is 1e-5 in both."""

    def __init__(self, in_dim: int, channels: int, kernel_size: int,
                 activation: Optional[str] = None, dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.kernel_size = kernel_size
        self.activation = activation
        self.conv = nn.Conv1d(in_dim, channels, kernel_size)
        self.bn = nn.BatchNorm1d(channels, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype)
        k = self.kernel_size
        y = F.conv1d(F.pad(x.to(dt), ((k - 1) // 2, k // 2)),
                     self.conv.weight.to(dt))
        y = y + self.conv.bias.to(dt)[:, None]
        if self.activation == "relu":
            y = F.relu(y)
        bn = self.bn
        mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        y = (y.float() - bn.running_mean[:, None]) * mul[:, None]
        return (y + bn.bias[:, None]).to(dt)


class CBHG(nn.Module):
    """Conv bank (k = 1..K) -> maxpool -> projections -> residual (+ the
    speaker's ``before_highway``) -> [``highway_in_proj`` when the width is
    not ``rnn_size``] -> highway -> bi-GRU (``rnn_init_state`` split into
    the forward and backward halves).  [B, T, C] -> [B, T, 2 * rnn_size]."""

    def __init__(self, in_dim: int, bank_size: int, bank_channel_size: int,
                 maxpool_width: int, highway_depth: int, rnn_size: int,
                 proj_sizes: Sequence[int], proj_width: int,
                 dtype: Dtype = None):
        super().__init__()
        self.dtype = dtype
        self.bank_size = bank_size
        self.maxpool_width = maxpool_width
        self.highway_depth = highway_depth
        self.n_proj = len(proj_sizes)
        for k in range(1, bank_size + 1):
            self.add_module(f"conv1d_bank_{k}", BatchNormConv1d(
                in_dim, bank_channel_size, k, "relu", dtype))
        width = bank_size * bank_channel_size
        for idx, size in enumerate(proj_sizes):
            act = None if idx == len(proj_sizes) - 1 else "relu"
            self.add_module(f"proj_{idx + 1}", BatchNormConv1d(
                width, size, proj_width, act, dtype))
            width = size
        self.highway_in_proj = (nn.Linear(width, rnn_size)
                                if width != rnn_size else None)
        for i in range(highway_depth):
            self.add_module(f"highway_{i + 1}", HighwayLayer(rnn_size, dtype))
        self.gru_fw = GRU(rnn_size, rnn_size, dtype=dtype)
        self.gru_bw = GRU(rnn_size, rnn_size, reverse=True, dtype=dtype)

    def forward(self, inputs: torch.Tensor,
                input_lengths: Optional[torch.Tensor] = None,
                before_highway: Optional[torch.Tensor] = None,
                rnn_init_state: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        x = inputs.transpose(1, 2)                        # [B, C, T]
        bank = torch.cat([getattr(self, f"conv1d_bank_{k}")(x)
                          for k in range(1, self.bank_size + 1)], dim=1)
        # Max pooling, stride 1, right-padded with -inf.
        w = self.maxpool_width
        proj = F.max_pool1d(F.pad(bank, (0, w - 1), value=float("-inf")),
                            kernel_size=w, stride=1)
        for idx in range(self.n_proj):
            proj = getattr(self, f"proj_{idx + 1}")(proj)
        proj = proj.transpose(1, 2)                       # [B, T, C]

        highway_input = proj + inputs
        if before_highway is not None:
            highway_input = highway_input + before_highway[:, None, :].to(
                proj.dtype)
        if self.highway_in_proj is not None:
            highway_input = dense(self.highway_in_proj, highway_input,
                                  self.dtype)
        for i in range(self.highway_depth):
            highway_input = getattr(self, f"highway_{i + 1}")(highway_input)

        init_fw = init_bw = None
        if rnn_init_state is not None:
            init_fw, init_bw = rnn_init_state.chunk(2, dim=-1)
        out_fw = self.gru_fw(highway_input, input_lengths, init_fw)
        out_bw = self.gru_bw(highway_input, input_lengths, init_bw)
        return torch.cat([out_fw, out_bw], dim=-1)
