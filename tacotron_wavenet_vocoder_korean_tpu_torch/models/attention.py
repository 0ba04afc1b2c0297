"""Attention for the Tacotron decoder (counterpart of the JAX package's
``models/attention.py``): the nine mechanisms of its ``attention_type``
table.

  * ``bah`` / ``bah_norm``          Bahdanau additive, plain or
                                    weight-normalised
  * ``bah_mon`` / ``bah_mon_norm``  Bahdanau monotonic (Raffel et al. 2017,
                                    parallel mode)
  * ``bah_mon_norm_hccho``          monotonic with a learned alignment bias,
                                    relu and renormalisation
  * ``loc_sen``                     location-sensitive, cumulative state
  * ``gmm``                         Graves GMM windows, kappa as the state
  * ``luong`` / ``luong_scaled``    multiplicative

Each class and parameter carries the flax name (the converter maps the
decoder's ``attention`` to ``{class name}_0``).  A mechanism takes
``(query, state, keys, mask, consts)`` and returns ``(alignments,
next_state)``; ``keys`` are the memory layer's projection of the encoder
outputs, computed once per utterance, and ``consts`` is what
``loop_constants(keys)`` hoisted out of the decoder loop.  The math is
float32 whatever the model's compute type: the query arrives in the
compute type and is promoted, as flax promotes a bf16 input to float32
parameters.  ``init_state(batch, t, device)`` is the state before the
first step.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .modules import dense

NEG_INF = -1e9


def safe_cumprod_exclusive(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Numerically stable exclusive cumprod:
    exp(exclusive cumsum(log(clip(x, 1e-10, 1))))."""
    logs = torch.log(x.clamp(1e-10, 1.0))
    csum = torch.cumsum(logs, dim=dim)
    return torch.exp(csum - logs)


def monotonic_attention_parallel(p_choose: torch.Tensor,
                                 previous: torch.Tensor) -> torch.Tensor:
    """Expected monotonic attention, parallel mode:
    a_i = p_i * cumprod_{j<i}(1 - p_j) *
          cumsum_i(previous_i / clip(cumprod_{j<i}(1 - p_j)))."""
    cp = safe_cumprod_exclusive(1.0 - p_choose, dim=-1)
    return p_choose * cp * torch.cumsum(previous / cp.clamp(1e-10, 1.0),
                                        dim=-1)


def _glorot_column(units: int) -> nn.Parameter:
    p = nn.Parameter(torch.empty(units, 1))
    nn.init.xavier_uniform_(p)
    return p


def _zero_state(batch: int, t: int, device=None) -> torch.Tensor:
    return torch.zeros(batch, t, device=device)


class BahdanauAttention(nn.Module):
    """``bah`` / ``bah_norm``: additive score ``v . tanh(keys + W_q q)``
    (the query layer has no bias), or with ``normalize`` the
    weight-normalised ``g v / ||v|| . tanh(keys + W_q q + b)``; masked
    positions set to -1e9, then a softmax.  The state is the alignments,
    zeros to start."""

    def __init__(self, query_dim: int, num_units: int,
                 normalize: bool = False):
        super().__init__()
        self.normalize = normalize
        self.query_layer = nn.Linear(query_dim, num_units, bias=False)
        self.attention_v = _glorot_column(num_units)
        if normalize:
            self.attention_g = nn.Parameter(
                torch.tensor(math.sqrt(1.0 / num_units)))
            self.attention_b = nn.Parameter(torch.zeros(num_units))

    init_state = staticmethod(_zero_state)

    def loop_constants(self, keys: torch.Tensor) -> torch.Tensor:
        """[U, 1] score vector, ``g v / ||v||`` or ``v``: constant over a
        decode, so the decoder computes it once."""
        if not self.normalize:
            return self.attention_v
        return (self.attention_g * self.attention_v
                / torch.linalg.norm(self.attention_v))

    def score(self, query: torch.Tensor, keys: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
        q = dense(self.query_layer, query)                # float32
        e = keys + q[:, None, :]
        if self.normalize:
            e = e + self.attention_b
        return (torch.tanh(e) @ v).squeeze(-1)

    def forward(self, query, state, keys, mask, consts):
        s = torch.where(mask, self.score(query, keys, consts), NEG_INF)
        alignments = torch.softmax(s, dim=-1)
        return alignments, alignments


class BahdanauMonotonicAttention(BahdanauAttention):
    """``bah_mon`` / ``bah_mon_norm``: the additive score plus a learned
    ``score_bias``, masked to -1e9 before the sigmoid, which feeds the
    parallel-mode monotonic expectation.  The state is the previous
    alignments, a one-hot at position 0 to start."""

    def __init__(self, query_dim: int, num_units: int,
                 normalize: bool = False):
        super().__init__(query_dim, num_units, normalize)
        self.score_bias = nn.Parameter(torch.tensor(0.0))

    @staticmethod
    def init_state(batch: int, t: int, device=None) -> torch.Tensor:
        state = torch.zeros(batch, t, device=device)
        state[:, 0] = 1.0
        return state

    def expected(self, query, state, keys, mask, consts) -> torch.Tensor:
        s = self.score(query, keys, consts) + self.score_bias
        s = torch.where(mask, s, NEG_INF)
        return monotonic_attention_parallel(torch.sigmoid(s), state)

    def forward(self, query, state, keys, mask, consts):
        alignments = self.expected(query, state, keys, mask, consts)
        return alignments, alignments


class BahdanauMonotonicAttentionHccho(BahdanauMonotonicAttention):
    """``bah_mon_norm_hccho``: the monotonic expectation (unbiased) is the
    state; the alignments are ``relu(expectation + alignments_bias)``,
    renormalised to sum to 1 (+ 1e-12)."""

    def __init__(self, query_dim: int, num_units: int,
                 normalize: bool = True):
        super().__init__(query_dim, num_units, normalize)
        self.alignments_bias = nn.Parameter(torch.zeros(1))

    def forward(self, query, state, keys, mask, consts):
        next_state = self.expected(query, state, keys, mask, consts)
        a = F.relu(next_state + self.alignments_bias)
        return a / (a.sum(-1, keepdim=True) + 1e-12), next_state


class LocationSensitiveAttention(nn.Module):
    """``loc_sen``: energy ``v_a . tanh(keys + W_q q + W_l f + b_a)`` where
    ``f`` is a 32-channel, width-31 convolution (same padding, no kernel
    flip, as flax's ``nn.Conv``) of the cumulative alignments; masked to
    -1e9, then a softmax.  The state is the running sum of the alignments,
    zeros to start."""

    def __init__(self, query_dim: int, num_units: int):
        super().__init__()
        self.query_layer = nn.Linear(query_dim, num_units, bias=False)
        self.location_convolution = nn.Conv1d(1, 32, 31, padding=15)
        self.location_layer = nn.Linear(32, num_units, bias=False)
        self.attention_variable = _glorot_column(num_units)
        self.attention_bias = nn.Parameter(torch.zeros(num_units))

    init_state = staticmethod(_zero_state)

    def loop_constants(self, keys: torch.Tensor) -> None:
        return None

    def forward(self, query, state, keys, mask, consts):
        q = dense(self.query_layer, query)                # float32
        f = self.location_convolution(state[:, None, :])  # [B, 32, T]
        loc = dense(self.location_layer, f.transpose(1, 2))
        e = torch.tanh(keys + q[:, None, :] + loc + self.attention_bias)
        energy = torch.where(mask, (e @ self.attention_variable).squeeze(-1),
                             NEG_INF)
        alignments = torch.softmax(energy, dim=-1)
        return alignments, alignments + state


class GmmAttention(nn.Module):
    """``gmm``: ``alpha, beta, kappa_hat = exp`` of the three thirds of
    ``gmm_query_layer(query)``; ``kappa = state + exp(kappa_hat)``; the
    alignments are ``sum_k alpha_k exp(-beta_k (kappa_k - t)^2)`` over
    the encoder positions t, unnormalised and masked to 0.  The state is
    kappa [B, num_mixtures], zeros to start."""

    def __init__(self, query_dim: int, num_mixtures: int):
        super().__init__()
        self.num_mixtures = num_mixtures
        self.gmm_query_layer = nn.Linear(query_dim, 3 * num_mixtures)

    def init_state(self, batch: int, t: int, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.num_mixtures, device=device)

    def loop_constants(self, keys: torch.Tensor) -> torch.Tensor:
        """The encoder positions ``mu`` [T_in], float32."""
        return torch.arange(keys.shape[1], dtype=torch.float32,
                            device=keys.device)

    def forward(self, query, state, keys, mask, consts):
        p = dense(self.gmm_query_layer, query)            # float32
        alpha, beta, kappa_hat = torch.exp(p).chunk(3, dim=-1)
        kappa = state + kappa_hat
        phi = torch.sum(alpha[..., None] * torch.exp(
            -beta[..., None] * (kappa[..., None] - consts) ** 2), dim=1)
        return torch.where(mask, phi, 0.0), kappa


class LuongAttention(nn.Module):
    """``luong`` / ``luong_scaled``: the dot product of the query and the
    keys, times a learned ``g`` (starting at 1) when scaled; masked to
    -1e9, then a softmax.  A query whose width is not the keys' is first
    projected by ``luong_query_projection`` (no bias), as the JAX package
    does where TF would refuse.  The state is the alignments, zeros to
    start."""

    def __init__(self, query_dim: int, num_units: int, scale: bool = False):
        super().__init__()
        self.scale = scale
        self.luong_query_projection: Optional[nn.Linear] = (
            nn.Linear(query_dim, num_units, bias=False)
            if query_dim != num_units else None)
        if scale:
            self.attention_g = nn.Parameter(torch.tensor(1.0))

    init_state = staticmethod(_zero_state)

    def loop_constants(self, keys: torch.Tensor) -> None:
        return None

    def forward(self, query, state, keys, mask, consts):
        q = (query.float() if self.luong_query_projection is None
             else dense(self.luong_query_projection, query))
        s = torch.bmm(keys, q[:, :, None]).squeeze(-1)
        if self.scale:
            s = self.attention_g * s
        alignments = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
        return alignments, alignments


_TABLE = {
    "bah": lambda q, u: BahdanauAttention(q, u, normalize=False),
    "bah_norm": lambda q, u: BahdanauAttention(q, u, normalize=True),
    "bah_mon": lambda q, u: BahdanauMonotonicAttention(q, u, normalize=False),
    "bah_mon_norm": lambda q, u: BahdanauMonotonicAttention(
        q, u, normalize=True),
    "bah_mon_norm_hccho": lambda q, u: BahdanauMonotonicAttentionHccho(
        q, u, normalize=True),
    "loc_sen": LocationSensitiveAttention,
    "gmm": GmmAttention,                  # num_mixtures = attention_size
    "luong": lambda q, u: LuongAttention(q, u, scale=False),
    "luong_scaled": lambda q, u: LuongAttention(q, u, scale=True),
}
ATTENTION_TYPES = tuple(_TABLE)


def make_attention(attention_type: str, query_dim: int,
                   num_units: int) -> nn.Module:
    """The mechanism named by the JAX table's ``attention_type`` string,
    for a query of ``query_dim`` (the attention GRU's width) and
    ``num_units`` (``attention_size``)."""
    if attention_type not in _TABLE:
        raise KeyError(f"unknown attention type {attention_type!r}; have "
                       f"{sorted(ATTENTION_TYPES)}")
    return _TABLE[attention_type](query_dim, num_units)
