"""Attention for the Tacotron decoder (counterpart of the JAX package's
``models/attention.py``).

The port has the mechanism both committed checkpoints use, ``bah_mon_norm``:
Bahdanau monotonic attention (Raffel et al. 2017, parallel mode) with the
weight-normalised score.  ``make_attention`` knows every name of the JAX
table and raises ``NotImplementedError`` for the ones not ported yet; it
never falls back to another type.

A mechanism takes ``(query, state, keys, mask)`` and returns
``(alignments, next_state)``; ``keys`` are the memory layer's projection of
the encoder outputs, computed once per utterance.  Its math is float32
whatever the model's compute type.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
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


class BahdanauMonotonicAttention(nn.Module):
    """``bah_mon_norm``: the weight-normalised additive score
    ``g v / ||v|| . tanh(keys + W_q q + b)`` plus a learned ``score_bias``
    (the query layer has no bias); masked positions are set to -1e9 before
    the sigmoid, which feeds the parallel-mode monotonic expectation.  The
    state is the previous alignments, a one-hot at position 0 to start."""

    def __init__(self, query_dim: int, num_units: int):
        super().__init__()
        self.query_layer = nn.Linear(query_dim, num_units, bias=False)
        self.attention_v = nn.Parameter(torch.empty(num_units, 1))
        nn.init.xavier_uniform_(self.attention_v)
        self.attention_g = nn.Parameter(
            torch.tensor(math.sqrt(1.0 / num_units)))
        self.attention_b = nn.Parameter(torch.zeros(num_units))
        self.score_bias = nn.Parameter(torch.tensor(0.0))

    def score_vector(self) -> torch.Tensor:
        """[U, 1] ``g v / ||v||``.  Constant over a decode, so the decoder
        computes it once and passes it to every step."""
        return (self.attention_g * self.attention_v
                / torch.linalg.norm(self.attention_v))

    @staticmethod
    def init_state(batch: int, t: int, device=None) -> torch.Tensor:
        state = torch.zeros(batch, t, device=device)
        state[:, 0] = 1.0
        return state

    def forward(self, query: torch.Tensor, state: torch.Tensor,
                keys: torch.Tensor, mask: torch.Tensor,
                score_vector: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        q = dense(self.query_layer, query)                # float32
        e = torch.tanh(keys + q[:, None, :] + self.attention_b)
        s = (e @ score_vector).squeeze(-1) + self.score_bias
        s = torch.where(mask, s, NEG_INF)
        alignments = monotonic_attention_parallel(torch.sigmoid(s), state)
        return alignments, alignments


ATTENTION_TYPES = ("bah", "bah_norm", "bah_mon", "bah_mon_norm",
                   "bah_mon_norm_hccho", "loc_sen", "gmm", "luong",
                   "luong_scaled")


def make_attention(attention_type: str, query_dim: int,
                   num_units: int) -> nn.Module:
    """The mechanism named by the JAX table's ``attention_type`` string."""
    if attention_type == "bah_mon_norm":
        return BahdanauMonotonicAttention(query_dim, num_units)
    if attention_type in ATTENTION_TYPES:
        raise NotImplementedError(
            f"attention type {attention_type!r} is not ported yet; only "
            "'bah_mon_norm' is (ROADMAP.md, Queue 1: the other attention "
            "types)")
    raise KeyError(f"unknown attention type {attention_type!r}; have "
                   f"{sorted(ATTENTION_TYPES)}")
