"""Mixture-of-logistics sampler (counterpart of the JAX package's
``models/mixture.py`` ``sample_from_discretized_mix_logistic``).

The noise comes from an explicit ``torch.Generator`` or is handed in as
uniforms, so a test can feed both frameworks the same numbers.  The loss
belongs to training and is not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LOG_SCALE_MIN = float(math.log(1e-14))
U_MIN, U_MAX = 1e-5, 1.0 - 1e-5


def sample_from_discretized_mix_logistic(
        y: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        uniforms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        log_scale_min: float = LOG_SCALE_MIN) -> torch.Tensor:
    """Draw samples in [-1,1]; y: [..., 3*nr_mix] -> [...].

    Gumbel-max picks the component, the logistic inverse CDF draws from it.
    ``uniforms`` = ``(u_sel [..., nr_mix], u [...])`` replaces the generator.
    """
    nr_mix = y.shape[-1] // 3
    if uniforms is None:
        u = torch.rand(y.shape[:-1] + (nr_mix + 1,), generator=generator,
                       device=y.device)
        uniforms = (u[..., :nr_mix], u[..., nr_mix])
    u_sel, u = (v.to(y.dtype).clamp(U_MIN, U_MAX) for v in uniforms)

    logit_probs = y[..., :nr_mix]
    sel_idx = torch.argmax(logit_probs - torch.log(-torch.log(u_sel)), dim=-1)
    sel = torch.nn.functional.one_hot(sel_idx, nr_mix).to(y.dtype)
    means = torch.sum(y[..., nr_mix:2 * nr_mix] * sel, dim=-1)
    log_scales = torch.clamp(
        torch.sum(y[..., 2 * nr_mix:3 * nr_mix] * sel, dim=-1),
        min=log_scale_min)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))
    return torch.clamp(x, -1.0, 1.0)
