"""Discretized mixture-of-logistics loss and sampler (counterpart of the
JAX package's ``models/mixture.py``).

The loss keeps the JAX branches as they are: the CDF edge cases at targets
beyond +-0.999, the log-pdf fallback where a bin's mass is below 1e-5, the
``maximum(cdf_delta, 1e-12)`` guard and the ``log_scale_min`` clamp.
``torch.where`` passes gradients into the branches it does not select
(times zero), so every branch must stay finite everywhere: the guard keeps
the log of a vanishing bin finite.  Softplus is ``logaddexp(x, 0)`` as
``jax.nn.softplus`` computes it; ``F.softplus``'s ``threshold=20``
shortcut would return ``x`` above 20, off by at most log1p(e^-20) ~ 2e-9.
Clamps use ``torch.maximum``, which splits the gradient at a tie as JAX's
``maximum`` does (``clamp`` passes all of it).

The sampler's noise comes from an explicit ``torch.Generator`` or is handed
in as uniforms, so a test can feed both frameworks the same numbers.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

LOG_SCALE_MIN = float(math.log(1e-14))
U_MIN, U_MAX = 1e-5, 1.0 - 1e-5


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sum_exp(x: torch.Tensor) -> torch.Tensor:
    m = torch.amax(x, dim=-1)
    return m + torch.log(torch.sum(torch.exp(x - m[..., None]), dim=-1))


def discretized_mix_logistic_loss(y_hat: torch.Tensor, y: torch.Tensor,
                                  num_class: int = 65536,
                                  log_scale_min: float = LOG_SCALE_MIN,
                                  reduce: bool = True) -> torch.Tensor:
    """NLL of targets y in [-1, 1] under a discretized MoL.

    y_hat: [..., 3*nr_mix] (logit_probs | means | log_scales); y: [..., 1].
    Returns the sum over every position, or the per-position NLL [...] when
    ``reduce`` is off."""
    nr_mix = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr_mix]
    means = y_hat[..., nr_mix:2 * nr_mix]
    log_scales = torch.maximum(y_hat[..., 2 * nr_mix:3 * nr_mix],
                               y_hat.new_tensor(log_scale_min))

    y = y.expand(y.shape[:-1] + (nr_mix,))
    centered = y - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = 1.0 / (num_class - 1)

    plus_in = inv_stdv * (centered + half_bin)
    cdf_plus = torch.sigmoid(plus_in)
    min_in = inv_stdv * (centered - half_bin)
    cdf_min = torch.sigmoid(min_in)

    log_cdf_plus = plus_in - softplus(plus_in)           # log CDF, -1 edge
    log_one_minus_cdf_min = -softplus(min_in)            # log 1-CDF, +1 edge
    cdf_delta = cdf_plus - cdf_min

    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * softplus(mid_in)

    log_probs = torch.where(
        y < -0.999, log_cdf_plus,
        torch.where(y > 0.999, log_one_minus_cdf_min,
                    torch.where(cdf_delta > 1e-5,
                                torch.log(torch.maximum(
                                    cdf_delta, cdf_delta.new_tensor(1e-12))),
                                log_pdf_mid - math.log((num_class - 1) / 2))))

    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    nll = -log_sum_exp(log_probs)
    return torch.sum(nll) if reduce else nll


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
