"""Ignorance-score and model-weight updates (paper eqs. 9-13, Props. 1-2).

Counterpart of ``repro/core/scores.py``; the derivation is documented
there.  Rewards ``r`` and ignorance scores ``w`` are float32 tensors of
length n; ``r_i = I{g(x_i) == y_i}``.  Scalars come back as 0-d float32
tensors on the inputs' device, so a hop needs no host sync until a caller
asks for ``float(alpha)``.

The model weight's sums and logarithms, and the upstream factor's
exponentials, are taken in float64 and rounded to float32 (the reference
works in float32).  A float32 sum's rounding depends on its order, and a
float32 ``exp``/``log`` on the library, both of which differ between the
card and the CPU; an ulp in alpha then moves every later element of w, and
a quantizing wire codec turns that ulp into a whole step wherever an
element sits on a floor boundary.  Rounded from float64, alpha and the
factors are the same on both devices, within float32 rounding of the
reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-12


class AlphaResult(NamedTuple):
    alpha: torch.Tensor          # 0-d model weight
    weighted_acc: torch.Tensor   # 0-d, the r-bar of eq. (9) (u-adjusted)


def _where_correct(r: torch.Tensor, alpha: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """exp(-alpha/(K-1)) where r = 1, exp(+alpha/(K-1)^2) where r = 0
    (each exponential rounded from float64)."""
    k = num_classes
    return torch.where(r > 0, _exp(-alpha / (k - 1)),
                       _exp(alpha / (k - 1) ** 2))


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor, taken in float64 and rounded to float32."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def upstream_factor_update(u: torch.Tensor, alpha: torch.Tensor,
                           r: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Multiply the within-round upstream factor u_i by this agent's term
    exp(-alpha y_i^T g(x_i) / K)."""
    return u * _where_correct(r, alpha, num_classes)


def model_weight(w: torch.Tensor, r: torch.Tensor, num_classes: int,
                 u: torch.Tensor | None = None, alpha_cap: float = 20.0,
                 exact_scale: bool = False) -> AlphaResult:
    """Generalized model weight (eq. 13); eq. (9) when ``u is None`` (head
    agent) and eq. (11) when ``u`` carries exactly one upstream agent."""
    k = num_classes
    if u is None:
        u = torch.ones_like(w)
    f64 = torch.float64
    s_correct = torch.sum((w * u * r).to(f64))
    s_wrong = torch.sum((w * u * (1.0 - r)).to(f64))
    rbar = s_correct / torch.clamp(s_correct + s_wrong, min=_EPS)
    alpha = (torch.log(torch.clamp(s_correct, min=_EPS))
             - torch.log(torch.clamp(s_wrong, min=_EPS))
             + torch.log(torch.full((), float(k - 1), dtype=f64,
                                    device=w.device)))
    if exact_scale:
        alpha = alpha * (k - 1) ** 2 / k
    alpha = torch.clamp(alpha.to(torch.float32), -alpha_cap, alpha_cap)
    return AlphaResult(alpha=alpha, weighted_acc=rbar.to(torch.float32))


def ignorance_update(w: torch.Tensor, r: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """Interchange update (eqs. 10/12) as plain tensor ops: up-weight
    misclassified samples by e^alpha and renormalize.  The engine's standard
    hop runs the same function through ``kernels.ops.ignorance_update``."""
    w_new = w * torch.exp(alpha * (1.0 - r))
    return w_new / torch.clamp(torch.sum(w_new), min=_EPS)


def ignorance_update_exact(w: torch.Tensor, r: torch.Tensor,
                           alpha: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """Beyond-paper variant: the exact exponential-loss reweighting
    w_i *= exp(-alpha y^T g / K), renormalized."""
    w_new = w * _where_correct(r, alpha, num_classes)
    return w_new / torch.clamp(torch.sum(w_new), min=_EPS)


def head_agent_alpha(w: torch.Tensor, r: torch.Tensor, num_classes: int,
                     alpha_cap: float = 20.0) -> AlphaResult:
    """Eq. (9): alpha^(A) = log(rbar/(1-rbar)) + log(K-1)."""
    return model_weight(w, r, num_classes, u=None, alpha_cap=alpha_cap)


def assistant_alpha(w: torch.Tensor, r: torch.Tensor, u: torch.Tensor,
                    num_classes: int, alpha_cap: float = 20.0) -> AlphaResult:
    """Eqs. (11)/(13): an assistant's alpha given the upstream factor u."""
    return model_weight(w, r, num_classes, u=u, alpha_cap=alpha_cap)


def init_ignorance(n: int, device: str | torch.device = "cuda",
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Line 1 of Algorithm 1, kept normalized: w_1 = [1/n, ..., 1/n]."""
    return torch.full((n,), 1.0 / n, dtype=dtype, device=device)

