"""Weighted decision tree: a dense argmin over a quantile threshold grid.

Counterpart of ``repro/learners/tree.py``.  The greedy split search is
level-synchronous over all nodes of a level, minimizing the w-weighted Gini
impurity.  The reference's 4-operand einsum materializes a float [n, p, q]
mask; here the per-node, per-class left histograms of a level are one
product ``[(w * node_oh) (x) class_oh]^T @ mask[n, p*q]``.

The histogram products accumulate in float64 and round to float32 (the
reference sums them in float32).  A float32 product's rounding depends on
its summation order, which differs between the card's and the CPU's
libraries, and the argmin over Gini scores turns an ulp into another split:
a MIMIC-size session on an H100 and on the CPU parted after the first hop
(chip_smoke.py, phase 4).  With float64 sums both get the correctly
rounded float32 histogram, so the split search, and everything after it,
agrees across devices.

The tree is a fixed-depth heap: internal node i has children 2i+1/2i+2,
``feat``/``thr`` arrays of length 2^D - 1 and 2^D leaf classes, stored with
the reference's dtypes (int32, float32, int32).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.learners.base import Learner

_EPS = 1e-12


def _weighted_gini(hist: torch.Tensor) -> torch.Tensor:
    """hist[..., K] of class masses -> mass-scaled Gini  s - sum h^2/s."""
    s = torch.sum(hist, dim=-1)
    return s - torch.sum(torch.square(hist), dim=-1) / torch.clamp(s, min=_EPS)


def _hist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b summed in float64, rounded to float32."""
    return (a.to(torch.float64).T @ b.to(torch.float64)).to(torch.float32)


def fit_tree(X: torch.Tensor, classes: torch.Tensor, w: torch.Tensor, *,
             depth: int, num_thresholds: int, num_classes: int):
    n, p = X.shape
    q = num_thresholds
    dev = X.device
    # interior quantiles, linear interpolation (jnp.quantile's default)
    qs = (torch.arange(q, dtype=torch.float32, device=dev) + 0.5) / q
    thr_cand = torch.quantile(X, qs, dim=0).T                     # [p, q]
    class_oh = F.one_hot(classes.long(), num_classes).to(torch.float32)
    left_mask = (X[:, :, None] <= thr_cand[None, :, :]
                 ).to(torch.float64).reshape(n, p * q)            # [n, p*q]

    feat = torch.zeros((2 ** depth - 1,), dtype=torch.int32, device=dev)
    thr = torch.zeros((2 ** depth - 1,), dtype=torch.float32, device=dev)
    node_of = torch.zeros((n,), dtype=torch.long, device=dev)
    rows = torch.arange(n, device=dev)

    for level in range(depth):
        width = 2 ** level
        wnode = w[:, None] * F.one_hot(node_of, width).to(torch.float32)
        hist_tot = _hist(wnode, class_oh)                         # [m, K]
        per_class = (wnode[:, :, None] * class_oh[:, None, :]
                     ).reshape(n, width * num_classes)            # [n, m*K]
        hist_left = _hist(per_class, left_mask).reshape(
            width, num_classes, p, q).permute(0, 2, 3, 1)         # [m,p,q,K]
        hist_right = hist_tot[:, None, None, :] - hist_left
        score = _weighted_gini(hist_left) + _weighted_gini(hist_right)
        best = torch.argmin(score.reshape(width, p * q), dim=-1)  # first on ties
        best_f = best // q
        best_thr = thr_cand[best_f, best % q]
        offset = 2 ** level - 1
        feat[offset:offset + width] = best_f.to(torch.int32)
        thr[offset:offset + width] = best_thr
        go_right = X[rows, best_f[node_of]] > best_thr[node_of]
        node_of = 2 * node_of + go_right.long()

    # leaf classes: weighted majority, backed off to the global majority
    # for empty leaves
    leaf_hist = _hist(w[:, None] * F.one_hot(node_of, 2 ** depth).to(
        torch.float32), class_oh)
    global_hist = _hist(w[:, None], class_oh)[0]
    leaf_hist = leaf_hist + _EPS * global_hist[None, :]
    leaf_class = torch.argmax(leaf_hist, dim=-1).to(torch.int32)
    return {"feat": feat, "thr": thr, "leaf": leaf_class}


def predict_tree(params, X: torch.Tensor, *, depth: int) -> torch.Tensor:
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)
    node = torch.zeros((n,), dtype=torch.long, device=X.device)  # heap index
    for _ in range(depth):
        go_right = X[rows, params["feat"][node]] > params["thr"][node]
        node = 2 * node + 1 + go_right.long()
    return params["leaf"][node - (2 ** depth - 1)]


@dataclass(frozen=True)
class DecisionTree(Learner):
    depth: int = 4
    num_thresholds: int = 16
    device: str = "cuda"

    param_dtypes = {"feat": torch.int32, "thr": torch.float32,
                    "leaf": torch.int32}

    def fit(self, key, X, classes, w, num_classes):
        del key  # deterministic
        return fit_tree(self._place(X), self._place(classes), self._place(w),
                        depth=self.depth, num_thresholds=self.num_thresholds,
                        num_classes=num_classes)

    def predict(self, params, X):
        return predict_tree(params, self._place(X), depth=self.depth)
