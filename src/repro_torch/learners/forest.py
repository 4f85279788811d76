"""Weighted random forest: a bootstrap of the port's decision tree.

Counterpart of ``repro/learners/forest.py`` (the paper's Blob learner,
Figs. 3a and 4a).  The bootstrap is a Poisson(1) weight-space resampling
(tree t fits on ``w * counts_t``) and feature bagging a random column
subset per tree (the first ``num_feats`` of a permutation), drawn from the
fit's :class:`~repro_torch.comm.draws.FitDraws`: tree t's counts are
``poisson((n,), t)`` and its columns ``permutation(p, t)`` (the
reference's boot and feature keys of its t-th split).

The reference vmaps the trees; here they are fitted one after another with
:func:`~repro_torch.learners.tree.fit_tree`, whose float64 histograms make
a fit the same bits on the card and on the CPU (integer counts times w
are exact).  The params keep the reference's structure:
``{"params": ({"feat", "thr", "leaf"} stacked [T, ...], cols [T, f]),
"num_classes": K}``.  Prediction is a one-hot vote histogram over the
trees and its argmax, the first maximum on ties.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.comm.draws import fit_draws
from repro_torch.learners.base import Learner
from repro_torch.learners.tree import fit_tree, predict_tree


def num_features(feature_fraction: float, p: int) -> int:
    """Columns a tree sees: Python's round (half to even), at least 1."""
    return max(1, int(round(feature_fraction * p)))


@dataclass(frozen=True)
class RandomForest(Learner):
    num_trees: int = 16
    depth: int = 4
    num_thresholds: int = 16
    feature_fraction: float = 0.7
    device: str = "cuda"

    def fit(self, key, X, classes, w, num_classes):
        draws = fit_draws(key)
        X, classes, w = self._place(X), self._place(classes), self._place(w)
        n, p = X.shape
        f = num_features(self.feature_fraction, p)
        trees, cols = [], []
        for t in range(self.num_trees):
            counts = draws.poisson((n,), t, X.device).to(w.dtype)
            c = draws.permutation(p, t, X.device)[:f]
            trees.append(fit_tree(X[:, c], classes, w * counts,
                                  depth=self.depth,
                                  num_thresholds=self.num_thresholds,
                                  num_classes=num_classes))
            cols.append(c.to(torch.int32))
        stacked = {k: torch.stack([tr[k] for tr in trees]) for k in trees[0]}
        return {"params": (stacked, torch.stack(cols)),
                "num_classes": int(num_classes)}

    def predict(self, state, X):
        X = self._place(X)
        trees, cols = state["params"]
        votes = torch.stack([
            predict_tree({k: v[t] for k, v in trees.items()},
                         X[:, cols[t].long()], depth=self.depth)
            for t in range(cols.shape[0])])                      # [T, n]
        hist = F.one_hot(votes.long(), int(state["num_classes"])).sum(0)
        return torch.argmax(hist, dim=-1)
