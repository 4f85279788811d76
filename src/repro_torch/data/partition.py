"""Vertical partitioning + sample-ID collation (Section II-A).

Counterpart of ``repro/data/partition.py`` (its main-path subset): agents
hold disjoint column blocks of a holistic matrix, aligned by sample ID.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def vertical_split(X: torch.Tensor, splits: Sequence[int]) -> list[torch.Tensor]:
    """Split columns into per-agent blocks of the given widths."""
    if sum(splits) != X.shape[-1]:
        raise ValueError(f"splits {tuple(splits)} do not cover "
                         f"{X.shape[-1]} columns")
    out, ofs = [], 0
    for p in splits:
        out.append(X[:, ofs:ofs + p])
        ofs += p
    return out


def collate(ids: Sequence[np.ndarray], Xs: Sequence[torch.Tensor]
            ) -> tuple[np.ndarray, list[torch.Tensor]]:
    """Align per-agent matrices on the intersection of their sample IDs:
    the common (sorted) IDs and each agent's rows re-ordered to them."""
    common = ids[0]
    for i in ids[1:]:
        common = np.intersect1d(common, i)
    out = []
    for agent_ids, X in zip(ids, Xs):
        order = {v: j for j, v in enumerate(np.asarray(agent_ids).tolist())}
        rows = np.array([order[v] for v in common.tolist()], dtype=np.int64)
        X = torch.as_tensor(X)
        out.append(X[torch.as_tensor(rows, device=X.device)])
    return common, out


def train_test_split(key_seed: int, n: int, train_frac: float = 0.7
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Paper Section VI: train on 70%, test on 30%, resampled per replicate
    (numpy's generator, so the split equals the reference's)."""
    rng = np.random.default_rng(key_seed)
    perm = rng.permutation(n)
    cut = int(round(train_frac * n))
    return perm[:cut], perm[cut:]
