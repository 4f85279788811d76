"""Vertical partitioning + sample-ID collation (Section II-A).

Counterpart of ``repro/data/partition.py``: agents hold disjoint column
blocks of a holistic matrix, aligned by sample ID; the non-IID
partitioners below cut horizontal shards of the rows for the scenario
engine (``repro_torch.scenarios``).  They are numpy on a seeded
``default_rng``, as the reference's, so the shards are its index arrays
exactly.
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


# ------------------------------------------------------- non-IID partitioners
# Horizontal sample shards over the vertical feature split
# (repro_torch.scenarios): each agent keeps its feature block over all
# collated rows but fits only on its shard.  Both partitioners return one
# row-index array an agent, covering range(n) exactly once, every shard
# nonempty (when n >= num_agents), fixed by the seed.

def _rebalance_empties(shards: list[list[int]]) -> list[np.ndarray]:
    """Move one sample from the largest shard into each empty one, largest
    first: every agent must hold at least one row to fit on."""
    for m, shard in enumerate(shards):
        if shard:
            continue
        donor = max(range(len(shards)), key=lambda i: len(shards[i]))
        if len(shards[donor]) > 1:
            shard.append(shards[donor].pop())
    return [np.asarray(sorted(s), dtype=np.int64) for s in shards]


def dirichlet_label_partition(seed: int, classes, num_agents: int,
                              alpha: float = 0.5) -> list[np.ndarray]:
    """Dirichlet label-skew shards (Hsu et al. 2019): each class's samples
    split across agents with proportions ~ Dir(alpha).  Small alpha puts
    each class on few agents; large alpha approaches IID."""
    if alpha <= 0:
        raise ValueError(f"Dirichlet alpha must be > 0, got {alpha}")
    if num_agents < 1:
        raise ValueError(f"need num_agents >= 1, got {num_agents}")
    rng = np.random.default_rng(seed)
    classes = np.asarray(classes)
    shards: list[list[int]] = [[] for _ in range(num_agents)]
    for c in np.unique(classes):
        idx = np.flatnonzero(classes == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_agents, float(alpha)))
        cuts = np.floor(np.cumsum(props) * len(idx)).astype(int)[:-1]
        for m, part in enumerate(np.split(idx, cuts)):
            shards[m].extend(part.tolist())
    return _rebalance_empties(shards)


def quantity_proportions(num_agents: int, skew: float) -> np.ndarray:
    """Power-law shard proportions p_m ∝ (m+1)^-skew: skew 0 is uniform,
    and the spread max(p)/min(p) = num_agents^skew grows strictly with
    skew."""
    if skew < 0:
        raise ValueError(f"quantity skew must be >= 0, got {skew}")
    w = np.arange(1, num_agents + 1, dtype=np.float64) ** (-float(skew))
    return w / w.sum()


def quantity_partition(seed: int, n: int, num_agents: int,
                       skew: float = 1.0) -> list[np.ndarray]:
    """Quantity-skew shards: agent m holds a power-law share of a seeded
    permutation of the rows (largest-remainder apportionment, so the sizes
    sum to n exactly)."""
    if num_agents < 1:
        raise ValueError(f"need num_agents >= 1, got {num_agents}")
    props = quantity_proportions(num_agents, skew)
    raw = props * n
    sizes = np.floor(raw).astype(int)
    rem = n - sizes.sum()
    order = np.argsort(-(raw - np.floor(raw)), kind="stable")
    sizes[order[:rem]] += 1
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    shards = [perm[s:s + z].tolist()
              for s, z in zip(np.cumsum(sizes) - sizes, sizes)]
    return _rebalance_empties(shards)
