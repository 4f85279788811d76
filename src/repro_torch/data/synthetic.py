"""Synthetic dataset generators for the paper's experiments.

Counterpart of ``repro/data/synthetic.py``: the same dimensionalities,
class counts and per-agent feature splits, drawn from an explicit
``torch.Generator`` (so the numbers differ from the reference's threefry
draws; parity tests feed both packages the same arrays instead).  Draws are
made on the generator's device (the CPU unless the caller passes a CUDA
generator) and the dataset is moved to ``device``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Dataset:
    name: str
    X: torch.Tensor          # [n, p] float32
    classes: torch.Tensor    # [n] int64
    num_classes: int
    splits: tuple[int, ...]  # per-agent feature counts (sum == p)


def _normal(gen, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device)


def _uniform(gen, *shape, low=0.0, high=1.0):
    return low + (high - low) * torch.rand(*shape, generator=gen,
                                           device=gen.device)


def _randint(gen, high, n):
    return torch.randint(0, high, (n,), generator=gen, device=gen.device)


def _to(ds: Dataset, device) -> Dataset:
    dev = resolve_device(device)
    return Dataset(ds.name, ds.X.to(dev), ds.classes.to(dev), ds.num_classes,
                   ds.splits)


def gaussian_blobs(gen: torch.Generator, *, n: int, num_features: int,
                   num_classes: int, cluster_std: float = 1.0,
                   center_box: float = 10.0, num_redundant: int = 0):
    """Isotropic Gaussian blobs (sklearn.datasets.make_blobs semantics)."""
    centers = _uniform(gen, num_classes, num_features, low=-center_box,
                       high=center_box)
    classes = _randint(gen, num_classes, n)
    X = centers[classes] + cluster_std * _normal(gen, n, num_features)
    if num_redundant:
        noise = _normal(gen, n, num_redundant) * center_box / 2
        X = torch.cat([X, noise], dim=-1)
    return X, classes


def blob_fig3(gen: torch.Generator, n: int = 1000,
              device: str = "cuda") -> Dataset:
    """Fig. 3a: 10-class blobs, 8 features, 4 agents x 2 features."""
    X, c = gaussian_blobs(gen, n=n, num_features=8, num_classes=10,
                          cluster_std=1.5)
    return _to(Dataset("blob", X, c, 10, (2, 2, 2, 2)), device)


def blob_fig4(gen: torch.Generator, n: int = 1000,
              device: str = "cuda") -> Dataset:
    """Fig. 4a: 10-class blobs, 5 informative + 195 redundant features,
    randomly divided into 2 agents x 100 features."""
    X, c = gaussian_blobs(gen, n=n, num_features=5, num_classes=10,
                          cluster_std=1.0, num_redundant=195)
    perm = torch.randperm(200, generator=gen, device=gen.device)
    return _to(Dataset("blob200", X[:, perm], c, 10, (100, 100)), device)


def blob_fig6(gen: torch.Generator, n: int = 1000,
              device: str = "cuda") -> Dataset:
    """Fig. 6a: 20-class blobs, 20 features, 20 agents x 1 feature."""
    X, c = gaussian_blobs(gen, n=n, num_features=20, num_classes=20,
                          cluster_std=1.0)
    return _to(Dataset("blob20", X, c, 20, tuple([1] * 20)), device)


def _tabular_surrogate(gen, *, name, n, p, num_classes, splits, device,
                       informative_frac=0.7, noise=1.0, nonlinear=True):
    """Generic tabular surrogate: low-rank class-dependent means + optional
    sign interactions, standardized like a real tabular pull."""
    num_inf = max(2, int(p * informative_frac))
    means = _normal(gen, num_classes, num_inf) * 2.0
    classes = _randint(gen, num_classes, n)
    X_inf = means[classes] + noise * _normal(gen, n, num_inf)
    if nonlinear:
        # make a few informative columns only pairwise-informative
        X_inf[:, :2] = X_inf[:, :2] * torch.sign(X_inf[:, 2:4] + 1e-3)
    X_noise = _normal(gen, n, p - num_inf)
    X = torch.cat([X_inf, X_noise], dim=-1)
    X = X[:, torch.randperm(p, generator=gen, device=gen.device)]
    X = (X - X.mean(0)) / (X.std(0, correction=0) + 1e-6)
    return _to(Dataset(name, X, classes, num_classes, splits), device)


def mimic_surrogate(gen: torch.Generator, n: int = 15000,
                    device: str = "cuda") -> Dataset:
    """MIMIC-III extended-LoS surrogate: n=15000, p=16, K=2, split 3/13."""
    return _tabular_surrogate(gen, name="mimic", n=n, p=16, num_classes=2,
                              splits=(3, 13), informative_frac=0.6,
                              device=device)


def qsar_surrogate(gen: torch.Generator, n: int = 1055,
                   device: str = "cuda") -> Dataset:
    """QSAR biodegradation surrogate: p=41, K=2, split 20/21."""
    return _tabular_surrogate(gen, name="qsar", n=n, p=41, num_classes=2,
                              splits=(20, 21), informative_frac=0.5,
                              device=device)


def wine_surrogate(gen: torch.Generator, n: int = 1599,
                   device: str = "cuda") -> Dataset:
    """Red-wine quality surrogate: p=11, K=6, split 6/5."""
    return _tabular_surrogate(gen, name="wine", n=n, p=11, num_classes=6,
                              splits=(6, 5), informative_frac=0.9,
                              noise=1.6, nonlinear=False, device=device)


def fashion_surrogate(gen: torch.Generator, n: int = 4000, side: int = 28,
                      device: str = "cuda") -> Dataset:
    """Fashion-MNIST surrogate: 10 classes of side x side 'garment'
    templates (class-dependent smooth random fields) + pixel noise; agents
    hold the left/right image halves (Fig. 5)."""
    freq = torch.linspace(0.3, 1.2, 4, device=gen.device)
    coords = torch.linspace(-1, 1, side, device=gen.device)
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    phases = _uniform(gen, 10, 4, 2, high=2 * math.pi)
    amps = _normal(gen, 10, 4)
    templates = torch.stack([
        sum(amps[c, i] * torch.sin(freq[i] * 3 * xx + phases[c, i, 0])
            * torch.cos(freq[i] * 3 * yy + phases[c, i, 1])
            for i in range(4))
        for c in range(10)])                                      # [10, s, s]
    # class signal ramps left->right: the left-half agent alone is weak
    templates = templates * torch.linspace(0.25, 1.3, side,
                                           device=gen.device)[None, None, :]
    classes = _randint(gen, 10, n)
    imgs = templates[classes] + 1.1 * _normal(gen, n, side, side)
    # reorder pixels so the first side*side//2 belong to the left half
    col_idx = torch.arange(side * side, device=gen.device).reshape(side, side)
    order = torch.cat([col_idx[:, :side // 2].reshape(-1),
                       col_idx[:, side // 2:].reshape(-1)])
    X = imgs.reshape(n, side * side)[:, order]
    half = side * (side // 2)
    return _to(Dataset("fashion", X, classes, 10, (half, side * side - half)),
               device)


def token_stream_draws(gen: torch.Generator, *, vocab_size: int, batch: int,
                       seq_len: int, copy_prob: float = 0.35):
    """The random draws of :func:`token_stream`, on the generator's device:
    ``noise`` [B, S] uniform in [0, V) and ``use_map`` [B, S] Bernoulli
    (copy_prob), as the reference draws them (with other numbers)."""
    noise = torch.randint(0, vocab_size, (batch, seq_len), generator=gen,
                          device=gen.device)
    use_map = torch.rand((batch, seq_len), generator=gen,
                         device=gen.device) < copy_prob
    return noise, use_map


def markov_chain(noise, use_map, vocab_size: int) -> np.ndarray:
    """The first-order chain of :func:`token_stream` given its draws (numpy
    arrays or CPU tensors): token 0 is ``noise[:, 0]``; token t is
    ``(31 * token_{t-1} + 7) % V`` where ``use_map[:, t]``, else
    ``noise[:, t]``.  One host pass over S; int32 [B, S]."""
    noise = np.asarray(noise, dtype=np.int64)
    use_map = np.asarray(use_map, dtype=bool)
    tokens = np.empty(noise.shape, dtype=np.int64)
    tokens[:, 0] = noise[:, 0]
    for t in range(1, noise.shape[1]):
        tokens[:, t] = np.where(use_map[:, t],
                                (tokens[:, t - 1] * 31 + 7) % vocab_size,
                                noise[:, t])
    return tokens.astype(np.int32)


def token_stream(gen: torch.Generator, *, vocab_size: int, batch: int,
                 seq_len: int, copy_prob: float = 0.35,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """Synthetic LM token batch [B, S] int32 on ``device``: a first-order
    Markov chain where, with probability ``copy_prob``, token t is the
    affine map ``31 * t_prev + 7 (mod V)`` of the emitted predecessor, else
    uniform noise (counterpart of ``repro/data/synthetic.py``'s
    ``token_stream``).  The chain runs once on the host and the batch goes
    to the device in one copy."""
    dev = resolve_device(device)
    noise, use_map = token_stream_draws(gen, vocab_size=vocab_size,
                                        batch=batch, seq_len=seq_len,
                                        copy_prob=copy_prob)
    tokens = markov_chain(noise.cpu().numpy(), use_map.cpu().numpy(),
                          vocab_size)
    return torch.from_numpy(tokens).to(dev)
