"""Label encoding for multi-class exponential-loss boosting (paper eq. 1).

Counterpart of ``repro/core/encoding.py``.  A class label c in {0..K-1} is
re-coded into a length-K vector with 1 at c and -1/(K-1) elsewhere, so that

    y^T g / K =  1/(K-1)      if g encodes the same class as y
              = -1/(K-1)^2    if g encodes a different class
"""
from __future__ import annotations

import torch


def encode_labels(classes: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Recode integer classes [n] -> coded label matrix [n, K] per eq. (1)."""
    k = num_classes
    onehot = (classes[..., None] == torch.arange(k, device=classes.device)
              ).to(torch.float32)
    return onehot * (1.0 + 1.0 / (k - 1)) - 1.0 / (k - 1)


def decode_labels(coded: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`encode_labels` (argmax over the coded axis)."""
    return torch.argmax(coded, dim=-1)


def margin(coded_y: torch.Tensor, scores: torch.Tensor,
           num_classes: int) -> torch.Tensor:
    """The exponent y^T f / K of the exponential loss, elementwise over rows."""
    return torch.sum(coded_y * scores, dim=-1) / num_classes


def exp_loss(coded_y: torch.Tensor, scores: torch.Tensor,
             num_classes: int) -> torch.Tensor:
    """Per-sample exponential loss exp(-y^T f / K)."""
    return torch.exp(-margin(coded_y, scores, num_classes))
