"""Public wrappers for the port's kernels.

Counterpart of ``repro/kernels/ops.py``.  This slice ports the ignorance
update only; the quantize, weighted-CE and flash kernels are still to be
ported (see ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ignorance as _ig


def ignorance_update(w: torch.Tensor, r: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """Eqs. (10)/(12), normalized: pass 1 then pass 2 of the CUDA kernel for
    CUDA tensors, their plain version for CPU tensors."""
    w_new, partials = _ig.ignorance_update_unnormalized(w, r, alpha)
    return _ig.normalize_(w_new, partials)
