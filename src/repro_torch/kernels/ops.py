"""Public wrappers for the port's kernels.

Counterpart of ``repro/kernels/ops.py``: the ignorance update, the four
wire-codec kernels (quantize-dequant for vectors and score blocks, int4
pack and unpack), the weighted cross-entropy with its backward, flash
attention and flash decode; every Pallas kernel of the reference has its
CUDA counterpart.  Each runs its CUDA kernel for CUDA tensors and its plain
version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ignorance as _ig
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import weighted_ce as _wce


class _WeightedCE(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward kernel saves lse, the
    backward kernel recomputes the probabilities from it; labels and
    weights get no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, weights):
        loss, lse = _wce.weighted_ce_fwd(logits, labels, weights)
        ctx.save_for_backward(logits, labels, weights, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, weights, lse = ctx.saved_tensors
        return (_wce.weighted_ce_bwd(logits, labels, weights, lse, g),
                None, None)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Per-token ignorance-weighted NLL [T] of logits [T, V]:
    ``w * (logsumexp(x) - x[label])``, differentiable in the logits through
    the backward kernel."""
    return _WeightedCE.apply(logits, labels, weights)


def ignorance_update(w: torch.Tensor, r: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """Eqs. (10)/(12), normalized: one launch of the CUDA kernel for CUDA
    tensors (a thread-block cluster sums and scales), its plain version for
    CPU tensors."""
    return _ig.ignorance_update(w, r, alpha)


def quantize_dequant(x: torch.Tensor, u: torch.Tensor, qmax, *,
                     bn: int = 1024):
    """Fused per-tile quantize-dequant for the wire codecs: returns
    (dequantized [n], int8 wire values [n], per-tile scales)."""
    return _q.quantize_dequant_tiles(x, u, qmax, bn=bn)


def quantize_dequant_block(x: torch.Tensor, u: torch.Tensor, qmax, *,
                           bn: int = 1024):
    """Row-tiled quantize-dequant for [n, k] score blocks: returns
    (dequantized [n, k], int8 wire values [n, k], per-row-tile scales)."""
    return _q.quantize_dequant_block(x, u, qmax, bn=bn)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Two sign-extended int4 nibbles per int8 wire byte (flat,
    ceil(numel / 2) long): the int4 codec's wire array."""
    return _q.pack_int4(q)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: n int8-carried int4 values (flat)."""
    return _q.unpack_int4(packed, n)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Blocked online-softmax attention: q [B, H, S, D] against k/v
    [B, KV, T, D] (GQA, queries right-aligned), causal and with an optional
    sliding window; returns [B, H, S, D]."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, *,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None,
                 window: int | None = None) -> torch.Tensor:
    """Single-row attention of q [B, H, D] against positions <= pos of a
    [B, KV, S, D] cache (int8 with [B, KV, S] scales when given); returns
    [B, H, D]."""
    return _fd.flash_decode(q, k, v, pos, k_scale=k_scale, v_scale=v_scale,
                            window=window)
