"""Fused ignorance-weighted softmax cross-entropy, forward and backward:
CUDA kernels and plain versions.

Counterpart of ``repro/kernels/weighted_ce.py``, whose two Pallas TPU
kernels this replaces with ``csrc/weighted_ce.cu`` (built by
:mod:`._build`):

  * :func:`weighted_ce_fwd` -- ``(loss [T], lse [T])`` of logits [T, V]:
    ``lse = logsumexp(x)``, ``loss = w * (lse - x[label])``, one pass over
    each row with an online max and sum;
  * :func:`weighted_ce_bwd` -- ``dlogits = (w * g) * (exp(x - lse) -
    onehot(label))`` from the saved ``lse`` and the upstream ``g [T]``, in
    the logits' dtype.

The logits are float32 or bfloat16 (math in float32), any T and any V (the
Pallas kernel needs T % 128 == 0 and V % 512 == 0), any row stride with a
unit stride on V; labels int32 (int64 is converted here, once per call) in
[0, V); weights float32.  The plain versions have the semantics of
``repro/kernels/ref.py``'s ``weighted_ce`` / ``weighted_ce_grad``, with
float64 math for float64 inputs (gradcheck).

Each wrapper launches its kernel for CUDA tensors and uses its plain
version only for CPU tensors; it never falls back from one to the other.
Each counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import on_card

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


# ----------------------------------------------------------- plain versions
def weighted_ce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor):
    """Per-token weighted NLL and log-sum-exp in PyTorch ops:
    ``(loss [T], lse [T])``."""
    x = logits.to(_math_dtype(logits.dtype))
    lse = torch.logsumexp(x, dim=-1)
    gold = x.gather(-1, labels.long()[:, None])[:, 0]
    return weights.to(x.dtype) * (lse - gold), lse


def weighted_ce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, lse: torch.Tensor,
                          g: torch.Tensor) -> torch.Tensor:
    """dL/dlogits of ``loss_t = w_t (lse_t - x_t[label_t])`` scaled by the
    upstream ``g [T]``, in PyTorch ops, in the logits' dtype."""
    x = logits.to(_math_dtype(logits.dtype))
    grad = torch.exp(x - lse.to(x.dtype)[:, None])
    grad[torch.arange(x.shape[0], device=x.device), labels.long()] -= 1.0
    wg = weights.to(x.dtype) * g.to(x.dtype)
    return (wg[:, None] * grad).to(logits.dtype)


# -------------------------------------------------------------- the kernels
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("weighted_ce")
    if lib.weighted_ce_fwd.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.weighted_ce_fwd.argtypes = [p, i32, p, p, p, p, i64, i64, i64, p]
        lib.weighted_ce_fwd.restype = ctypes.c_int
        lib.weighted_ce_bwd.argtypes = [p, i32, p, p, p, p, p, i64, i64, i64,
                                        i64, p]
        lib.weighted_ce_bwd.restype = ctypes.c_int
    return lib


def _check(logits: torch.Tensor, labels: torch.Tensor,
           weights: torch.Tensor, *rows: tuple[str, torch.Tensor]) -> None:
    if logits.dim() != 2 or logits.shape[0] < 1 or logits.shape[1] < 1:
        raise ValueError(f"logits must be a non-empty [T, V] matrix, got "
                         f"{tuple(logits.shape)}")
    t = logits.shape[0]
    if not logits.is_floating_point():
        raise TypeError(f"logits must be floating point, got {logits.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    for name, x in (("labels", labels), ("weights", weights), *rows):
        if tuple(x.shape) != (t,):
            raise ValueError(f"{name} must be [{t}], got {tuple(x.shape)}")
        if x.device != logits.device:
            raise ValueError(f"{name} lies on {x.device}, logits on "
                             f"{logits.device}")


def _card_args(logits: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor, what: str):
    """The checks and conversions of a launch: (dtype code, int32 labels,
    float32 weights), contiguous."""
    if logits.dtype not in DTYPES:
        raise TypeError(f"the {what} kernel takes float32 or bfloat16 "
                        f"logits, got {logits.dtype}")
    if logits.stride(1) != 1 and logits.shape[1] > 1:
        raise ValueError(f"logits must have a unit stride on V, got strides "
                         f"{tuple(logits.stride())}")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    return (DTYPES[logits.dtype], labels.to(torch.int32).contiguous(),
            weights.contiguous())


def weighted_ce_fwd(logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor):
    """``(loss [T], lse [T])`` float32 of logits [T, V]: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check(logits, labels, weights)
    if not on_card(logits, "weighted_ce_fwd"):
        return weighted_ce_fwd_plain(logits, labels, weights)
    code, labels, weights = _card_args(logits, labels, weights,
                                       "weighted_ce_fwd")
    t, v = logits.shape
    loss = torch.empty(t, dtype=torch.float32, device=logits.device)
    lse = torch.empty(t, dtype=torch.float32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        status = _lib().weighted_ce_fwd(
            logits.data_ptr(), code, labels.data_ptr(), weights.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), t, v, logits.stride(0), stream)
    if status != 0:
        raise RuntimeError(f"weighted_ce_fwd launch failed with cudaError_t "
                           f"{status}")
    weighted_ce_fwd.launches += 1
    return loss, lse


weighted_ce_fwd.launches = 0


def weighted_ce_bwd(logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor, lse: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """dlogits [T, V] in the logits' dtype (contiguous): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    _check(logits, labels, weights, ("lse", lse), ("g", g))
    if not on_card(logits, "weighted_ce_bwd"):
        return weighted_ce_bwd_plain(logits, labels, weights, lse, g)
    code, labels, weights = _card_args(logits, labels, weights,
                                       "weighted_ce_bwd")
    if lse.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"lse and g must be float32, got {lse.dtype}, "
                        f"{g.dtype}")
    lse, g = lse.contiguous(), g.contiguous()
    t, v = logits.shape
    dlogits = torch.empty((t, v), dtype=logits.dtype, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        status = _lib().weighted_ce_bwd(
            logits.data_ptr(), code, labels.data_ptr(), weights.data_ptr(),
            lse.data_ptr(), g.data_ptr(), dlogits.data_ptr(), t, v,
            logits.stride(0), dlogits.stride(0), stream)
    if status != 0:
        raise RuntimeError(f"weighted_ce_bwd launch failed with cudaError_t "
                           f"{status}")
    weighted_ce_bwd.launches += 1
    return dlogits


weighted_ce_bwd.launches = 0
