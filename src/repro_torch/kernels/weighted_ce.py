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

Shard mode (the vocab-parallel loss, ``sharding/tp.py``): the logits are
the columns [v0, v0 + V) of a vocab and the labels global.
:func:`weighted_ce_shard_fwd` gives the shard's ``(lse [T], gold [T])``
(gold 0 where the label lies elsewhere) for the ranks' combine;
:func:`weighted_ce_bwd` with ``v0`` writes ``softmax - onehot`` on the
shard's columns from the combined lse.  A shard whose rows fit a stage of
shared memory and a bulk copy's 16-byte rule (:func:`shard_fwd_plan`)
takes the staged forward kernel (a persistent grid, each row one TMA copy,
a two-pass reduction in shared memory); any other takes the streaming
forward kernel's shard mode.  The backward kernel runs both.

Each wrapper launches its kernel for CUDA tensors and uses its plain
version only for CPU tensors; it never falls back from one to the other.
Each counts its launches in ``.launches`` (the shard modes in
``weighted_ce_shard_fwd.launches`` and ``weighted_ce_shard_bwd.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import on_card, sm_count

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STAGE_BYTES_MAX = 48 * 1024  # the staged kernel's widest row
STAGED_BLOCKS_PER_SM = 2
IN_FLIGHT_BYTES = 64 * 1024  # rows in flight an SM the stages aim at
MAX_STAGES = 4


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


def weighted_ce_shard_fwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                                v0: int):
    """The shard's ``(lse [T], gold [T])`` of the vocab columns [v0, v0 +
    V), in PyTorch ops; gold is 0 where the label lies outside."""
    x = logits.to(_math_dtype(logits.dtype))
    col = labels.long() - v0
    inside = (col >= 0) & (col < x.shape[1])
    gold = x.gather(-1, torch.where(inside, col, 0)[:, None])[:, 0]
    return torch.logsumexp(x, dim=-1), torch.where(inside, gold, 0.0)


def weighted_ce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, lse: torch.Tensor,
                          g: torch.Tensor, v0: int = 0) -> torch.Tensor:
    """dL/dlogits of ``loss_t = w_t (lse_t - x_t[label_t])`` scaled by the
    upstream ``g [T]``, in PyTorch ops, in the logits' dtype; the logits
    are the vocab columns [v0, v0 + V)."""
    x = logits.to(_math_dtype(logits.dtype))
    grad = torch.exp(x - lse.to(x.dtype)[:, None])
    col = labels.long() - v0
    rows = torch.nonzero((col >= 0) & (col < x.shape[1]))[:, 0]
    grad[rows, col[rows]] -= 1.0
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
                                        i64, i64, p]
        lib.weighted_ce_bwd.restype = ctypes.c_int
        lib.weighted_ce_shard_fwd.argtypes = [p, i32, p, p, p, i64, i64, i64,
                                              i64, p]
        lib.weighted_ce_shard_fwd.restype = ctypes.c_int
        lib.weighted_ce_shard_fwd_staged.argtypes = [
            p, i32, p, p, p, i64, i64, i64, i64, i32, i32, i32, p]
        lib.weighted_ce_shard_fwd_staged.restype = ctypes.c_int
    return lib


def shard_fwd_plan(logits: torch.Tensor,
                   sms: int) -> tuple[int, int, int] | None:
    """The staged kernel's launch for the shard forward of ``logits`` [T,
    V] on a card of ``sms`` SMs: (grid, stages, stage bytes), a persistent
    grid of STAGED_BLOCKS_PER_SM blocks an SM (at most one a row), each
    with a ring of stages of a row rounded up to 128 bytes, as many as put
    IN_FLIGHT_BYTES in flight on an SM (2 to MAX_STAGES: 2 for a 19 KB
    shard row, where 4 ran 7 % slower on an H100).  None where the row does
    not fit a stage or a bulk copy's rule (its bytes, its base and its row
    stride multiples of 16): there the streaming kernel runs."""
    t, v = logits.shape
    size = logits.element_size()
    row = v * size
    if (row % 16 or row > STAGE_BYTES_MAX or logits.data_ptr() % 16
            or (t > 1 and logits.stride(0) * size % 16)):
        return None
    stage = -(-row // 128) * 128
    stages = IN_FLIGHT_BYTES // (STAGED_BLOCKS_PER_SM * stage)
    return (min(t, STAGED_BLOCKS_PER_SM * sms),
            max(2, min(MAX_STAGES, stages)), stage)


def _check(logits: torch.Tensor, labels: torch.Tensor,
           weights: torch.Tensor | None,
           *rows: tuple[str, torch.Tensor]) -> None:
    if logits.dim() != 2 or logits.shape[0] < 1 or logits.shape[1] < 1:
        raise ValueError(f"logits must be a non-empty [T, V] matrix, got "
                         f"{tuple(logits.shape)}")
    t = logits.shape[0]
    if not logits.is_floating_point():
        raise TypeError(f"logits must be floating point, got {logits.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if weights is not None:
        rows = (("weights", weights), *rows)
    for name, x in (("labels", labels), *rows):
        if tuple(x.shape) != (t,):
            raise ValueError(f"{name} must be [{t}], got {tuple(x.shape)}")
        if x.device != logits.device:
            raise ValueError(f"{name} lies on {x.device}, logits on "
                             f"{logits.device}")


def _card_args(logits: torch.Tensor, labels: torch.Tensor,
               weights: torch.Tensor | None, what: str):
    """The checks and conversions of a launch: (dtype code, int32 labels,
    float32 weights or None), contiguous."""
    if logits.dtype not in DTYPES:
        raise TypeError(f"the {what} kernel takes float32 or bfloat16 "
                        f"logits, got {logits.dtype}")
    if logits.stride(1) != 1 and logits.shape[1] > 1:
        raise ValueError(f"logits must have a unit stride on V, got strides "
                         f"{tuple(logits.stride())}")
    if weights is not None and weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    return (DTYPES[logits.dtype], labels.to(torch.int32).contiguous(),
            None if weights is None else weights.contiguous())


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


def weighted_ce_shard_fwd(logits: torch.Tensor, labels: torch.Tensor,
                          v0: int):
    """``(lse [T], gold [T])`` float32 of the vocab columns [v0, v0 + V)
    ``logits`` [T, V]: the staged kernel, or the forward kernel's shard mode
    where :func:`shard_fwd_plan` gives none, for CUDA tensors; the plain
    version for CPU tensors."""
    _check(logits, labels, None)
    if not on_card(logits, "weighted_ce_shard_fwd"):
        return weighted_ce_shard_fwd_plain(logits, labels, v0)
    code, labels, _ = _card_args(logits, labels, None,
                                 "weighted_ce_shard_fwd")
    t, v = logits.shape
    gold = torch.empty(t, dtype=torch.float32, device=logits.device)
    lse = torch.empty(t, dtype=torch.float32, device=logits.device)
    plan = shard_fwd_plan(logits, sm_count(logits.device.index))
    args = (logits.data_ptr(), code, labels.data_ptr(), gold.data_ptr(),
            lse.data_ptr(), t, v, logits.stride(0), int(v0))
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        if plan is None:
            status = _lib().weighted_ce_shard_fwd(*args, stream)
        else:
            status = _lib().weighted_ce_shard_fwd_staged(*args, *plan,
                                                         stream)
    if status != 0:
        raise RuntimeError(f"weighted_ce_shard_fwd launch failed with "
                           f"cudaError_t {status}")
    weighted_ce_shard_fwd.launches += 1
    return lse, gold


weighted_ce_shard_fwd.launches = 0


def weighted_ce_bwd(logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor, lse: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """dlogits [T, V] in the logits' dtype (contiguous): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    out, launched = _bwd(logits, labels, weights, lse, g, 0)
    weighted_ce_bwd.launches += launched
    return out


weighted_ce_bwd.launches = 0


def weighted_ce_shard_bwd(logits: torch.Tensor, labels: torch.Tensor,
                          weights: torch.Tensor, lse: torch.Tensor,
                          g: torch.Tensor, v0: int) -> torch.Tensor:
    """The backward's shard mode: dlogits of the vocab columns [v0, v0 +
    V) ``logits`` [T, V] from the whole vocab's ``lse``."""
    out, launched = _bwd(logits, labels, weights, lse, g, int(v0))
    weighted_ce_shard_bwd.launches += launched
    return out


weighted_ce_shard_bwd.launches = 0


def _bwd(logits, labels, weights, lse, g, v0: int):
    """The backward wrappers' checks and launch: (dlogits, whether the
    kernel was launched)."""
    _check(logits, labels, weights, ("lse", lse), ("g", g))
    if not on_card(logits, "weighted_ce_bwd"):
        return weighted_ce_bwd_plain(logits, labels, weights, lse, g,
                                     v0), False
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
            logits.stride(0), dlogits.stride(0), int(v0), stream)
    if status != 0:
        raise RuntimeError(f"weighted_ce_bwd launch failed with cudaError_t "
                           f"{status}")
    return dlogits, True
