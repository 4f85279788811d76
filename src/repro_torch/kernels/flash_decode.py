"""Flash-decode: one query row per (batch, head) against a KV cache, with an
optional sliding window and an optional int8 cache: CUDA kernel and plain
version.

Counterpart of ``repro/kernels/flash_decode.py``, whose Pallas TPU kernel
this replaces with ``csrc/flash_decode.cu`` (built by :mod:`._build`).
Layouts as in the reference: q [B, H, D]; k/v [B, KV, S, D] (q's dtype, or
int8 with k_scale/v_scale [B, KV, S] float32); output [B, H, D] in q's
dtype.  Position t is valid when t <= pos and, with a window W,
t > pos - W.  The int8 cache is dequantized in the kernel's registers;
no float copy of the cache is made.  Unlike the TPU kernel it takes any S,
and any strides with a unit stride on D, so the model hands it its
[B, S, KV, D] cache and [B, S, KV] scales as permuted views; ``pos`` is a
host integer in [0, S).

:func:`flash_decode` launches the kernel for CUDA tensors and uses
:func:`flash_decode_plain` (the semantics of ``repro/kernels/ref.py``'s
``flash_decode``) only for CPU tensors; it never falls back from one to
the other.  It counts its launches in ``flash_decode.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.flash_attention import (DTYPES, MAX_HEAD_DIM,
                                                 NEG_INF, check_head_dim_last)
from repro_torch.kernels.quantize import on_card


# ------------------------------------------------------------ plain version
def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos: int, *, k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None,
                       window: int | None = None) -> torch.Tensor:
    """Dense single-row attention in float32 with the kernel's masking:
    [B, H, D] in q's dtype."""
    k, v = k.to(torch.float32), v.to(torch.float32)
    if k_scale is not None:
        k = k * k_scale[..., None]
        v = v * v_scale[..., None]
    b, h, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, d).to(torch.float32)
    scores = torch.einsum("bkgd,bktd->bkgt", qg, k) / math.sqrt(d)
    idx = torch.arange(s, device=q.device)
    valid = idx <= pos
    if window is not None:
        valid &= idx > pos - window
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,bktd->bkgd", probs, v)
    return out.reshape(b, h, d).to(q.dtype)


# -------------------------------------------------------------- the kernel
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("flash_decode")
    if lib.flash_decode.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_decode.argtypes = [p] * 6 + [i32] * 9 + [
            ctypes.c_float, ctypes.POINTER(ctypes.c_int64), p]
        lib.flash_decode.restype = ctypes.c_int
    return lib


def _check(q, k, v, pos, k_scale, v_scale, window) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be [B, H, D] and k/v [B, KV, S, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kv, s, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [{b}, KV, S, {d}] alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"query heads {h} are not a multiple of KV heads "
                         f"{kv}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if not 0 <= pos < s:
        raise ValueError(f"pos must lie in [0, {s}), got {pos}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("give both k_scale and v_scale, or neither")
    want = q.dtype if k_scale is None else torch.int8
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"k and v must be {want}, got {k.dtype}, {v.dtype}")
    tensors = [k, v]
    if k_scale is not None:
        for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if x.dtype != torch.float32 or tuple(x.shape) != (b, kv, s):
                raise ValueError(f"{name} must be float32 [{b}, {kv}, {s}], "
                                 f"got {x.dtype} {tuple(x.shape)}")
        tensors += [k_scale, v_scale]
    if any(x.device != q.device for x in tensors):
        raise ValueError("q and the cache lie on different devices")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, *,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None,
                 window: int | None = None) -> torch.Tensor:
    """Attention of one query row per (batch, head), q [B, H, D], against
    positions <= pos (and > pos - window) of the cache k/v [B, KV, S, D]:
    [B, H, D] in q's dtype.  With ``k_scale``/``v_scale`` the cache is int8
    and is dequantized in registers."""
    pos = int(pos)
    _check(q, k, v, pos, k_scale, v_scale, window)
    if not on_card(q, "flash_decode"):
        return flash_decode_plain(q, k, v, pos, k_scale=k_scale,
                                  v_scale=v_scale, window=window)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_head_dim_last(name, x)
    b, h, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    quant = k_scale is not None
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    ks, vs = (k_scale, v_scale) if quant else (k, v)  # strides unused
    strides = (ctypes.c_int64 * 16)(
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *ks.stride()[:3],
        *vs.stride()[:3], *out.stride()[:2])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        status = _lib().flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, out.data_ptr(),
            DTYPES[q.dtype], int(quant), b, h, kv, s, d, pos,
            0 if window is None else window, 1.0 / math.sqrt(d), strides,
            stream)
    if status != 0:
        raise RuntimeError(f"flash_decode launch failed with cudaError_t "
                           f"{status}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
