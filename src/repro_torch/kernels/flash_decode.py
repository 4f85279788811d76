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

The kernel splits the valid positions over blocks (split-KV): a block
takes the query heads of one KV head (:func:`heads_per_block`) and one
chunk of the positions (:func:`split_plan`), and a second launch merges
each head's partial softmax states in a fixed order.  The plan is made
here, in Python, from the valid range (:func:`valid_range`), the grid's
other axis, the card's SM count and the rows a block loads at once
(:func:`rows_per_pass`).  The cache's rows are read in vectors
(:func:`check_cache_layout`).

:func:`flash_decode` launches the kernel for CUDA tensors and uses
:func:`flash_decode_plain` (the semantics of ``repro/kernels/ref.py``'s
``flash_decode``) only for CPU tensors; it never falls back from one to
the other.  It counts its launches in ``flash_decode.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._launch import current, on_card, raw_stream
from repro_torch.kernels.flash_attention import (DTYPES, MAX_HEAD_DIM,
                                                 NEG_INF, check_head_dim_last)


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


# --------------------------------------------------------------- the plan
BLOCKS_PER_SM = 4    # the split aims at this many blocks on each SM or more
CHUNK_ALIGN = 8      # chunk lengths are multiples of this many positions
MAX_SPLIT = 64       # the kernel's merge takes at most this many chunks
MAX_HEADS_PER_BLOCK = 8


def valid_range(pos: int, s: int, window: int | None) -> tuple[int, int]:
    """The valid positions [lo, hi] of a cache of ``s`` at ``pos``."""
    lo = 0 if window is None else max(0, pos - window + 1)
    return lo, min(pos, s - 1)


def heads_per_block(g: int) -> int:
    """Query heads one block takes of the ``g`` that share a KV head: all of
    them up to 8, else the largest power of two <= 8 that divides g."""
    gt = MAX_HEADS_PER_BLOCK
    while g % gt:
        gt //= 2
    return gt


def vector_of(dtype: torch.dtype) -> tuple[int, int]:
    """(bytes, values) of one load of a cache row of ``dtype``: 16 bytes
    of float32 or bfloat16, 8 of int8 (a 120-dim int8 row is only 8-byte
    aligned)."""
    return (8, 8) if dtype == torch.int8 else (16, 16 // dtype.itemsize)


def rows_per_pass(dtype: torch.dtype, d: int) -> int:
    """Cache rows a block loads at once, as the kernel lays them out: 4
    warps, L lanes a row (16 for a row of <= 128 values in 8-value
    vectors, else 32), 4 rows a lane group."""
    lanes = 16 if vector_of(dtype)[1] == 8 and d <= 128 else 32
    return 4 * (32 // lanes) * 4


def split_plan(lo: int, hi: int, blocks: int, sms: int,
               pass_rows: int) -> tuple[int, int]:
    """(n_split, chunk): block j of a row of ``n_split`` takes positions
    [lo + j * chunk, min(hi, lo + (j + 1) * chunk - 1)].  The chunk is a
    multiple of CHUNK_ALIGN positions, small enough for BLOCKS_PER_SM
    blocks on each of ``sms`` SMs over the ``blocks`` of the grid's other
    axis, and at most one pass of ``pass_rows`` (a block's loads all in
    flight at once), unless MAX_SPLIT chunks would not cover the range.
    No chunk is empty."""
    n = hi - lo + 1
    if n < 1 or blocks < 1 or sms < 1 or pass_rows < CHUNK_ALIGN:
        raise ValueError(f"no plan for positions [{lo}, {hi}], {blocks} "
                         f"blocks, {sms} SMs, {pass_rows} rows a pass")

    def align(x: int) -> int:
        return -(-x // CHUNK_ALIGN) * CHUNK_ALIGN

    want = -(-BLOCKS_PER_SM * sms // blocks)
    chunk = max(min(align(-(-n // want)), pass_rows // CHUNK_ALIGN
                    * CHUNK_ALIGN), align(-(-n // MAX_SPLIT)))
    return -(-n // chunk), chunk


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of card ``index`` (the plan's other input)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_cache_layout(*named: tuple[str, torch.Tensor]) -> None:
    """Raise unless each cache tensor is one the kernel reads in vectors:
    a head dim that is a multiple of the vector's values, and a base and
    every stride of an axis longer than 1 aligned to the vector."""
    for name, x in named:
        nbytes, values = vector_of(x.dtype)
        size, bad = x.element_size(), x.data_ptr() % nbytes
        bad |= x.shape[-1] % values
        for n, st in zip(x.shape[:-1], x.stride()[:-1]):
            if n > 1:
                bad |= st * size % nbytes
        if bad:
            raise ValueError(
                f"{name}: the kernel reads {x.dtype} rows {nbytes} bytes "
                f"({values} values) at a time: head dim {x.shape[-1]}, "
                f"strides {tuple(x.stride())}, base at "
                f"{x.data_ptr() % nbytes} bytes past a {nbytes}-byte "
                f"boundary")


# -------------------------------------------------------------- the kernel
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("flash_decode")
    if lib.flash_decode.argtypes is None:
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_decode.argtypes = [p] * 8 + [i32] * 12 + [
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
    check_cache_layout(("k", k), ("v", v))
    b, h, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    quant = k_scale is not None
    lo, hi = valid_range(pos, s, window)
    gt = heads_per_block(h // kv)
    n_split, chunk = split_plan(lo, hi, b * h // gt, sm_count(q.device.index),
                                rows_per_pass(k.dtype, d))
    out = q.new_empty((b, h, d))
    # the blocks' partials: acc [B * H, n_split, D], then (m, l) pairs
    scratch = q.new_empty(b * h * n_split * (d + 2), dtype=torch.float32)
    part_ml = scratch.data_ptr() + 4 * b * h * n_split * d
    ks, vs = (k_scale, v_scale) if quant else (k, v)  # strides unused
    strides = (ctypes.c_int64 * 16)(
        *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *ks.stride()[:3],
        *vs.stride()[:3], *out.stride()[:2])
    with current(q.device):
        status = _lib().flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, out.data_ptr(),
            scratch.data_ptr(), part_ml, DTYPES[q.dtype], int(quant), b, h,
            kv, s, d, lo, hi, chunk, n_split, gt, 1.0 / math.sqrt(d),
            strides, raw_stream(q.device))
    if status != 0:
        raise RuntimeError(f"flash_decode launch failed with cudaError_t "
                           f"{status}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
