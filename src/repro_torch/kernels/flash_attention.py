"""Blocked online-softmax (flash) attention, causal and sliding-window, with
grouped-query heads: CUDA kernel and plain version.

Counterpart of ``repro/kernels/flash_attention.py``, whose Pallas TPU
kernel this replaces with ``csrc/flash_attention.cu`` (built by
:mod:`._build`).  The dtype picks the kernel (:func:`kernel_for`):
bfloat16 runs on the tensor cores (wgmma, K/V through TMA), float32 on the
CUDA cores (the repository's float32 rule keeps TF32 off).  Layouts as in
the reference: q [B, H, S, D], k/v [B, KV, T, D] with H % KV == 0 (the KV
head of query head h is h // (H / KV)); queries are right-aligned against
the keys (offset T - S); scale 1/sqrt(D).  Unlike the TPU kernel it takes
any S <= T and any T (the ragged last tiles are masked), and any strides
with a unit stride on D, so the model hands it its [B, S, H, D]
activations as permuted views; the bfloat16 kernel also needs what TMA
needs (:func:`check_tma_layout`).  The output is allocated [B, S, H, D] in
memory and returned as its [B, H, S, D] view, so the model's merge of the
heads is free.

:func:`flash_attention` launches the kernel for CUDA tensors and uses
:func:`flash_attention_plain` (the semantics of ``repro/kernels/ref.py``'s
``flash_attention``) only for CPU tensors; it never falls back from one to
the other.  It counts its launches in ``flash_attention.launches``.
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from repro_torch.kernels.quantize import on_card

NEG_INF = -1e30
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNELS = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
TMA_ALIGN = 16  # bytes: TMA's rule for bases and strides


# ------------------------------------------------------------ plain version
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """Dense attention in float32 with the kernel's masking: [B, H, S, D]
    in q's dtype."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, s, d).to(torch.float32)
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.to(torch.float32))
    scores = scores / math.sqrt(d)
    q_pos = torch.arange(s, device=q.device)[:, None] + (t - s)
    k_pos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.to(torch.float32))
    return out.reshape(b, h, s, d).to(q.dtype)


# -------------------------------------------------------------- the kernel
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    for name in KERNELS.values():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            p, i32 = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, p, p] + [i32] * 8 + [
                ctypes.c_float, ctypes.POINTER(ctypes.c_int64), p]
            fn.restype = ctypes.c_int
    return lib


def kernel_for(dtype: torch.dtype) -> str:
    """The C entry point that takes ``dtype``: the tensor-core kernel for
    bfloat16, the CUDA-core kernel for float32; no other dtype has one."""
    if dtype not in KERNELS:
        raise TypeError(f"no flash_attention kernel for {dtype}")
    return KERNELS[dtype]


def check_tma_layout(*named: tuple[str, torch.Tensor]) -> None:
    """Raise unless each tensor is one TMA can copy in boxes: a head dim
    of a multiple of 16 bytes (8 bf16), and a 16-byte aligned base and
    stride on every other axis longer than 1."""
    for name, x in named:
        size, bad = x.element_size(), x.data_ptr() % TMA_ALIGN
        bad |= x.shape[-1] * size % TMA_ALIGN
        for n, st in zip(x.shape[:-1], x.stride()[:-1]):
            if n > 1:
                bad |= st * size % TMA_ALIGN
        if bad:
            raise ValueError(
                f"{name}: the tensor-core kernel reads {TMA_ALIGN}-byte "
                f"aligned rows (TMA): head dim {x.shape[-1]}, strides "
                f"{tuple(x.stride())}, base at {x.data_ptr() % TMA_ALIGN} "
                f"bytes past a {TMA_ALIGN}-byte boundary")


def current(device: torch.device):
    """A context in which ``device`` is the current card; none when it
    already is, which saves the switch's host time on every call."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, read as PyTorch's own
    launchers read it: without building a ``torch.cuda.Stream`` object for
    its ``cuda_stream`` on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_head_dim_last(name: str, x: torch.Tensor) -> None:
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must have a unit stride on its last axis "
                         f"(D), got strides {tuple(x.stride())}")


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-d, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kv, t, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [{b}, KV, T, {d}] alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"query heads {h} are not a multiple of KV heads "
                         f"{kv}")
    if not 1 <= s <= t:
        raise ValueError(f"need 1 <= S <= T (right-aligned queries), got "
                         f"S={s} T={t}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, "
                         f"{v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Attention of q [B, H, S, D] against k/v [B, KV, T, D] (float32 or
    bfloat16), causal and with an optional sliding window: [B, H, S, D] in
    q's dtype."""
    _check(q, k, v, window)
    if not on_card(q, "flash_attention"):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_head_dim_last(name, x)
    kernel = kernel_for(q.dtype)
    if q.dtype == torch.bfloat16:
        check_tma_layout(("q", q), ("k", k), ("v", v))
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    if -(-s // 64) > 65535:
        raise ValueError(f"S={s} exceeds the kernel's grid")
    out = torch.empty_strided((b, h, s, d), (s * h * d, d, h * d, 1),
                              dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with current(q.device):
        status = getattr(_lib(), kernel)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kv, s, t, d, int(causal),
            0 if window is None else window, 1.0 / math.sqrt(d), strides,
            raw_stream(q.device))
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError_t "
                           f"{status}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
