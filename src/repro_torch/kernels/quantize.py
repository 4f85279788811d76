"""Fused quantize-dequant and int4 packing for the wire codecs: CUDA kernels
and their plain versions.

Counterpart of ``repro/kernels/quantize.py``, whose four Pallas TPU kernels
this replaces with ``csrc/quantize.cu`` (built by :mod:`._build`):

  * :func:`quantize_dequant_tiles` -- per-tile symmetric quantization of a
    length-n vector (the int8/int4 codec on every training hop);
  * :func:`quantize_dequant_block` -- the same body over the row tiles of an
    [n, k] score block (the serve codec);
  * :func:`pack_int4` / :func:`unpack_int4` -- two int4 values per wire
    byte, the int4 codec's ``encode``/``decode``.

Per tile: ``scale = max(|x|, 1e-12) * float32(1/qmax)``,
``q = clip(floor(x / scale + u), -qmax, qmax)``, ``xhat = q * scale``.
The scale is a product with the rounded reciprocal, not a quotient: the
reference's channel runs its kernel under ``jit`` with a constant qmax, and
XLA rewrites the division by that constant into this product (a quotient
and the product differ in the last bit for about half of all absmax values
at qmax = 7).  ``x / scale`` stays a true division, as in the reference.

Both quantize-dequant wrappers make one launch: one CTA a tile of up to
1024 elements, one thread-block cluster a larger tile (every main-path
payload is one global tile), laid out by :func:`plan`; a tile above
``LARGE_TILE`` takes two launches (see the source's note).

Each wrapper launches its kernel for CUDA tensors and uses the plain
version below only for CPU tensors; it never falls back from one to the
other.  Each counts its launches in a plain integer attribute
(``quantize_dequant_tiles.launches`` and so on).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels._launch import (check_status, current, on_card,
                                         raw_stream)

DEFAULT_BN = 1024
_EPS = 1e-12
THREADS = 512             # a CTA of the fused kernel
CTA_TILE = 1024           # tiles up to this size take one CTA
MAX_PER_THREAD = 64       # elements a thread holds in registers
PORTABLE_CLUSTER = 8
MAX_CLUSTER = 16
LARGE_TILE = 2 ** 18      # above it, the large-n route


def tile_for(n: int, bn: int = DEFAULT_BN) -> int:
    """The tile size used for a length-n vector: ``bn`` when it divides n
    evenly, else one global tile (the reference's rule)."""
    return bn if (n >= bn and n % bn == 0) else n


def rows_for(n: int, k: int, bn: int = DEFAULT_BN) -> int:
    """Row tile for an [n, k] row-major block: ``bn // k`` rows when that
    divides n evenly, else one global tile (the reference's rule)."""
    return tile_for(n, max(1, bn // k))


class Plan(NamedTuple):
    """A launch of the quantize-dequant kernel for tiles of one size:
    each tile taken by ``cluster`` CTAs of ``per_cta`` elements (the last
    fewer); one CTA a tile when ``cluster`` is 1."""
    route: str            # "cta", "cluster" or "large"
    cluster: int
    per_cta: int


@functools.lru_cache(maxsize=None)
def plan(tile: int, cluster_limit: int = PORTABLE_CLUSTER) -> Plan:
    """The launch for tiles of ``tile`` elements on a card whose clusters
    may hold ``cluster_limit`` CTAs (8, or 16 where it fits): one CTA for a
    tile of up to ``CTA_TILE``; else one cluster a tile, with as many CTAs
    as the limit allows up to one per ``CTA_TILE`` elements, each share a
    multiple of 32 elements (whole warps' loads), no CTA empty.  Above
    ``LARGE_TILE`` the large-n route (two launches)."""
    if tile < 1:
        raise ValueError(f"no plan for a tile of {tile}")
    if cluster_limit not in (PORTABLE_CLUSTER, MAX_CLUSTER):
        raise ValueError(f"cluster limit {cluster_limit} is neither "
                         f"{PORTABLE_CLUSTER} nor {MAX_CLUSTER}")
    if tile > LARGE_TILE:
        return Plan("large", 1, CTA_TILE)
    if tile <= CTA_TILE:
        return Plan("cta", 1, tile)
    cluster = min(cluster_limit, -(-tile // CTA_TILE))
    per_cta = -(-tile // cluster)
    per_cta = -(-per_cta // 32) * 32
    return Plan("cluster", -(-tile // per_cta), per_cta)


@functools.lru_cache(maxsize=None)
def inv_qmax(qmax) -> float:
    """``float32(1) / float32(qmax)``: the reciprocal the scale multiplies
    by, rounded once in float32 as XLA folds it."""
    return float(np.float32(1.0) / np.float32(qmax))


# ----------------------------------------------------------- plain versions
def _quantize_flat(x: torch.Tensor, u: torch.Tensor, qmax, tile: int):
    """The kernel's arithmetic on a flat payload in tiles of ``tile``
    contiguous elements: (xhat, q int8, scales), all flat."""
    xt = x.reshape(-1, tile).to(torch.float32)
    ut = u.reshape(-1, tile).to(torch.float32)
    qm = float(np.float32(qmax))
    scale = torch.clamp(xt.abs().amax(dim=1), min=_EPS) * inv_qmax(qmax)
    q = torch.clamp(torch.floor(xt / scale[:, None] + ut), -qm, qm)
    return ((q * scale[:, None]).reshape(-1), q.to(torch.int8).reshape(-1),
            scale)


def quantize_dequant_plain(x: torch.Tensor, u: torch.Tensor, qmax,
                           bn: int = DEFAULT_BN):
    """Per-tile quantize-dequant of a length-n vector in PyTorch ops:
    (xhat [n] f32, q [n] int8, scales [n / tile_for(n)] f32)."""
    return _quantize_flat(x, u, qmax, tile_for(x.shape[0], bn))


def quantize_dequant_block_plain(x: torch.Tensor, u: torch.Tensor, qmax,
                                 bn: int = DEFAULT_BN):
    """Row-tiled quantize-dequant of an [n, k] block in PyTorch ops:
    (xhat [n, k] f32, q [n, k] int8, scales [n / rows_for(n, k)] f32)."""
    n, k = x.shape
    xhat, q, scales = _quantize_flat(x, u, qmax, rows_for(n, k, bn) * k)
    return xhat.reshape(n, k), q.reshape(n, k), scales


def pack_int4_plain(q: torch.Tensor) -> torch.Tensor:
    """Two int4 values (int8 carriers in [-8, 7]) per byte, element 2i in
    the low nibble; an odd count pads the last high nibble with 0.
    Returns a flat int8 tensor of ceil(numel / 2) bytes."""
    flat = q.reshape(-1).to(torch.int8)
    if flat.shape[0] % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    pairs = flat.view(-1, 2)
    return (pairs[:, 0] & 0x0F) | ((pairs[:, 1] & 0x0F) << 4)


def unpack_int4_plain(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4_plain`: n int8-carried int4 values, the
    nibbles sign-extended by arithmetic shifts."""
    p = packed.to(torch.int8)
    lo = (p << 4) >> 4
    hi = p >> 4
    return torch.stack([lo, hi], dim=-1).reshape(-1)[:n]


# -------------------------------------------------------------- the kernels
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("quantize")
    if lib.quantize_dequant.argtypes is None:
        p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_float)
        lib.quantize_dequant.argtypes = [p, p, p, p, p, i64, i64, i32, i64,
                                         f32, f32, p]
        lib.quantize_dequant_large.argtypes = [p, p, p, p, p, p, i64, i64,
                                               f32, f32, p]
        lib.quantize_max_cluster.argtypes = [ctypes.POINTER(i32)]
        lib.pack_int4.argtypes = [p, p, i64, p]
        lib.unpack_int4.argtypes = [p, p, i64, p]
        for fn in (lib.quantize_dequant, lib.quantize_dequant_large,
                   lib.quantize_max_cluster, lib.pack_int4, lib.unpack_int4):
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def cluster_limit(index: int) -> int:
    """The largest cluster the kernel may take on card ``index`` (the
    plan's other input), asked of the CUDA runtime once.  Call it with the
    card current: it also allows the kernel the non-portable size."""
    out = ctypes.c_int(0)
    check_status("quantize_max_cluster",
                 _lib().quantize_max_cluster(ctypes.byref(out)))
    return out.value


def _check(name: str, x: torch.Tensor, dtype: torch.dtype,
           shape: tuple, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} lies on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_qmax(qmax) -> float:
    qmax = float(qmax)
    if not (qmax >= 1.0 and qmax <= 127.0):
        raise ValueError(f"qmax must lie in [1, 127] (an int8 carrier), "
                         f"got {qmax}")
    return qmax


def _launch_quantize(x: torch.Tensor, u: torch.Tensor, qmax: float,
                     tile: int):
    """The CUDA quantize-dequant on a flat payload in tiles of ``tile``
    elements, one launch (two on the large-n route); returns flat (xhat, q,
    scales)."""
    n, dev = x.numel(), x.device
    xhat = torch.empty(n, dtype=torch.float32, device=dev)
    q = torch.empty(n, dtype=torch.int8, device=dev)
    scales = torch.empty(n // tile, dtype=torch.float32, device=dev)
    with current(dev):
        p = plan(tile, cluster_limit(dev.index))
        stream = raw_stream(dev)
        if p.route != "large":
            status = _lib().quantize_dequant(
                x.data_ptr(), u.data_ptr(), xhat.data_ptr(), q.data_ptr(),
                scales.data_ptr(), n, tile, p.cluster, p.per_cta, qmax,
                inv_qmax(qmax), stream)
        else:       # the large-n route's chunk maxima are its scratch
            chunks = torch.empty((n // tile) * -(-tile // CTA_TILE),
                                 dtype=torch.float32, device=dev)
            status = _lib().quantize_dequant_large(
                x.data_ptr(), u.data_ptr(), xhat.data_ptr(), q.data_ptr(),
                scales.data_ptr(), chunks.data_ptr(), n, tile, qmax,
                inv_qmax(qmax), stream)
    check_status("quantize_dequant", status)
    return xhat, q, scales


def quantize_dequant_tiles(x: torch.Tensor, u: torch.Tensor, qmax, *,
                           bn: int = DEFAULT_BN):
    """Per-tile symmetric quantization of a length-n float32 vector ``x``
    with rounding draws ``u`` in [0, 1) (0.5 = round half up).  Returns
    ``(xhat [n] f32, q [n] int8, scales [n / tile_for(n, bn)] f32)``."""
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"x must be a non-empty vector, got {tuple(x.shape)}")
    qmax = _check_qmax(qmax)
    n = x.shape[0]
    _check("x", x, torch.float32, (n,), x.device)
    _check("u", u, torch.float32, (n,), x.device)
    if not on_card(x, "quantize"):
        return quantize_dequant_plain(x, u, qmax, bn)
    out = _launch_quantize(x, u, qmax, tile_for(n, bn))
    quantize_dequant_tiles.launches += 1
    return out


quantize_dequant_tiles.launches = 0


def quantize_dequant_block(x: torch.Tensor, u: torch.Tensor, qmax, *,
                           bn: int = DEFAULT_BN):
    """Row-tiled quantization of an [n, k] float32 score block: tiles of
    ``rows_for(n, k, bn)`` rows share one scale.  Returns
    ``(xhat [n, k] f32, q [n, k] int8, scales [n / rows] f32)``."""
    if x.dim() != 2 or x.numel() < 1:
        raise ValueError(f"x must be a non-empty [n, k] block, got "
                         f"{tuple(x.shape)}")
    qmax = _check_qmax(qmax)
    n, k = x.shape
    _check("x", x, torch.float32, (n, k), x.device)
    _check("u", u, torch.float32, (n, k), x.device)
    if not on_card(x, "quantize"):
        return quantize_dequant_block_plain(x, u, qmax, bn)
    xhat, q, scales = _launch_quantize(x, u, qmax, rows_for(n, k, bn) * k)
    quantize_dequant_block.launches += 1
    return xhat.view(n, k), q.view(n, k), scales


quantize_dequant_block.launches = 0


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8-carried int4 values (any shape, row-major order) into a
    flat int8 tensor of ceil(numel / 2) wire bytes."""
    if q.numel() < 1:
        raise ValueError("pack_int4 needs at least one value")
    _check("q", q, torch.int8, tuple(q.shape), q.device)
    if not on_card(q, "pack_int4"):
        return pack_int4_plain(q)
    m = q.numel()
    packed = torch.empty((m + 1) // 2, dtype=torch.int8, device=q.device)
    with current(q.device):
        status = _lib().pack_int4(q.data_ptr(), packed.data_ptr(), m,
                                  raw_stream(q.device))
    check_status("pack_int4", status)
    pack_int4.launches += 1
    return packed


pack_int4.launches = 0


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack :func:`pack_int4` wire bytes back to ``n`` int8-carried int4
    values (flat; callers reshape)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"unpack_int4 needs n >= 1, got {n}")
    if packed.dim() != 1 or packed.shape[0] != (n + 1) // 2:
        raise ValueError(f"{tuple(packed.shape)} packed bytes cannot hold "
                         f"{n} int4 values")
    _check("packed", packed, torch.int8, tuple(packed.shape), packed.device)
    if not on_card(packed, "unpack_int4"):
        return unpack_int4_plain(packed, n)
    q = torch.empty(n, dtype=torch.int8, device=packed.device)
    with current(packed.device):
        status = _lib().unpack_int4(packed.data_ptr(), q.data_ptr(), n,
                                    raw_stream(packed.device))
    check_status("unpack_int4", status)
    unpack_int4.launches += 1
    return q


unpack_int4.launches = 0
