"""Fused quantize-dequant and the int4 wire for the codecs: CUDA kernels and
their plain versions.

Counterpart of ``repro/kernels/quantize.py``, whose four Pallas TPU kernels
this replaces with ``csrc/quantize.cu`` (built by :mod:`._build`):

  * :func:`quantize_dequant_tiles` -- per-tile symmetric quantization of a
    length-n vector (the int8/int4 codec on every training hop);
  * :func:`quantize_dequant_block` -- the same body over the row tiles of an
    [n, k] score block (the serve codec);
  * :func:`pack_int4` / :func:`unpack_int4` -- two int4 values per wire
    byte, the reference's ``ops.pack_int4`` / ``ops.unpack_int4``;
  * :func:`quantize_pack_int4` / :func:`unpack_dequant_int4` -- the int4
    codec's ``encode`` and ``decode``, one launch each: the quantize with
    the pack as its epilogue (no xhat, no int8 q), and the unpack with the
    dequantize.  A payload of several odd tiles (pairs straddle two tiles),
    or one whose x or u is an offset view off an 8-byte boundary, encodes
    in two launches, the quantize-dequant and then the pack.

Per tile: ``scale = max(|x|, 1e-12) * float32(1/qmax)``,
``q = clip(floor(x / scale + u), -qmax, qmax)``, ``xhat = q * scale``.
The scale is a product with the rounded reciprocal, not a quotient: the
reference's channel runs its kernel under ``jit`` with a constant qmax, and
XLA rewrites the division by that constant into this product (a quotient
and the product differ in the last bit for about half of all absmax values
at qmax = 7).  ``x / scale`` stays a true division, as in the reference.

Both quantize-dequant wrappers and the int4 encode make one launch: one
CTA a tile of up to 1024 elements, one thread-block cluster a larger tile
(every main-path payload is one global tile), laid out by :func:`plan`; a
tile above ``LARGE_TILE`` takes two launches (see the source's note).

Each wrapper launches its kernel for CUDA tensors and uses the plain
version below only for CPU tensors; it never falls back from one to the
other.  Each counts its launches in a plain integer attribute
(``quantize_dequant_tiles.launches`` and so on).

The ``*_rows`` functions take F payloads at once, rows of an [F, ...]
batch (``kernels.ops``' vmap rules call them for a fleet): the same
kernels, one launch on the flat [F·m] payload in the tiles each payload
alone would use, so no tile spans two rows and each row gets the bits of
its own call.  They count under the single calls' counters, except
:func:`quantize_dequant_block_rows` (the serve step's blocks over a
bucket's slots), which counts its own.

The two quantize-dequant batches also take the range as a device operand,
a float32 tensor of one ``qmax`` a row: the quantization sweep
(``core.compiled.quant_sweep_run``) runs S sessions at S ranges as one
vmapped program, so a hop's S payloads are one launch in which each row
reads its own range and the kernel forms ``1.0f / qmax`` (the correctly
rounded quotient, which is :func:`inv_qmax`).  Row f gives the bits of
the lone call at the float ``qmax[f]``; the launch counts under the same
counter as the batch's float route.
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
    contiguous elements: (xhat, q int8, scales), all flat.  ``qmax`` is a
    number, or a float32 tensor of one range a row of the flat payload
    (its tiles split evenly into rows): the device-operand route, whose
    reciprocal is the float32 quotient the kernel forms."""
    xt = x.reshape(-1, tile).to(torch.float32)
    ut = u.reshape(-1, tile).to(torch.float32)
    if isinstance(qmax, torch.Tensor):
        rows = qmax.reshape(-1).to(torch.float32)
        qm = rows.repeat_interleave(xt.shape[0] // rows.shape[0])[:, None]
        inv = 1.0 / qm[:, 0]
    else:
        qm = float(np.float32(qmax))
        inv = inv_qmax(qmax)
    scale = torch.clamp(xt.abs().amax(dim=1), min=_EPS) * inv
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


def quantize_pack_int4_plain(x: torch.Tensor, u: torch.Tensor, qmax,
                             tile: int):
    """The int4 encode in PyTorch ops, per tile of ``tile`` contiguous
    elements of the flat payload: (packed [ceil(numel / 2)] int8, scales
    [numel / tile] f32)."""
    _, q, scales = _quantize_flat(x, u, qmax, tile)
    return pack_int4_plain(q), scales


def unpack_dequant_int4_plain(packed: torch.Tensor, scales: torch.Tensor,
                              n: int, tile: int) -> torch.Tensor:
    """The int4 decode in PyTorch ops: the flat xhat [n], each value times
    its tile's scale (one float32 product, as the reference's decode)."""
    q = unpack_int4_plain(packed, n).to(torch.float32)
    return (q.reshape(-1, tile) * scales[:, None]).reshape(-1)


def unpack_dequant_int4_rows_plain(packed: torch.Tensor,
                                   scales: torch.Tensor, n: int,
                                   tile: int) -> torch.Tensor:
    """:func:`unpack_dequant_int4_plain` of each row of ``packed`` [F,
    ceil(n / 2)] with ``scales`` [F, n / tile]: xhat [F, n]."""
    rows = packed.shape[0]
    q = unpack_int4_plain(packed, rows * (packed.shape[1] * 2))
    q = q.view(rows, -1)[:, :n].to(torch.float32)
    return (q.reshape(rows, -1, tile) * scales[:, :, None]).reshape(rows, n)


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
        lib.quantize_dequant_qmax.argtypes = [p, p, p, p, p, i64, i64, i32,
                                              i64, p, i64, p]
        lib.quantize_dequant_qmax_large.argtypes = [p, p, p, p, p, p, i64,
                                                    i64, p, i64, p]
        lib.quantize_pack_int4.argtypes = [p, p, p, p, i64, i64, i32, i64,
                                           f32, f32, p]
        lib.quantize_pack_int4_large.argtypes = [p, p, p, p, p, i64, i64,
                                                 f32, f32, p]
        lib.quantize_max_cluster.argtypes = [ctypes.POINTER(i32)]
        lib.pack_int4.argtypes = [p, p, i64, p]
        lib.unpack_int4.argtypes = [p, p, i64, p]
        lib.unpack_dequant_int4.argtypes = [p, p, p, i64, i64, p]
        lib.unpack_dequant_int4_rows.argtypes = [p, p, p, i64, i64, i64, p]
        for fn in (lib.quantize_dequant, lib.quantize_dequant_large,
                   lib.quantize_dequant_qmax, lib.quantize_dequant_qmax_large,
                   lib.quantize_pack_int4, lib.quantize_pack_int4_large,
                   lib.quantize_max_cluster, lib.pack_int4, lib.unpack_int4,
                   lib.unpack_dequant_int4, lib.unpack_dequant_int4_rows):
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


def _check_qmax(qmax, top: float = 127.0) -> float:
    qmax = float(qmax)
    if not (qmax >= 1.0 and qmax <= top):
        raise ValueError(f"qmax must lie in [1, {top:g}] (an "
                         f"{'int4' if top < 127 else 'int8'} carrier), got "
                         f"{qmax}")
    return qmax


def _check_tile(n: int, tile: int) -> int:
    tile = int(tile)
    if n < 1 or tile < 1 or n % tile:
        raise ValueError(f"a payload of {n} elements does not split into "
                         f"tiles of {tile}")
    return tile


def _launch_quantize(x: torch.Tensor, u: torch.Tensor, qmax, tile: int):
    """The CUDA quantize-dequant on a flat payload in tiles of ``tile``
    elements, one launch (two on the large-n route); returns flat (xhat, q,
    scales).  ``qmax`` is a float passed by value, or a contiguous float32
    tensor on the payload's card of one range a row (the payload's tiles
    split evenly into its rows), which the kernel reads."""
    n, dev = x.numel(), x.device
    xhat = torch.empty(n, dtype=torch.float32, device=dev)
    q = torch.empty(n, dtype=torch.int8, device=dev)
    scales = torch.empty(n // tile, dtype=torch.float32, device=dev)
    with current(dev):
        p = plan(tile, cluster_limit(dev.index))
        stream = raw_stream(dev)
        if isinstance(qmax, torch.Tensor):
            status = _launch_qmax_rows(x, u, xhat, q, scales, qmax, n, tile,
                                       p, stream)
        elif p.route != "large":
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


def _launch_qmax_rows(x, u, xhat, q, scales, qmax: torch.Tensor, n: int,
                      tile: int, p: Plan, stream: int) -> int:
    """The device-qmax launch of :func:`_launch_quantize`: one range a
    row of ``n // tile // qmax.numel()`` tiles, read by the kernel."""
    per_row = n // tile // qmax.numel()
    if p.route != "large":
        return _lib().quantize_dequant_qmax(
            x.data_ptr(), u.data_ptr(), xhat.data_ptr(), q.data_ptr(),
            scales.data_ptr(), n, tile, p.cluster, p.per_cta,
            qmax.data_ptr(), per_row, stream)
    chunks = torch.empty((n // tile) * -(-tile // CTA_TILE),
                         dtype=torch.float32, device=x.device)
    return _lib().quantize_dequant_qmax_large(
        x.data_ptr(), u.data_ptr(), xhat.data_ptr(), q.data_ptr(),
        scales.data_ptr(), chunks.data_ptr(), n, tile, qmax.data_ptr(),
        per_row, stream)


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


def _launch_pack(q: torch.Tensor) -> torch.Tensor:
    """The CUDA pack of a contiguous int8 tensor: its flat wire bytes."""
    m = q.numel()
    packed = torch.empty((m + 1) // 2, dtype=torch.int8, device=q.device)
    with current(q.device):
        status = _lib().pack_int4(q.data_ptr(), packed.data_ptr(), m,
                                  raw_stream(q.device))
    check_status("pack_int4", status)
    return packed


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8-carried int4 values (any shape, row-major order) into a
    flat int8 tensor of ceil(numel / 2) wire bytes."""
    if q.numel() < 1:
        raise ValueError("pack_int4 needs at least one value")
    _check("q", q, torch.int8, tuple(q.shape), q.device)
    if not on_card(q, "pack_int4"):
        return pack_int4_plain(q)
    packed = _launch_pack(q)
    pack_int4.launches += 1
    return packed


pack_int4.launches = 0


def _check_wire(packed: torch.Tensor, n: int) -> int:
    n = int(n)
    if n < 1:
        raise ValueError(f"unpacking needs n >= 1, got {n}")
    if packed.dim() != 1 or packed.shape[0] != (n + 1) // 2:
        raise ValueError(f"{tuple(packed.shape)} packed bytes cannot hold "
                         f"{n} int4 values")
    _check("packed", packed, torch.int8, tuple(packed.shape), packed.device)
    return n


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack :func:`pack_int4` wire bytes back to ``n`` int8-carried int4
    values (flat; callers reshape)."""
    n = _check_wire(packed, n)
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


def quantize_pack_int4(x: torch.Tensor, u: torch.Tensor, qmax, tile: int):
    """The int4 codec's encode of a float32 payload ``x`` (any shape,
    row-major) with rounding draws ``u`` of its shape, in tiles of ``tile``
    contiguous elements that share a scale: ``(packed [ceil(numel / 2)]
    int8, scales [numel / tile] f32)``, the wire of :func:`pack_int4` over
    the quantize-dequant's q.  One launch, whose epilogue packs; a payload
    of several odd tiles, or x or u off an 8-byte boundary, takes the
    quantize-dequant and then the pack."""
    qmax = _check_qmax(qmax, 7.0)
    n = x.numel()
    tile = _check_tile(n, tile)
    _check("x", x, torch.float32, tuple(x.shape), x.device)
    _check("u", u, torch.float32, tuple(x.shape), x.device)
    if not on_card(x, "quantize_pack_int4"):
        return quantize_pack_int4_plain(x, u, qmax, tile)
    if (tile % 2 and n != tile) or x.data_ptr() % 8 or u.data_ptr() % 8:
        # a byte's pair would straddle two CTAs, or x and u cannot be read
        # in 8-byte pairs: quantize, then pack, each counted as its own
        _, q, scales = _launch_quantize(x, u, qmax, tile)
        qd = quantize_dequant_block if x.dim() == 2 else quantize_dequant_tiles
        qd.launches += 1
        packed = _launch_pack(q)
        pack_int4.launches += 1
        return packed, scales
    dev = x.device
    packed = torch.empty((n + 1) // 2, dtype=torch.int8, device=dev)
    scales = torch.empty(n // tile, dtype=torch.float32, device=dev)
    with current(dev):
        p = plan(tile, cluster_limit(dev.index))
        stream = raw_stream(dev)
        if p.route != "large":
            status = _lib().quantize_pack_int4(
                x.data_ptr(), u.data_ptr(), packed.data_ptr(),
                scales.data_ptr(), n, tile, p.cluster, p.per_cta, qmax,
                inv_qmax(qmax), stream)
        else:
            chunks = torch.empty((n // tile) * -(-tile // CTA_TILE),
                                 dtype=torch.float32, device=dev)
            status = _lib().quantize_pack_int4_large(
                x.data_ptr(), u.data_ptr(), packed.data_ptr(),
                scales.data_ptr(), chunks.data_ptr(), n, tile, qmax,
                inv_qmax(qmax), stream)
    check_status("quantize_pack_int4", status)
    quantize_pack_int4.launches += 1
    return packed, scales


quantize_pack_int4.launches = 0


def unpack_dequant_int4(packed: torch.Tensor, scales: torch.Tensor, n: int,
                        tile: int) -> torch.Tensor:
    """The int4 codec's decode: the flat float32 xhat [n] of
    :func:`quantize_pack_int4`'s wire, ``float(q_i) * scales[i // tile]``,
    in one launch."""
    n = _check_wire(packed, n)
    tile = _check_tile(n, tile)
    _check("scales", scales, torch.float32, (n // tile,), packed.device)
    if not on_card(packed, "unpack_dequant_int4"):
        return unpack_dequant_int4_plain(packed, scales, n, tile)
    dev = packed.device
    xhat = torch.empty(n, dtype=torch.float32, device=dev)
    with current(dev):
        status = _lib().unpack_dequant_int4(
            packed.data_ptr(), scales.data_ptr(), xhat.data_ptr(), n, tile,
            raw_stream(dev))
    check_status("unpack_dequant_int4", status)
    unpack_dequant_int4.launches += 1
    return xhat


unpack_dequant_int4.launches = 0


# ------------------------------------------------------- batches of payloads
def _flat_rows(name: str, x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] != rows or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous batch of {rows} "
                         f"rows, got {tuple(x.shape)}")
    return x.reshape(-1)


def _quantize_any(x: torch.Tensor, u: torch.Tensor, qmax, tile: int):
    """The quantize-dequant of a flat payload: the kernel for CUDA tensors
    (uncounted: the caller counts), the plain version for CPU ones."""
    if not on_card(x, "quantize"):
        return _quantize_flat(x, u, qmax, tile)
    return _launch_quantize(x, u, qmax, tile)


def _check_qmax_rows(qmax, rows: int, device):
    """A batch's range: a number (:func:`_check_qmax`), or a device operand
    of one float32 qmax a row, [rows] or 0-d for every row, on ``device``.
    The operand's values are not read here (that would be a host read
    inside a program): a sweep range-checks them on the host before they
    become a tensor (``core.compiled.quant_sweep_run``)."""
    if not isinstance(qmax, torch.Tensor):
        return _check_qmax(qmax)
    if qmax.dtype != torch.float32:
        raise TypeError(f"qmax must be float32, got {qmax.dtype}")
    if qmax.device != device:
        raise ValueError(f"qmax lies on {qmax.device}, expected {device}")
    if qmax.dim() == 0:
        qmax = qmax.expand(rows)
    if tuple(qmax.shape) != (rows,):
        raise ValueError(f"qmax must hold one range for each of {rows} "
                         f"rows, got shape {tuple(qmax.shape)}")
    return qmax.contiguous()


def quantize_dequant_rows_plain(x: torch.Tensor, u: torch.Tensor, qmax,
                                bn: int = DEFAULT_BN):
    """:func:`quantize_dequant_plain` of each row of ``x`` [F, n] with
    draws ``u``, at ``qmax`` (a number, or a float32 tensor of one range a
    row): (xhat [F, n], q [F, n] int8, scales [F, n / tile_for(n)])."""
    rows, n = x.shape
    tile = tile_for(n, bn)
    xhat, q, scales = _quantize_flat(x, u, qmax, tile)
    return (xhat.view(rows, n), q.view(rows, n),
            scales.view(rows, n // tile))


def quantize_dequant_rows(x: torch.Tensor, u: torch.Tensor, qmax, *,
                          bn: int = DEFAULT_BN):
    """F vectors' quantize-dequant in one launch: rows of ``x`` [F, n] with
    draws ``u`` [F, n], each in tiles of ``tile_for(n, bn)``.  Returns
    ``(xhat [F, n], q [F, n] int8, scales [F, n / tile])``, row f equal to
    :func:`quantize_dequant_tiles` of row f.  ``qmax`` is a number, or a
    float32 tensor [F] (0-d for every row) that the kernel reads, row f at
    ``qmax[f]`` (the quantization sweep's hop)."""
    if x.dim() != 2 or x.numel() < 1:
        raise ValueError(f"x must be a non-empty [F, n] batch, got "
                         f"{tuple(x.shape)}")
    rows, n = x.shape
    qmax = _check_qmax_rows(qmax, rows, x.device)
    _check("u", u, torch.float32, (rows, n), x.device)
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    tile = tile_for(n, bn)
    xhat, q, scales = _quantize_any(_flat_rows("x", x, rows),
                                    u.reshape(-1), qmax, tile)
    if on_card(x, "quantize"):
        quantize_dequant_tiles.launches += 1
    return (xhat.view(rows, n), q.view(rows, n),
            scales.view(rows, n // tile))


def quantize_dequant_block_rows_plain(x: torch.Tensor, u: torch.Tensor, qmax,
                                      bn: int = DEFAULT_BN):
    """:func:`quantize_dequant_block_plain` of each [n, k] block of ``x``
    [B, n, k] with draws ``u``: (xhat [B, n, k], q [B, n, k] int8, scales
    [B, n / rows_for(n, k)])."""
    rows, n, k = x.shape
    tile = rows_for(n, k, bn) * k
    xhat, q, scales = _quantize_flat(x, u, qmax, tile)
    return (xhat.view(rows, n, k), q.view(rows, n, k),
            scales.view(rows, n * k // tile))


def quantize_dequant_block_rows(x: torch.Tensor, u: torch.Tensor, qmax, *,
                                bn: int = DEFAULT_BN):
    """B score blocks' quantize-dequant in one launch: the [n, k] blocks of
    ``x`` [B, n, k] with draws ``u`` [B, n, k], each in tiles of
    ``rows_for(n, k, bn)`` rows (the serve step over a bucket's slots,
    ``kernels.ops``' vmap rule).  One launch of the quantize kernel on the
    flat B·n·k payload in tiles of ``rows_for(n, k, bn)·k`` elements: each
    block is a whole number of tiles, so block b gets the bits of
    :func:`quantize_dequant_block` on block b alone.  Returns ``(xhat [B,
    n, k], q [B, n, k] int8, scales [B, n / rows])``; counts its own
    launches.  ``qmax`` as :func:`quantize_dequant_rows` takes it, one
    range a block (the quantization sweep's serve axis)."""
    if x.dim() != 3 or x.numel() < 1:
        raise ValueError(f"x must be a non-empty [B, n, k] batch of "
                         f"blocks, got {tuple(x.shape)}")
    rows, n, k = x.shape
    _check("x", x, torch.float32, (rows, n, k), x.device)
    _check("u", u, torch.float32, (rows, n, k), x.device)
    qmax = _check_qmax_rows(qmax, rows, x.device)
    if not on_card(x, "quantize"):
        return quantize_dequant_block_rows_plain(x, u, qmax, bn)
    tile = rows_for(n, k, bn) * k
    xhat, q, scales = _launch_quantize(x, u, qmax, tile)
    quantize_dequant_block_rows.launches += 1
    return (xhat.view(rows, n, k), q.view(rows, n, k),
            scales.view(rows, n * k // tile))


quantize_dequant_block_rows.launches = 0


def quantize_pack_int4_rows(x: torch.Tensor, u: torch.Tensor, qmax,
                            tile: int):
    """F payloads' int4 encode: rows of ``x`` [F, ...] (each of m
    elements) with draws ``u`` of its shape, in tiles of ``tile``.
    Returns ``(packed [F, ceil(m / 2)], scales [F, m / tile])``, row f the
    wire of :func:`quantize_pack_int4` on row f.  An even m is one call on
    the flat payload (each row's bytes are whole).  An odd m (an odd tile)
    would put a row's last element and the next row's first into one
    byte, so the rows are quantized in one launch, padded by a zero nibble
    each, as a lone call pads its last byte, and packed in a second."""
    qmax = _check_qmax(qmax, 7.0)
    rows = x.shape[0]
    m = x[0].numel()
    tile = _check_tile(m, tile)
    _check("u", u, torch.float32, tuple(x.shape), x.device)
    xf, uf = _flat_rows("x", x, rows), _flat_rows("u", u, rows)
    if m % 2 == 0:
        packed, scales = quantize_pack_int4(xf, uf, qmax, tile)
        return packed.view(rows, m // 2), scales.view(rows, m // tile)
    _, q, scales = _quantize_any(xf, uf, qmax, tile)
    if on_card(x, "quantize"):
        qd = quantize_dequant_block if x.dim() == 3 \
            else quantize_dequant_tiles
        qd.launches += 1
    q = torch.nn.functional.pad(q.view(rows, m), (0, 1))
    packed = pack_int4(q)
    return packed.view(rows, (m + 1) // 2), scales.view(rows, m // tile)


def unpack_dequant_int4_rows(packed: torch.Tensor, scales: torch.Tensor,
                             n: int, tile: int) -> torch.Tensor:
    """F payloads' int4 decode: rows of ``packed`` [F, ceil(n / 2)] and
    ``scales`` [F, n / tile] to xhat [F, n], row f equal to
    :func:`unpack_dequant_int4` of row f, in one launch: an even n decodes
    the flat wire, an odd n (each row's last byte half padding) reads each
    row's bytes at its stride."""
    rows = packed.shape[0]
    n = int(n)
    tile = _check_tile(n, tile)
    if tuple(packed.shape) != (rows, (n + 1) // 2) \
            or tuple(scales.shape) != (rows, n // tile):
        raise ValueError(f"packed {tuple(packed.shape)} and scales "
                         f"{tuple(scales.shape)} are not {rows} rows of "
                         f"{n} values in tiles of {tile}")
    flat_p = _flat_rows("packed", packed, rows)
    flat_s = _flat_rows("scales", scales, rows)
    if n % 2 == 0:
        return unpack_dequant_int4(flat_p, flat_s, rows * n,
                                   tile).view(rows, n)
    _check_wire(flat_p, rows * (n + 1) - 1)
    _check("scales", flat_s, torch.float32, (flat_s.shape[0],),
           packed.device)
    if not on_card(packed, "unpack_dequant_int4"):
        return unpack_dequant_int4_rows_plain(packed, scales, n, tile)
    dev = packed.device
    xhat = torch.empty((rows, n), dtype=torch.float32, device=dev)
    with current(dev):
        status = _lib().unpack_dequant_int4_rows(
            packed.data_ptr(), scales.data_ptr(), xhat.data_ptr(), rows, n,
            tile, raw_stream(dev))
    check_status("unpack_dequant_int4_rows", status)
    unpack_dequant_int4.launches += 1
    return xhat
