"""Ignorance-score update (paper eqs. 10/12): CUDA kernel and plain version.

Counterpart of ``repro/kernels/ignorance.py``, whose Pallas TPU kernel this
replaces, together with the normalizer of ``repro/kernels/ops.py``, with
``csrc/ignorance.cu`` (built by :mod:`._build`):

  * :func:`ignorance_update` -- ``w * exp(alpha(1-r))`` divided by its sum
    clamped at 1e-12, in one launch on a thread-block cluster (the route
    for n <= ``LARGE_N``, every hop of the main path; see the source's
    note), or in two launches above that (the large-n route);
  * :func:`ignorance_update_unnormalized` -- ``w * exp(alpha(1-r))`` and one
    partial sum per 1024-tile, the JAX function's API, in one launch;
  * :func:`ignorance_update_group` -- the normalized update of a shard
    of a score sharded over a process group: the unnormalized mode, then
    its total all-reduced over the group (the reference's ``axis_name=``);
  * :func:`ignorance_update_batched` -- F normalized updates, rows of
    ``w [F, n]``, ``r [F, n]`` and ``alpha [F]``, in one launch: the
    counterpart of ``vmap`` over the TPU kernel (the session on the grid's
    second axis), which ``kernels.ops``' vmap rule calls for a fleet.

Both sum in the same fixed order, so the card gives the plain version's
bits below.  Unlike the TPU kernel they take any n >= 1: the ragged last
tile is masked.  :func:`plan` lays the cluster out in Python, where the
tests reach it.  Each wrapper launches its kernel for CUDA tensors and uses
the plain version only for CPU tensors; it never falls back from one to the
other.  Each counts its launches in a plain integer attribute
(``ignorance_update.launches``, ``ignorance_update_unnormalized.launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels._launch import (check_status, current, on_card,
                                         raw_stream)

BN = 1024
MAX_TILES_PER_CTA = 8
PORTABLE_CLUSTER = 8
MAX_CLUSTER = 16
LARGE_N = 2 ** 16         # above it, the large-n route
_EPS = 1e-12


def num_tiles(n: int) -> int:
    return -(-n // BN)


class Plan(NamedTuple):
    """A launch of :func:`ignorance_update`: ``ctas`` CTAs of
    ``tiles_per_cta`` tiles each; on the cluster route the grid is one
    cluster of ``cluster`` CTAs."""
    route: str            # "cluster" or "large"
    cluster: int
    ctas: int
    tiles_per_cta: int


@functools.lru_cache(maxsize=None)
def plan(n: int, cluster_limit: int = PORTABLE_CLUSTER) -> Plan:
    """The launch for a length-n update on a card whose clusters may hold
    ``cluster_limit`` CTAs (8, or 16 where it fits): as many CTAs as the
    limit allows, up to one a tile, and as few tiles a CTA as that leaves,
    no CTA empty.  Above ``LARGE_N`` the large-n route: the unnormalized
    mode's grid (one CTA a tile), then the second pass."""
    if n < 1:
        raise ValueError(f"no plan for n = {n}")
    if cluster_limit not in (PORTABLE_CLUSTER, MAX_CLUSTER):
        raise ValueError(f"cluster limit {cluster_limit} is neither "
                         f"{PORTABLE_CLUSTER} nor {MAX_CLUSTER}")
    tiles = num_tiles(n)
    if n > LARGE_N:
        return Plan("large", 1, tiles, 1)
    per_cta = -(-tiles // min(cluster_limit, tiles))
    cluster = -(-tiles // per_cta)
    return Plan("cluster", cluster, cluster, per_cta)


# ----------------------------------------------------------- plain version
def _tree_sum(tiles: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (length BN) in the kernel's tree order: step s adds
    element t + s into element t, halving s from BN/2 to 1."""
    while tiles.shape[-1] > 1:
        half = tiles.shape[-1] // 2
        tiles = tiles[..., :half] + tiles[..., half:]
    return tiles[..., 0]


def _tiles(x: torch.Tensor) -> torch.Tensor:
    """x zero-padded along its last axis to whole tiles, viewed
    [..., num_tiles, BN]."""
    pad = num_tiles(x.shape[-1]) * BN - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)).view(*x.shape[:-1], -1, BN)


def ignorance_update_unnormalized_plain(w: torch.Tensor, r: torch.Tensor,
                                        alpha: torch.Tensor):
    """Pass 1 in PyTorch ops: (w * exp(alpha(1-r)) [n], tile sums); the
    exponential is taken in float64 and rounded, as the kernel does."""
    w_new = w * torch.exp((alpha * (1.0 - r)).to(torch.float64)).to(
        torch.float32)
    return w_new, _tree_sum(_tiles(w_new))


def _total_plain(partials: torch.Tensor) -> torch.Tensor:
    """Pass 2's total: lane t accumulates partials t, t+BN, ... in order,
    then the lanes are tree-summed (over the last axis; leading axes are
    rows of a batch)."""
    rows = _tiles(partials)
    acc = rows[..., 0, :]
    for j in range(1, rows.shape[-2]):
        acc = acc + rows[..., j, :]
    return _tree_sum(acc)


def normalize_plain(w_new: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """Pass 2 in PyTorch ops (out of place); rows of [F, n] and [F, tiles]
    each by their own total."""
    total = torch.clamp(_total_plain(partials), min=_EPS)
    return w_new / total[..., None] if w_new.dim() > 1 else w_new / total


def tile_sums(x: torch.Tensor) -> torch.Tensor:
    """Pass 1's per-tile partial sums of x, in the kernel's order."""
    return _tree_sum(_tiles(x))


def ignorance_update_plain(w: torch.Tensor, r: torch.Tensor,
                           alpha: torch.Tensor) -> torch.Tensor:
    """Both passes in PyTorch ops: the normalized update."""
    return normalize_plain(*ignorance_update_unnormalized_plain(w, r, alpha))


def ignorance_update_batched_plain(w: torch.Tensor, r: torch.Tensor,
                                   alpha: torch.Tensor) -> torch.Tensor:
    """The batched update in PyTorch ops, row f with ``alpha[f]``, in the
    kernel's order: each row gives :func:`ignorance_update_plain`'s
    bits."""
    return ignorance_update_plain(w, r, alpha[:, None])


# -------------------------------------------------------------- the kernel
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("ignorance")
    if lib.ignorance_update.argtypes is None:
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ignorance_update.argtypes = [p, p, p, p, i64, i32, i32, p]
        lib.ignorance_update_large.argtypes = [p, p, p, p, p, i64, p]
        lib.ignorance_update_unnormalized.argtypes = [p, p, p, p, p, i64, p]
        lib.ignorance_update_batched.argtypes = [p, p, p, p, i64, i32, i32,
                                                 i32, p]
        lib.ignorance_update_large_batched.argtypes = [p, p, p, p, p, i64,
                                                       i32, p]
        lib.ignorance_max_cluster.argtypes = [ctypes.POINTER(i32)]
        lib.launch_floor.argtypes = [i32, p]
        for fn in (lib.ignorance_update, lib.ignorance_update_large,
                   lib.ignorance_update_unnormalized,
                   lib.ignorance_update_batched,
                   lib.ignorance_update_large_batched,
                   lib.ignorance_max_cluster, lib.launch_floor):
            fn.restype = ctypes.c_int
    return lib


@functools.cache
def cluster_limit(index: int) -> int:
    """The largest cluster the kernel may take on card ``index`` (the
    plan's other input), asked of the CUDA runtime once.  Call it with the
    card current: it also allows the kernel the non-portable size."""
    out = ctypes.c_int(0)
    check_status("ignorance_max_cluster",
                 _lib().ignorance_max_cluster(ctypes.byref(out)))
    return out.value


def _check_vector(name: str, x: torch.Tensor, n: int,
                  device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} lies on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"{name} must have shape ({n},), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(w: torch.Tensor, r: torch.Tensor, alpha: torch.Tensor) -> int:
    """Raise unless ``w`` and ``r`` are float32 [n] and ``alpha`` a 0-d
    float32 tensor, all on one device; returns n."""
    if w.dim() != 1 or w.shape[0] < 1:
        raise ValueError(f"w must be a non-empty vector, got {tuple(w.shape)}")
    n = w.shape[0]
    _check_vector("w", w, n, w.device)
    _check_vector("r", r, n, w.device)
    if alpha.device != w.device or alpha.dtype != torch.float32 \
            or alpha.dim() != 0:
        raise ValueError(f"alpha must be a 0-d float32 tensor on {w.device}, "
                         f"got {alpha.dtype} {tuple(alpha.shape)} on "
                         f"{alpha.device}")
    return n


def ignorance_update(w: torch.Tensor, r: torch.Tensor,
                     alpha: torch.Tensor) -> torch.Tensor:
    """The normalized update ``w * exp(alpha(1-r)) / max(sum, 1e-12)``
    [n].  ``w``, ``r``: float32 [n]; ``alpha``: a 0-d float32 tensor on the
    same device."""
    n = _check(w, r, alpha)
    if not on_card(w, "ignorance"):
        return ignorance_update_plain(w, r, alpha)
    out, dev = torch.empty_like(w), w.device
    with current(dev):
        p = plan(n, cluster_limit(dev.index))
        stream = raw_stream(dev)
        if p.route == "cluster":
            status = _lib().ignorance_update(
                w.data_ptr(), r.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                n, p.cluster, p.tiles_per_cta, stream)
        else:       # the large-n route's partials are its scratch
            partials = torch.empty(num_tiles(n), dtype=torch.float32,
                                   device=dev)
            status = _lib().ignorance_update_large(
                w.data_ptr(), r.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                partials.data_ptr(), n, stream)
    check_status("ignorance_update", status)
    ignorance_update.launches += 1
    return out


ignorance_update.launches = 0

MAX_ROWS = 65535          # the grid's second axis


def _check_batch(w: torch.Tensor, r: torch.Tensor,
                 alpha: torch.Tensor) -> tuple[int, int]:
    """Raise unless ``w`` and ``r`` are contiguous float32 [F, n] and
    ``alpha`` float32 [F], all on one device; returns (F, n)."""
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"w must be a non-empty [F, n] batch, got "
                         f"{tuple(w.shape)}")
    rows, n = w.shape
    for name, x, shape in (("w", w, (rows, n)), ("r", r, (rows, n)),
                           ("alpha", alpha, (rows,))):
        if x.device != w.device:
            raise ValueError(f"{name} lies on {x.device}, expected "
                             f"{w.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return rows, n


def ignorance_update_batched(w: torch.Tensor, r: torch.Tensor,
                             alpha: torch.Tensor) -> torch.Tensor:
    """F normalized updates in one launch: row f of the result is
    ``w[f] * exp(alpha[f](1 - r[f])) / max(sum, 1e-12)``, bit for bit what
    :func:`ignorance_update` gives for that row alone.  ``w``, ``r``:
    float32 [F, n]; ``alpha``: float32 [F], on the same device.  Above
    ``MAX_ROWS`` rows (the grid's second axis) one launch a block of
    ``MAX_ROWS``."""
    rows, n = _check_batch(w, r, alpha)
    if not on_card(w, "ignorance"):
        return ignorance_update_batched_plain(w, r, alpha)
    out, dev = torch.empty_like(w), w.device
    with current(dev):
        p = plan(n, cluster_limit(dev.index))
        stream = raw_stream(dev)
        for f0 in range(0, rows, MAX_ROWS):
            f1 = min(rows, f0 + MAX_ROWS)
            ptrs = (w[f0].data_ptr(), r[f0].data_ptr(), alpha[f0].data_ptr(),
                    out[f0].data_ptr())
            if p.route == "cluster":
                status = _lib().ignorance_update_batched(
                    *ptrs, n, f1 - f0, p.cluster, p.tiles_per_cta, stream)
            else:
                partials = torch.empty((f1 - f0, num_tiles(n)),
                                       dtype=torch.float32, device=dev)
                status = _lib().ignorance_update_large_batched(
                    *ptrs, partials.data_ptr(), n, f1 - f0, stream)
            check_status("ignorance_update_batched", status)
            ignorance_update_batched.launches += 1
    return out


ignorance_update_batched.launches = 0


def ignorance_update_unnormalized(w: torch.Tensor, r: torch.Tensor,
                                  alpha: torch.Tensor):
    """Returns (w * exp(alpha(1-r)) [n], per-tile partial sums
    [ceil(n/1024)]).  ``w``, ``r``: float32 [n]; ``alpha``: a 0-d float32
    tensor on the same device."""
    n = _check(w, r, alpha)
    if not on_card(w, "ignorance"):
        return ignorance_update_unnormalized_plain(w, r, alpha)
    out = torch.empty_like(w)
    partials = torch.empty(num_tiles(n), dtype=torch.float32, device=w.device)
    with current(w.device):
        status = _lib().ignorance_update_unnormalized(
            w.data_ptr(), r.data_ptr(), alpha.data_ptr(), out.data_ptr(),
            partials.data_ptr(), n, raw_stream(w.device))
    check_status("ignorance_update_unnormalized", status)
    ignorance_update_unnormalized.launches += 1
    return out, partials


ignorance_update_unnormalized.launches = 0


def ignorance_update_group(w: torch.Tensor, r: torch.Tensor,
                           alpha: torch.Tensor, group) -> torch.Tensor:
    """The normalized update of a score sharded over the process group
    ``group``, ``w``/``r`` this rank's shard: one launch of
    :func:`ignorance_update_unnormalized`, the shard's total from its tile
    sums in the kernel's order (:func:`_total_plain`), one ``all_reduce``
    of the totals over the group, then ``w / max(total, 1e-12)``.  In a
    group of one the total is the one-launch kernel's, so are the bits.
    Counts its all-reduces in ``ignorance_update_group.all_reduces``."""
    import torch.distributed as dist
    w_new, partials = ignorance_update_unnormalized(w, r, alpha)
    total = _total_plain(partials).reshape(1)
    dist.all_reduce(total, group=group)
    ignorance_update_group.all_reduces += 1
    return w_new / torch.clamp(total[0], min=_EPS)


ignorance_update_group.all_reduces = 0


def launch_floor(device: torch.device, cluster: int = 1) -> None:
    """Launch the source's empty kernel on ``cluster`` CTAs (a cluster
    launch above 1) through the same route as the update: the yardstick
    of a launch's own host and device cost."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    with current(device):
        status = _lib().launch_floor(cluster, raw_stream(device))
    check_status("launch_floor", status)
