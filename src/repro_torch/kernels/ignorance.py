"""Ignorance-score update (paper eqs. 10/12): CUDA kernel and plain version.

Counterpart of ``repro/kernels/ignorance.py``, whose Pallas TPU kernel this
replaces with ``csrc/ignorance.cu`` (built by :mod:`._build`).  The kernel
runs in two launches with a fixed reduction order (see the source's note):

  * :func:`ignorance_update_unnormalized` -- pass 1: ``w * exp(alpha(1-r))``
    and one partial sum per 1024-tile, the JAX function's API;
  * :func:`normalize_` -- pass 2: divide by ``max(sum(partials), 1e-12)``
    in place.

Unlike the TPU kernel it takes any n >= 1: the ragged last tile is masked.
Each wrapper launches its kernel for CUDA tensors and uses the plain
version below only for CPU tensors; it never falls back from one to the
other.  Each counts its launches in a plain integer attribute
(``ignorance_update_unnormalized.launches``, ``normalize_.launches``).
"""
from __future__ import annotations

import ctypes

import torch

BN = 1024
_EPS = 1e-12


def num_tiles(n: int) -> int:
    return -(-n // BN)


# ----------------------------------------------------------- plain version
def _tree_sum(tiles: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (length BN) in the kernel's tree order: step s adds
    element t + s into element t, halving s from BN/2 to 1."""
    while tiles.shape[-1] > 1:
        half = tiles.shape[-1] // 2
        tiles = tiles[..., :half] + tiles[..., half:]
    return tiles[..., 0]


def _tiles(x: torch.Tensor) -> torch.Tensor:
    """x zero-padded to whole tiles, viewed [num_tiles, BN]."""
    pad = num_tiles(x.shape[0]) * BN - x.shape[0]
    return torch.nn.functional.pad(x, (0, pad)).view(-1, BN)


def ignorance_update_unnormalized_plain(w: torch.Tensor, r: torch.Tensor,
                                        alpha: torch.Tensor):
    """Pass 1 in PyTorch ops: (w * exp(alpha(1-r)) [n], tile sums); the
    exponential is taken in float64 and rounded, as the kernel does."""
    w_new = w * torch.exp((alpha * (1.0 - r)).to(torch.float64)).to(
        torch.float32)
    return w_new, _tree_sum(_tiles(w_new))


def _total_plain(partials: torch.Tensor) -> torch.Tensor:
    """Pass 2's total: lane t accumulates partials t, t+BN, ... in order,
    then the lanes are tree-summed."""
    rows = _tiles(partials)
    acc = rows[0]
    for j in range(1, rows.shape[0]):
        acc = acc + rows[j]
    return _tree_sum(acc)


def normalize_plain(w_new: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """Pass 2 in PyTorch ops (out of place)."""
    return w_new / torch.clamp(_total_plain(partials), min=_EPS)


def ignorance_update_plain(w: torch.Tensor, r: torch.Tensor,
                           alpha: torch.Tensor) -> torch.Tensor:
    """Both passes in PyTorch ops: the normalized update."""
    return normalize_plain(*ignorance_update_unnormalized_plain(w, r, alpha))


# -------------------------------------------------------------- the kernel
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("ignorance")
    if lib.ignorance_update_unnormalized.argtypes is None:
        p = ctypes.c_void_p
        lib.ignorance_update_unnormalized.argtypes = [p, p, p, p, p,
                                                      ctypes.c_int64, p]
        lib.ignorance_update_unnormalized.restype = ctypes.c_int
        lib.ignorance_normalize.argtypes = [p, p, ctypes.c_int64, p]
        lib.ignorance_normalize.restype = ctypes.c_int
    return lib


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


def _check_status(fn: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{fn} launch failed with cudaError_t {status}")


def ignorance_update_unnormalized(w: torch.Tensor, r: torch.Tensor,
                                  alpha: torch.Tensor):
    """Returns (w * exp(alpha(1-r)) [n], per-tile partial sums
    [ceil(n/1024)]).  ``w``, ``r``: float32 [n]; ``alpha``: a 0-d float32
    tensor on the same device."""
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
    if w.device.type == "cpu":
        return ignorance_update_unnormalized_plain(w, r, alpha)
    if w.device.type != "cuda":
        raise ValueError(f"no ignorance kernel for device {w.device}")
    out = torch.empty_like(w)
    partials = torch.empty(num_tiles(n), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    with torch.cuda.device(w.device):
        status = _lib().ignorance_update_unnormalized(
            w.data_ptr(), r.data_ptr(), alpha.data_ptr(), out.data_ptr(),
            partials.data_ptr(), n, stream)
    _check_status("ignorance_update_unnormalized", status)
    ignorance_update_unnormalized.launches += 1
    return out, partials


ignorance_update_unnormalized.launches = 0


def normalize_(w_new: torch.Tensor, partials: torch.Tensor) -> torch.Tensor:
    """Divide ``w_new`` by ``max(sum(partials), 1e-12)``: in place on the
    card (returns ``w_new``), out of place on the CPU."""
    if w_new.dim() != 1 or w_new.shape[0] < 1:
        raise ValueError(f"w_new must be a non-empty vector, got "
                         f"{tuple(w_new.shape)}")
    n = w_new.shape[0]
    _check_vector("w_new", w_new, n, w_new.device)
    _check_vector("partials", partials, num_tiles(n), w_new.device)
    if w_new.device.type == "cpu":
        return normalize_plain(w_new, partials)
    if w_new.device.type != "cuda":
        raise ValueError(f"no ignorance kernel for device {w_new.device}")
    stream = torch.cuda.current_stream(w_new.device).cuda_stream
    with torch.cuda.device(w_new.device):
        status = _lib().ignorance_normalize(w_new.data_ptr(),
                                            partials.data_ptr(), n, stream)
    _check_status("ignorance_normalize", status)
    normalize_.launches += 1
    return w_new


normalize_.launches = 0
