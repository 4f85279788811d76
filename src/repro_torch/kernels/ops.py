"""Public wrappers for the port's kernels.

Counterpart of ``repro/kernels/ops.py``: the ignorance update, the
wire-codec kernels (quantize-dequant for vectors and score blocks, int4
pack and unpack, and the int4 codec's fused encode and decode), the
weighted cross-entropy with its backward, flash
attention and flash decode; every Pallas kernel of the reference has its
CUDA counterpart.  Each runs its CUDA kernel for CUDA tensors and its plain
version for CPU tensors.

The hop's kernels (the ignorance update, the vector quantize-dequant and
the int4 encode and decode) and the serve codec's block quantize-dequant
are also ``torch.library`` custom ops with fake implementations and vmap
rules (the two quantize-dequants twice: ``qmax`` a float, or a tensor,
the quantization sweep's range, which the rule batches with the
payloads), so that ``torch.func.vmap`` (a fleet of sessions,
``core.compiled.fleet_run``; a serve bucket's slots,
``core.compiled.serve_batch``; a sweep's sessions,
``core.compiled.quant_sweep_run``) reaches the CUDA launches: a ctypes
launch reads ``data_ptr()``, which a batched tensor does not have.  Each rule
takes the batch's payloads as rows and makes the launch of the whole
batch (``ignorance.ignorance_update_batched``, ``quantize.*_rows``), whose
row f is bit for bit the call of session f alone; a batched launch counts
once.  Outside a functorch transform the
wrappers call the kernels directly, as before: same bits, same counts,
without the dispatcher's host time on every eager hop.

The model path's kernels (flash attention, flash decode and its shard
mode, the weighted CE and its shard modes) are custom ops too, with fake
implementations and ``torch.utils.flop_counter`` formulas from their
shapes, for tensors on the meta device only: the dry run
(``launch/dryrun.py``) runs the model there and counts the kernels'
products and bytes, not their plain versions' intermediates.  On the card
and the CPU the wrappers call the kernels directly (:func:`_meta`), for
two reasons.  The custom ops have no autograd rule, while on the CPU
autograd differentiates through the plain versions (flash attention in a
training step).  And the dispatcher's host time: through the custom op a
``flash_decode`` call took 92-123 us of host time against 60-66 us
direct on an H100 80GB HBM3 at 700 W, two runs of
``tools/model_op_host_cost.py``; qwen3-0.6b's decode at batch 1 (28 such
calls a token) took 46.78 against 45.34 ms a token in one and 39.83
against 40.83 in the other, within the runs' spread.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ignorance as _ig
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import weighted_ce as _wce


_TRANSFORMS_ACTIVE = getattr(torch._C, "_are_functorch_transforms_active",
                             None)


def _transformed() -> bool:
    """True inside a functorch transform (vmap, grad), where a hop kernel
    must go through its custom op; True as well where PyTorch cannot say."""
    return _TRANSFORMS_ACTIVE is None or _TRANSFORMS_ACTIVE()


def _rows(x: torch.Tensor, dim, size: int) -> torch.Tensor:
    """``x`` as a contiguous batch with its vmapped axis first; an input
    that is not batched is broadcast to ``size`` rows."""
    if dim is None:
        return x.expand(size, *x.shape).contiguous()
    return x.movedim(dim, 0).contiguous()


@torch.library.custom_op("repro_torch::ignorance_update", mutates_args=())
def _ignorance_update_op(w: torch.Tensor, r: torch.Tensor,
                         alpha: torch.Tensor) -> torch.Tensor:
    return _ig.ignorance_update(w, r, alpha)


@_ignorance_update_op.register_fake
def _(w, r, alpha):
    return torch.empty_like(w)


@_ignorance_update_op.register_vmap
def _(info, in_dims, w, r, alpha):
    size = info.batch_size
    return _ig.ignorance_update_batched(_rows(w, in_dims[0], size),
                                        _rows(r, in_dims[1], size),
                                        _rows(alpha, in_dims[2], size)), 0


@torch.library.custom_op("repro_torch::quantize_dequant", mutates_args=())
def _quantize_dequant_op(x: torch.Tensor, u: torch.Tensor, qmax: float,
                         bn: int) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    return _q.quantize_dequant_tiles(x, u, qmax, bn=bn)


def _quantize_dequant_fake(x, u, qmax, bn):
    n = x.shape[0]
    return (torch.empty_like(x), torch.empty(n, dtype=torch.int8,
                                             device=x.device),
            x.new_empty(n // _q.tile_for(n, bn)))


_quantize_dequant_op.register_fake(_quantize_dequant_fake)


@_quantize_dequant_op.register_vmap
def _(info, in_dims, x, u, qmax, bn):
    size = info.batch_size
    return _q.quantize_dequant_rows(_rows(x, in_dims[0], size),
                                    _rows(u, in_dims[1], size), qmax,
                                    bn=bn), (0, 0, 0)


@torch.library.custom_op("repro_torch::quantize_dequant_block",
                         mutates_args=())
def _quantize_dequant_block_op(x: torch.Tensor, u: torch.Tensor, qmax: float,
                               bn: int) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    return _q.quantize_dequant_block(x, u, qmax, bn=bn)


def _quantize_dequant_block_fake(x, u, qmax, bn):
    n, k = x.shape
    return (torch.empty_like(x), torch.empty((n, k), dtype=torch.int8,
                                             device=x.device),
            x.new_empty(n // _q.rows_for(n, k, bn)))


_quantize_dequant_block_op.register_fake(_quantize_dequant_block_fake)


@_quantize_dequant_block_op.register_vmap
def _(info, in_dims, x, u, qmax, bn):
    size = info.batch_size
    return _q.quantize_dequant_block_rows(_rows(x, in_dims[0], size),
                                          _rows(u, in_dims[1], size), qmax,
                                          bn=bn), (0, 0, 0)


@torch.library.custom_op("repro_torch::quantize_dequant_qmax",
                         mutates_args=())
def _quantize_dequant_qmax_op(x: torch.Tensor, u: torch.Tensor,
                              qmax: torch.Tensor, bn: int
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    xhat, q, scales = _q.quantize_dequant_rows(
        x[None], u[None], qmax.reshape(1), bn=bn)
    return xhat[0], q[0], scales[0]


@_quantize_dequant_qmax_op.register_fake
def _(x, u, qmax, bn):
    return _quantize_dequant_fake(x, u, qmax, bn)


@_quantize_dequant_qmax_op.register_vmap
def _(info, in_dims, x, u, qmax, bn):
    size = info.batch_size
    return _q.quantize_dequant_rows(_rows(x, in_dims[0], size),
                                    _rows(u, in_dims[1], size),
                                    _rows(qmax, in_dims[2], size),
                                    bn=bn), (0, 0, 0)


@torch.library.custom_op("repro_torch::quantize_dequant_block_qmax",
                         mutates_args=())
def _quantize_dequant_block_qmax_op(x: torch.Tensor, u: torch.Tensor,
                                    qmax: torch.Tensor, bn: int
                                    ) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    xhat, q, scales = _q.quantize_dequant_block_rows(
        x[None], u[None], qmax.reshape(1), bn=bn)
    return xhat[0], q[0], scales[0]


@_quantize_dequant_block_qmax_op.register_fake
def _(x, u, qmax, bn):
    return _quantize_dequant_block_fake(x, u, qmax, bn)


@_quantize_dequant_block_qmax_op.register_vmap
def _(info, in_dims, x, u, qmax, bn):
    size = info.batch_size
    return _q.quantize_dequant_block_rows(
        _rows(x, in_dims[0], size), _rows(u, in_dims[1], size),
        _rows(qmax, in_dims[2], size), bn=bn), (0, 0, 0)


@torch.library.custom_op("repro_torch::quantize_pack_int4", mutates_args=())
def _quantize_pack_int4_op(x: torch.Tensor, u: torch.Tensor, qmax: float,
                           tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    return _q.quantize_pack_int4(x, u, qmax, tile)


@_quantize_pack_int4_op.register_fake
def _(x, u, qmax, tile):
    m = x.numel()
    return (torch.empty((m + 1) // 2, dtype=torch.int8, device=x.device),
            x.new_empty(m // tile))


@_quantize_pack_int4_op.register_vmap
def _(info, in_dims, x, u, qmax, tile):
    size = info.batch_size
    return _q.quantize_pack_int4_rows(_rows(x, in_dims[0], size),
                                      _rows(u, in_dims[1], size), qmax,
                                      tile), (0, 0)


@torch.library.custom_op("repro_torch::unpack_dequant_int4", mutates_args=())
def _unpack_dequant_int4_op(packed: torch.Tensor, scales: torch.Tensor,
                            n: int, tile: int) -> torch.Tensor:
    return _q.unpack_dequant_int4(packed, scales, n, tile)


@_unpack_dequant_int4_op.register_fake
def _(packed, scales, n, tile):
    return scales.new_empty(n)


@_unpack_dequant_int4_op.register_vmap
def _(info, in_dims, packed, scales, n, tile):
    size = info.batch_size
    return _q.unpack_dequant_int4_rows(_rows(packed, in_dims[0], size),
                                       _rows(scales, in_dims[1], size), n,
                                       tile), 0


# ------------------------------------------------ the model path's kernels
def _meta(x: torch.Tensor) -> bool:
    """Whether a model-path wrapper goes through its custom op: for meta
    tensors only (the module docstring says why not for the others)."""
    return x.device.type == "meta"


@torch.library.custom_op("repro_torch::weighted_ce_fwd", mutates_args=())
def _wce_fwd_op(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _wce.weighted_ce_fwd(logits, labels, weights)


@torch.library.custom_op("repro_torch::weighted_ce_shard_fwd",
                         mutates_args=())
def _wce_shard_fwd_op(logits: torch.Tensor, labels: torch.Tensor,
                      v0: int) -> tuple[torch.Tensor, torch.Tensor]:
    return _wce.weighted_ce_shard_fwd(logits, labels, v0)


@torch.library.custom_op("repro_torch::weighted_ce_bwd", mutates_args=())
def _wce_bwd_op(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                v0: int) -> torch.Tensor:
    return _wce.weighted_ce_shard_bwd(logits, labels, weights, lse, g, v0)


def _rows_fake(logits, *args):
    t = logits.shape[0]
    return (logits.new_empty(t, dtype=torch.float32),
            logits.new_empty(t, dtype=torch.float32))


_wce_fwd_op.register_fake(_rows_fake)
_wce_shard_fwd_op.register_fake(_rows_fake)


@_wce_bwd_op.register_fake
def _(logits, labels, weights, lse, g, v0):
    return torch.empty_like(logits, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int | None) -> torch.Tensor:
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=())
def _flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int, k_scale: torch.Tensor | None,
                     v_scale: torch.Tensor | None,
                     window: int | None) -> torch.Tensor:
    return _fd.flash_decode(q, k, v, pos, k_scale=k_scale, v_scale=v_scale,
                            window=window)


@_flash_decode_op.register_fake
def _(q, k, v, pos, k_scale, v_scale, window):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::flash_decode_shard", mutates_args=())
def _flash_decode_shard_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: int, s0: int, k_scale: torch.Tensor | None,
                           v_scale: torch.Tensor | None, window: int | None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    return _fd.flash_decode_shard(q, k, v, pos, s0, k_scale=k_scale,
                                  v_scale=v_scale, window=window)


@_flash_decode_shard_op.register_fake
def _(q, k, v, pos, s0, k_scale, v_scale, window):
    b, h, d = q.shape
    return (q.new_empty((b, h, d), dtype=torch.float32),
            q.new_empty((b, h), dtype=torch.float32))


def attention_pairs(s: int, t: int, causal: bool, window) -> int:
    """The (query, key) pairs a flash attention of S queries right-aligned
    against T keys computes: query i (at T - S + i) sees the keys at or
    before it (when causal) and within the window."""
    if not causal and window is None:
        return s * t
    pairs = 0
    for i in range(s):
        p = t - s + i
        hi = p if causal else t - 1
        lo = 0 if window is None else max(0, p - window + 1)
        pairs += max(0, min(hi, t - 1) - lo + 1)
    return pairs


def _register_flops() -> None:
    """FlopCounterMode's formulas for the model path's kernels: 4 D
    flops a (query, key) pair for the attentions (Q K^T and P V); none
    for the CE kernels, which run no matrix product."""
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _(q_shape, k_shape, v_shape, causal, window, *a, **kw):
        b, h, s, d = q_shape
        return 4 * b * h * d * attention_pairs(s, k_shape[2], causal, window)

    def decode(q_shape, k_shape, pos, s0, window):
        b, h, d = q_shape
        lo, hi = _fd.valid_range(pos, k_shape[2], window, s0)
        return 4 * b * h * d * max(0, hi - lo + 1)

    @register_flop_formula(torch.ops.repro_torch.flash_decode)
    def _(q_shape, k_shape, v_shape, pos, k_scale, v_scale, window, *a,
          **kw):
        return decode(q_shape, k_shape, pos, 0, window)

    @register_flop_formula(torch.ops.repro_torch.flash_decode_shard)
    def _(q_shape, k_shape, v_shape, pos, s0, k_scale, v_scale, window, *a,
          **kw):
        return decode(q_shape, k_shape, pos, s0, window)

    for op in (torch.ops.repro_torch.weighted_ce_fwd,
               torch.ops.repro_torch.weighted_ce_shard_fwd,
               torch.ops.repro_torch.weighted_ce_bwd):
        register_flop_formula(op)(lambda *a, **kw: 0)


_register_flops()


def weighted_ce_fwd(logits, labels, weights):
    """(loss [T], lse [T]) of the forward kernel (``weighted_ce.py``)."""
    if _meta(logits):
        return _wce_fwd_op(logits, labels, weights)
    return _wce.weighted_ce_fwd(logits, labels, weights)


def weighted_ce_shard_fwd(logits, labels, v0: int):
    """(lse [T], gold [T]) of the vocab columns [v0, v0 + V) ``logits``:
    the forward kernel's shard mode."""
    if _meta(logits):
        return _wce_shard_fwd_op(logits, labels, int(v0))
    return _wce.weighted_ce_shard_fwd(logits, labels, v0)


def weighted_ce_shard_bwd(logits, labels, weights, lse, g, v0: int):
    """dlogits of the vocab columns [v0, v0 + V) from the whole vocab's
    lse: the backward kernel's shard mode."""
    if _meta(logits):
        return _wce_bwd_op(logits, labels, weights, lse, g, int(v0))
    return _wce.weighted_ce_shard_bwd(logits, labels, weights, lse, g, v0)


class _WeightedCE(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward kernel saves lse, the
    backward kernel recomputes the probabilities from it; labels and
    weights get no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, weights):
        loss, lse = weighted_ce_fwd(logits, labels, weights)
        ctx.save_for_backward(logits, labels, weights, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, weights, lse = ctx.saved_tensors
        if _meta(logits):
            return (_wce_bwd_op(logits, labels, weights, lse, g, 0), None,
                    None)
        return (_wce.weighted_ce_bwd(logits, labels, weights, lse, g),
                None, None)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Per-token ignorance-weighted NLL [T] of logits [T, V]:
    ``w * (logsumexp(x) - x[label])``, differentiable in the logits through
    the backward kernel."""
    return _WeightedCE.apply(logits, labels, weights)


def ignorance_update(w: torch.Tensor, r: torch.Tensor,
                     alpha: torch.Tensor, group=None) -> torch.Tensor:
    """Eqs. (10)/(12), normalized: one launch of the CUDA kernel for CUDA
    tensors (a thread-block cluster sums and scales), its plain version for
    CPU tensors; under vmap one batched launch for all sessions.

    ``group`` (the reference's ``axis_name=``): ``w`` and ``r`` are this
    rank's shard of a score sharded over that process group, normalized
    by the whole score's sum (``ignorance.ignorance_update_group``)."""
    if group is not None:
        return _ig.ignorance_update_group(w, r, alpha, group)
    if not _transformed():
        return _ig.ignorance_update(w, r, alpha)
    return _ignorance_update_op(w, r, alpha)


def ignorance_update_unnormalized(w: torch.Tensor, r: torch.Tensor,
                                  alpha: torch.Tensor):
    """Eqs. (10)/(12) without the normalizer, the async barrier's merge
    step: one launch of the CUDA kernel for CUDA tensors, its plain version
    for CPU tensors; returns (w * exp(alpha(1-r)) [n], per-tile partial
    sums)."""
    return _ig.ignorance_update_unnormalized(w, r, alpha)


def ignorance_normalize(w: torch.Tensor,
                        partials: torch.Tensor | None = None) -> torch.Tensor:
    """w / max(sum w, 1e-12), the sum taken from ``partials`` (the tile sums
    of :func:`ignorance_update_unnormalized`, or of ``w`` when None) in the
    kernel's order, so the card and the CPU give the same bits."""
    if partials is None:
        partials = _ig.tile_sums(w)
    return _ig.normalize_plain(w, partials)


def quantize_dequant(x: torch.Tensor, u: torch.Tensor, qmax, *,
                     bn: int = 1024):
    """Fused per-tile quantize-dequant for the wire codecs: returns
    (dequantized [n], int8 wire values [n], per-tile scales); under vmap
    one launch for all sessions.  ``qmax`` is a number, or a 0-d float32
    tensor on the payload's device (a sweep's range, batched under vmap:
    one launch for all sessions, each at its own range)."""
    if isinstance(qmax, torch.Tensor):
        return _quantize_dequant_qmax_op(x, u, qmax, int(bn))
    if not _transformed():
        return _q.quantize_dequant_tiles(x, u, qmax, bn=bn)
    return _quantize_dequant_op(x, u, float(qmax), int(bn))


def quantize_dequant_block(x: torch.Tensor, u: torch.Tensor, qmax, *,
                           bn: int = 1024):
    """Row-tiled quantize-dequant for [n, k] score blocks: returns
    (dequantized [n, k], int8 wire values [n, k], per-row-tile scales);
    under vmap (a serve bucket's slots) one launch for all blocks.
    ``qmax`` as :func:`quantize_dequant` takes it."""
    if isinstance(qmax, torch.Tensor):
        return _quantize_dequant_block_qmax_op(x, u, qmax, int(bn))
    if not _transformed():
        return _q.quantize_dequant_block(x, u, qmax, bn=bn)
    return _quantize_dequant_block_op(x, u, float(qmax), int(bn))


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Two sign-extended int4 nibbles per int8 wire byte (flat,
    ceil(numel / 2) long): the int4 codec's wire array."""
    return _q.pack_int4(q)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: n int8-carried int4 values (flat)."""
    return _q.unpack_int4(packed, n)


def quantize_pack_int4(x: torch.Tensor, u: torch.Tensor, qmax, tile: int):
    """The int4 codec's encode in one launch: the per-tile quantize of a
    flat payload with its packing as the epilogue; returns (packed wire
    bytes [ceil(numel / 2)], per-tile scales); under vmap each session
    gets the bytes of its own call."""
    if not _transformed():
        return _q.quantize_pack_int4(x, u, qmax, tile)
    return _quantize_pack_int4_op(x, u, float(qmax), int(tile))


def unpack_dequant_int4(packed: torch.Tensor, scales: torch.Tensor, n: int,
                        tile: int) -> torch.Tensor:
    """The int4 codec's decode in one launch: the flat dequantized [n] of
    :func:`quantize_pack_int4`'s wire."""
    if not _transformed():
        return _q.unpack_dequant_int4(packed, scales, n, tile)
    return _unpack_dequant_int4_op(packed, scales, int(n), int(tile))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    """Blocked online-softmax attention: q [B, H, S, D] against k/v
    [B, KV, T, D] (GQA, queries right-aligned), causal and with an optional
    sliding window; returns [B, H, S, D]."""
    if _meta(q):
        return _flash_attention_op(q, k, v, causal, window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos, *,
                 k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None,
                 window: int | None = None) -> torch.Tensor:
    """Single-row attention of q [B, H, D] against positions <= pos of a
    [B, KV, S, D] cache (int8 with [B, KV, S] scales when given); returns
    [B, H, D]."""
    if _meta(q):
        return _flash_decode_op(q, k, v, int(pos), k_scale, v_scale, window)
    return _fd.flash_decode(q, k, v, pos, k_scale=k_scale, v_scale=v_scale,
                            window=window)


def flash_decode_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       pos, s0, *, k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None,
                       window: int | None = None):
    """:func:`flash_decode` over a cache shard holding the positions
    [s0, s0 + S): (o [B, H, D] float32, lse [B, H] float32) for the
    length-split merge (``sharding/tp.py::merge_decode``)."""
    if _meta(q):
        return _flash_decode_shard_op(q, k, v, int(pos), int(s0), k_scale,
                                      v_scale, window)
    return _fd.flash_decode_shard(q, k, v, pos, s0, k_scale=k_scale,
                                  v_scale=v_scale, window=window)
