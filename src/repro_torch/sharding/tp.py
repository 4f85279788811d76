"""Megatron tensor parallelism over the mesh's ``model`` axis: the
collectives, the autograd functions built on them, and the vocab-parallel
embedding lookup and weighted cross-entropy.

The reference shards its parameters over ``model`` by the rules
(``sharding/rules.py``) and lets GSPMD place the collectives; the port runs
one process a rank, each holding its shard of every leaf
(``rules.held_specs``), and places them by hand, as Megatron-LM does:

  * :func:`copy_to_model` -- identity forward, all-reduce backward: the
    entry of a region that computes a rank's share (its heads, its slice
    of ``d_ff``, its vocab range);
  * :func:`reduce_from_model` -- all-reduce forward, identity backward:
    the exit of such a region (a row-parallel product's partial sums);
  * under ``cfg.seq_parallel`` the residual stream is this rank's chunk of
    S (:func:`seq_split`): :func:`gather_seq` (all-gather over S forward,
    reduce-scatter backward) replaces :func:`copy_to_model` and
    :func:`scatter_seq` (reduce-scatter forward, all-gather backward)
    replaces :func:`reduce_from_model`; a region every rank computes
    whole (a replicated attention or unembedding) enters by
    ``gather_seq(x, partial_grad=False)`` (split backward) and leaves by
    :func:`split` (this rank's chunk forward, all-gather backward; also
    MLA's rank-dim split under ``mla_rank_shard``); :func:`enter` and
    :func:`leave` pick the pair;
  * :func:`all_reduce_sum` -- all-reduce both ways, for a sum whose every
    rank's share feeds every rank (the SSM's gated norm over ``d_inner``);
  * :func:`embed` -- a rank looks up its vocab range, writes zeros
    elsewhere, and the ranks' rows are summed;
  * :func:`weighted_ce` -- each rank's (lse, gold) over its vocab range by
    the CE kernel's shard mode, combined across ranks in rank order, and
    the backward kernel on the rank's range with the global lse;
  * :func:`merge_decode` -- the length-split decode's partial outputs and
    log-sum-exps merged in rank order (the cache's split rides on its
    tensor: :func:`register_split`, :func:`split_of`).

The invariant: every rank of a model group computes the whole loss, so a
leaf's gradient is whole on each rank, with one exception that
:func:`shared` repairs where it arises: a leaf every rank holds whole but
uses for its share only (GQA's whole ``wk``/``wv`` when KV does not
divide tp, the qk norms, MLA's latent projections, the SSM's B/C streams
and per-head leaves, and under sequence parallelism every norm scale and
the router, which see the rank's chunk of S) enters by
:func:`copy_to_model`, so its gradient is summed over ``model`` in the
backward pass.

Every collective of the TP path (and the train step's data-parallel
reductions) goes through :func:`collective`, which books its kind and
payload bytes (the bytes of its result on this rank, the reference's
``dryrun.collective_bytes`` convention) while a :class:`Recorder` is
active (:func:`recording`); the dry run reads it.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.sharding.context import current_mesh

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


# ------------------------------------------------------------- the recorder
class Recorder:
    """Calls and payload bytes of each collective kind, booked while
    active; ``by_group`` splits the bytes by (kind, id of the process
    group) for the links they cross."""

    def __init__(self) -> None:
        self.calls = {k: 0 for k in KINDS}
        self.bytes = {k: 0 for k in KINDS}
        self.by_group: dict = {}

    def book(self, kind: str, nbytes: int, group=None) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += int(nbytes)
        key = (kind, id(group))
        self.by_group[key] = self.by_group.get(key, 0) + int(nbytes)


_RECORDER: Recorder | None = None


@contextlib.contextmanager
def recording():
    """A fresh :class:`Recorder` that books every collective of the block."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, Recorder()
    try:
        yield _RECORDER
    finally:
        _RECORDER = prev


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def book(kind: str, nbytes: int, group=None) -> None:
    """Book a collective made elsewhere (``torch.distributed.nn``'s
    differentiable ones) on the active recorder."""
    if _RECORDER is not None:
        _RECORDER.book(kind, nbytes, group)


def collective(kind: str, x: torch.Tensor, group, dim: int = 0,
               parts: int = 1) -> torch.Tensor:
    """One collective over ``group`` of ``parts`` ranks, out of place:
    "all-reduce" (sum), "all-gather" (the ranks' ``x`` concatenated along
    ``dim`` in group-rank order) or "reduce-scatter" (the sum's chunk
    ``dim`` of this rank).  Booked on the active recorder."""
    import torch.distributed as dist
    x = x.contiguous()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        if kind == "all-reduce":
            out = x.clone()
            dist.all_reduce(out, group=group)
        elif kind == "all-gather":
            src = x.movedim(dim, 0).contiguous()
            out = src.new_empty((parts * src.shape[0],) + src.shape[1:])
            dist.all_gather_into_tensor(out, src, group=group)
            out = out.movedim(0, dim)
        elif kind == "reduce-scatter":
            src = x.movedim(dim, 0).contiguous()
            out = src.new_empty((src.shape[0] // parts,) + src.shape[1:])
            dist.reduce_scatter_tensor(out, src, group=group)
            out = out.movedim(0, dim)
        else:
            raise ValueError(f"unknown collective {kind!r}")
    book(kind, _nbytes(out), group)
    return out


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """``dist.all_reduce`` in place (a gradient, a metric), booked."""
    import torch.distributed as dist
    dist.all_reduce(x, group=group)
    book("all-reduce", _nbytes(x), group)
    return x


# ------------------------------------------------------------ the TP group
class TP(NamedTuple):
    """This rank's place on the ``model`` axis: its group, the axis size
    and its index, and whether the residual stream is split over S."""
    group: object
    size: int
    rank: int
    seq_parallel: bool


def active(cfg: ArchConfig) -> TP | None:
    """The TP group of :func:`current_mesh` when the config takes tensor
    parallelism (``rules.use_tp``) and the mesh has a ``model`` axis above
    1, else None."""
    from repro_torch.sharding.rules import tp_on
    mesh = current_mesh()
    if mesh is None or not hasattr(mesh, "group") or not tp_on(cfg, mesh):
        return None
    return TP(mesh.group("model"), mesh.shape["model"],
              mesh.coordinate("model"), bool(cfg.seq_parallel))


def seq_split(tp: TP | None, s: int) -> bool:
    """Whether a residual stream of length ``s`` is split over S: under
    ``seq_parallel`` when ``model`` divides it (the reference's
    ``_seq_shard`` skips it otherwise)."""
    return tp is not None and tp.seq_parallel and s % tp.size == 0


def chunk(x: torch.Tensor, tp: TP, dim: int) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * n, n)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective("all-reduce", g, ctx.tp.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return collective("all-reduce", x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return collective("all-reduce", x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return collective("all-reduce", g, ctx.tp.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim, partial_grad):
        ctx.tp, ctx.dim, ctx.partial = tp, dim, partial_grad
        return collective("all-gather", x, tp.group, dim, tp.size)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = collective("reduce-scatter", g, ctx.tp.group, ctx.dim,
                           ctx.tp.size)
        else:
            g = chunk(g, ctx.tp, ctx.dim).contiguous()
        return g, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return collective("reduce-scatter", x, tp.group, dim, tp.size)

    @staticmethod
    def backward(ctx, g):
        return collective("all-gather", g, ctx.tp.group, ctx.dim,
                          ctx.tp.size), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return chunk(x, tp, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return collective("all-gather", g, ctx.tp.group, ctx.dim,
                          ctx.tp.size), None, None


def copy_to_model(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """Identity forward; the ranks' gradients summed backward."""
    return _Copy.apply(x, tp)


def shared(w: torch.Tensor, tp: TP | None) -> torch.Tensor:
    """A leaf every rank holds whole and uses for its share only: its
    gradient summed over ``model`` (:func:`copy_to_model`)."""
    return w if tp is None else copy_to_model(w, tp)


def norm_params(p: dict, tp: TP | None, split: bool) -> dict:
    """An RMSNorm's params on the residual stream: under sequence
    parallelism (``split``) the rank normalizes its chunk of S, so its
    scale's gradient is summed over ``model``."""
    return {"scale": shared(p["scale"], tp)} if split else p


def reduce_from_model(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The ranks' partial sums summed forward; identity backward."""
    return _Reduce.apply(x, tp)


def all_reduce_sum(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """A sum over the ranks whose every share feeds every rank: summed
    both ways."""
    return _SumBoth.apply(x, tp)


def gather_seq(x: torch.Tensor, tp: TP, dim: int = 1,
               partial_grad: bool = True) -> torch.Tensor:
    """The ranks' S chunks all-gathered; backward the gradient's
    reduce-scatter (``partial_grad``: the consumer is a region of shares)
    or this rank's chunk of it (the consumer computes whole)."""
    return _Gather.apply(x, tp, dim, partial_grad)


def scatter_seq(x: torch.Tensor, tp: TP, dim: int = 1) -> torch.Tensor:
    """The ranks' partial sums reduce-scattered over S; backward the
    gradient's all-gather."""
    return _Scatter.apply(x, tp, dim)


def split(x: torch.Tensor, tp: TP, dim: int = 1) -> torch.Tensor:
    """This rank's chunk along ``dim`` (S by default) of a tensor every
    rank holds whole; backward the gradient's all-gather."""
    return _Split.apply(x, tp, dim)


def enter(x: torch.Tensor, tp: TP | None, split: bool,
          whole: bool = False) -> torch.Tensor:
    """The input of a region: ``x`` (this rank's S chunk when ``split``)
    made whole along S, with the backward that the region's gradient
    needs (``whole``: every rank computes the region whole)."""
    if tp is None:
        return x
    if split:
        return gather_seq(x, tp, partial_grad=not whole)
    return x if whole else copy_to_model(x, tp)


def leave(y: torch.Tensor, tp: TP | None, split: bool,
          whole: bool = False) -> torch.Tensor:
    """The output of a region back on the residual stream: the ranks'
    partial sums reduced (scattered over S when ``split``), or a whole
    output cut to this rank's chunk."""
    if tp is None:
        return y
    if whole:       # the argument ``split`` hides the function split
        return _Split.apply(y, tp, 1) if split else y
    return scatter_seq(y, tp) if split else reduce_from_model(y, tp)


def gather(x: torch.Tensor, tp: TP, dim: int) -> torch.Tensor:
    """The ranks' slices of axis ``dim`` concatenated (no gradient): a
    vocab-split logit row, or a share of the heads, made whole."""
    return collective("all-gather", x, tp.group, dim % x.dim(), tp.size)


# ------------------------------------------------------------ vocab parallel
def embed(table: torch.Tensor, tokens: torch.Tensor, tp: TP,
          split: bool) -> torch.Tensor:
    """The vocab-parallel lookup of ``tokens`` [B, S] in this rank's rows
    ``table`` [V / tp, d]: zeros for a token outside its range, the ranks'
    rows summed (reduce-scattered over S when ``split``)."""
    v0 = tp.rank * table.shape[0]
    inside = (tokens >= v0) & (tokens < v0 + table.shape[0])
    local = torch.where(inside, tokens - v0, torch.zeros_like(tokens))
    x = table[local] * inside[..., None].to(table.dtype)
    return scatter_seq(x, tp) if split else reduce_from_model(x, tp)


class _VocabCE(torch.autograd.Function):
    """The weighted CE over a vocab split: the forward kernel's shard mode
    gives this rank's (lse, gold), the ranks' are combined in rank order
    (lse = logsumexp, gold = sum: one rank holds a row's label), and the
    backward kernel writes softmax - onehot on this rank's columns from
    the global lse.  Every rank returns the whole loss."""

    @staticmethod
    def forward(ctx, logits, labels, weights, tp):
        from repro_torch.kernels import ops
        v0 = tp.rank * logits.shape[1]
        lse_loc, gold_loc = ops.weighted_ce_shard_fwd(logits, labels, v0)
        parts = collective("all-gather", torch.stack([lse_loc, gold_loc]),
                           tp.group, 0, tp.size).reshape(tp.size, 2, -1)
        lse, gold = combine_ce(parts[:, 0], parts[:, 1])
        ctx.save_for_backward(logits, labels, weights, lse)
        ctx.v0 = v0
        return weights * (lse - gold)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.kernels import ops
        logits, labels, weights, lse = ctx.saved_tensors
        return (ops.weighted_ce_shard_bwd(logits, labels, weights, lse,
                                          g.contiguous(), ctx.v0),
                None, None, None)


def combine_ce(lse: torch.Tensor, gold: torch.Tensor):
    """The ranks' shard (lse [R, T], gold [R, T]) combined in rank order:
    the whole vocab's lse = logsumexp over the ranks, gold = their sum
    (one rank holds a row's label, the others add exact zeros)."""
    return torch.logsumexp(lse, dim=0), gold.sum(0)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor, tp: TP) -> torch.Tensor:
    """Per-token w * (lse - x[label]) [T] of logits [T, V / tp] (this
    rank's vocab range), the whole vocab's on every rank."""
    return _VocabCE.apply(logits, labels, weights, tp)


# ------------------------------------------------------------ split decode
def merge_decode(o: torch.Tensor, lse: torch.Tensor, group,
                 parts: int) -> torch.Tensor:
    """The length-split decode's merge: each rank's partial output o
    [B, H, D] (float32) and its log-sum-exp lse [B, H] over its positions
    (-inf where it holds none) all-gathered and merged in rank order:
    sum_r o_r exp(lse_r - m) / sum_r exp(lse_r - m), m the max.  A rank
    past ``pos`` adds exactly 0; no NaN while some rank holds a valid
    position."""
    b, h, d = o.shape
    both = torch.cat([o.to(torch.float32), lse.to(torch.float32)[..., None]],
                     dim=-1)
    allp = collective("all-gather", both[None], group, 0, parts)
    return merge_partials(allp[..., :d], allp[..., d])


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """[R, B, H, D] partial outputs and [R, B, H] log-sum-exps merged over
    R in order (float32)."""
    m = lse.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)                        # exp(-inf) = 0
    num = torch.zeros_like(o[0])
    den = torch.zeros_like(lse[0])
    for r in range(o.shape[0]):
        num = num + o[r] * w[r][..., None]
        den = den + w[r]
    return num / torch.clamp(den, min=1e-30)[..., None]


def local_heads(tp: TP, heads: int) -> range:
    """The global indices of this rank's ``heads // tp`` heads."""
    n = heads // tp.size
    return range(tp.rank * n, (tp.rank + 1) * n)


# --------------------------------------------------- length-split caches
class CacheSplit(NamedTuple):
    """A decode cache split along its positions over ``axes`` (by
    ``rules.cache_specs``): this rank holds [s0, s0 + S_loc); ``group``
    and ``parts`` are the axes' process group and size."""
    axes: tuple
    group: object
    parts: int
    s0: int


def register_split(t: torch.Tensor, split: CacheSplit) -> None:
    """Mark the stacked cache tensor ``t`` as this rank's chunk of the
    positions under ``split`` (``api.init_cache`` and
    ``api.pad_prefill_cache`` do; ``api.quantize_cache`` carries it to the
    int8 leaf): an attribute of the tensor, gone with it (a copy made
    elsewhere holds every position again as far as decode can tell)."""
    t.cache_split = split


def split_of(t: torch.Tensor) -> CacheSplit | None:
    """The :class:`CacheSplit` of a stacked cache tensor, None when it
    holds every position."""
    return getattr(t, "cache_split", None)
