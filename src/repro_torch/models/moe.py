"""Mixture-of-Experts: top-k router and expert FFNs.

Counterpart of ``repro/models/moe.py``, with its leaf names and layouts
(``router`` [d, E], ``wi_gate``/``wi_up`` [E, d, f], ``wo`` [E, f, d]).

Implementations (``cfg.moe_impl``):
  * ``dense`` -- every expert computes every token, mask-combined: the
    exact oracle, E/k times the activated FLOPs.  It reads nothing back to
    the host, so the neural backbone (``learners/neural.py``, which
    ``torch.func.vmap`` batches over fleets) runs it.
  * ``gmm``   -- grouped matmul: the token copies are sorted by expert
    (stably) and each expert's segment takes one matrix product.  The
    segment lengths are read back to the host once a layer (the reference's
    ``ragged_dot`` takes them on the device); see ROADMAP Queue 3.
  * ``ep_a2a`` -- expert parallelism over a mesh's ``data`` axis with
    fixed-capacity all-to-alls (``repro_torch.sharding.ep``), on the mesh
    of :func:`repro_torch.sharding.context.mesh_context`; without one,
    the grouped path, as the reference falls back.

Router: softmax over experts in float32, top-k with ties to the lower
index (as ``lax.top_k``), renormalized among the chosen k, and the Switch
load-balance loss E * sum_e f_e P_e.  Under a mesh with data axes
(:func:`~repro_torch.sharding.context.mesh_context`: x is this rank's
shard of the batch) the dense and grouped paths' loss is the global
batch's, the same on every rank: the expert counts, the token count and
the probability sums all-reduced over the data axes in one
differentiable collective, as the reference's step computes it on its
global arrays.  ``ep_a2a``'s is the reference's mean over ``data`` of
the shards' losses.  A data-parallel step takes a share of either
(``api.loss_and_grads``).

Tensor parallelism (``tp``, a ``sharding.tp.TP``) with ``moe_ff_axis =
"model"``: the expert banks are this rank's slice of ``moe_d_ff`` and each
rank's expert outputs partial sums, combined with the gate probabilities
and then summed over ``model``; the probabilities enter the region by
``copy_to_model``, so the router's gradient is whole on every rank.
Under sequence parallelism (``split``) each rank routes its chunk of S
(the router's statistics summed over ``model`` as well) and the tokens
and probabilities are all-gathered for the experts.  ``ep_a2a`` under
tensor parallelism routes the whole S on every rank of a model group
(gathered first under ``split``), each rank holding its slice of the
banks' ff, the partials summed over ``model`` before the return hop
(``sharding/ep.py``).  On the meta device (the dry run) the grouped path
takes balanced segments: the routing is data.

The grouped combine writes each copy's weighted output back to its
(token, slot) place by index (no two copies share one) and adds a token's
k copies one after another in the order of their experts, in the output's
dtype: the order in which the reference's scatter-add meets them.  No
floating-point atomics, so two runs are the same bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import activation, he_init


def moe_init(gen: torch.Generator | None, cfg: ArchConfig, dtype: torch.dtype,
             *, lead: tuple = (),
             device: torch.device | str = "meta") -> dict:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    kw = dict(lead=lead, device=device)
    return {"router": he_init(gen, (d, e), dtype, **kw),
            "wi_gate": he_init(gen, (e, d, f), dtype, fan_in=d, **kw),
            "wi_up": he_init(gen, (e, d, f), dtype, fan_in=d, **kw),
            "wo": he_init(gen, (e, f, d), dtype, fan_in=f, **kw)}


def router_topk(params: dict, x_flat: torch.Tensor, cfg: ArchConfig,
                group=None, tp=None):
    """x_flat [T, d] -> (probs [T, k] in x's dtype, idx [T, k] int64, aux
    float32 scalar); ``group``: x_flat is this rank's shard of a batch
    split over ``group``, and aux the whole batch's loss; ``tp``: x_flat
    is the rank's chunk of S too, its statistics summed over ``model``."""
    logits = x_flat.to(torch.float32) @ params["router"].to(torch.float32)
    probs_full = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower expert
    # first, as lax.top_k does (torch.topk leaves ties unspecified)
    probs, idx = torch.sort(probs_full, dim=-1, descending=True, stable=True)
    probs, idx = probs[:, :cfg.top_k], idx[:, :cfg.top_k]
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    e = cfg.num_experts
    if group is not None or tp is not None:
        return probs.to(x_flat.dtype), idx, _global_aux(probs_full, idx, e,
                                                         group, tp)
    frac_tokens = F.one_hot(idx, e).to(torch.float32).sum(1).mean(0)  # f_e
    frac_probs = probs_full.mean(0)                                   # P_e
    aux = e * torch.sum(frac_tokens * frac_probs)
    return probs.to(x_flat.dtype), idx, aux


def _global_aux(probs_full: torch.Tensor, idx: torch.Tensor, e: int,
                group, tp=None) -> torch.Tensor:
    """The load-balance loss of the batch split over ``group``: the
    expert counts, the token count and the probability sums of the shards
    summed in one all-reduce that carries the gradient back to each
    shard's probabilities (and, under ``tp``, over the S chunks of
    ``model`` first, with an identity backward: each model rank's loss
    holds the whole aux)."""
    from repro_torch.sharding import tp as tp_lib
    from repro_torch.sharding.ep import differentiable
    stats = torch.cat([F.one_hot(idx, e).to(torch.float32).sum((0, 1)),
                       torch.tensor([float(idx.shape[0])],
                                    device=idx.device),
                       probs_full.sum(0)])
    if tp is not None:
        stats = tp_lib.reduce_from_model(stats, tp)
    if group is not None:
        tp_lib.book("all-reduce", stats.numel() * 4, group)
        stats = differentiable("all_reduce")(stats, group=group)
    counts, tokens, prob_sums = stats[:e], stats[e], stats[e + 1:]
    return e * torch.sum(counts / tokens * (prob_sums / tokens))


def _expert_ffn_dense(params: dict, x_flat: torch.Tensor, probs, idx,
                      cfg: ArchConfig) -> torch.Tensor:
    gate = torch.einsum("td,edf->tef", x_flat, params["wi_gate"])
    up = torch.einsum("td,edf->tef", x_flat, params["wi_up"])
    y_all = torch.einsum("tef,efd->ted", activation(cfg.act, gate) * up,
                         params["wo"])
    # the k experts of a token are distinct: a scatter, not an add
    combine = torch.zeros((x_flat.shape[0], cfg.num_experts),
                          dtype=x_flat.dtype, device=x_flat.device)
    combine = combine.scatter(1, idx, probs)
    return torch.einsum("te,ted->td", combine, y_all)


def _expert_ffn_gmm(params: dict, x_flat: torch.Tensor, probs, idx,
                    cfg: ArchConfig) -> torch.Tensor:
    t, d = x_flat.shape
    k, e = cfg.top_k, cfg.num_experts
    flat_expert = idx.reshape(-1)                               # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    x_sorted = x_flat[order // k]                               # [T*k, d]
    # one host read a layer: the segments' lengths (balanced on meta)
    if x_flat.device.type == "meta":
        sizes = [t * k // e + (i < t * k % e) for i in range(e)]
    else:
        sizes = torch.bincount(flat_expert, minlength=e).tolist()
    ys = []
    for ex, xs in enumerate(torch.split(x_sorted, sizes)):
        if xs.shape[0]:
            h = activation(cfg.act, xs @ params["wi_gate"][ex]) * (
                xs @ params["wi_up"][ex])
            ys.append(h @ params["wo"][ex])
    y = torch.cat(ys) * probs.reshape(-1)[order][:, None].to(ys[0].dtype)
    per_copy = torch.empty_like(y)
    per_copy[order] = y                                         # [T*k, d]
    per_copy = per_copy.reshape(t, k, d)
    by_expert = torch.argsort(idx, dim=1)                       # [T, k]
    per_copy = torch.gather(per_copy, 1,
                            by_expert[:, :, None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + per_copy[:, j]
    return out.to(x_flat.dtype)


def moe_apply(params: dict, x: torch.Tensor, cfg: ArchConfig,
              impl: str | None = None, tp=None, split: bool = False):
    """x [B, S, d] -> (y [B, S, d], aux_loss float32 scalar); ``tp``,
    ``split``: this rank's share (module docstring)."""
    from repro_torch.sharding import rules
    from repro_torch.sharding import tp as tp_lib
    from repro_torch.sharding.context import current_mesh
    impl = impl or cfg.moe_impl
    if impl == "ep_a2a":
        # routing happens on each data shard (sharding/ep.py)
        from repro_torch.sharding.ep import moe_apply_ep_a2a
        return moe_apply_ep_a2a(params, x, cfg, tp, split)
    if impl not in ("dense", "gmm"):
        raise ValueError(f"unknown moe_impl {impl!r}")
    group = rules.data_group(current_mesh())
    share = tp is not None and params["wi_gate"].shape[-1] < cfg.moe_d_ff
    d, k = x.shape[-1], cfg.top_k
    if split:                   # route this rank's chunk, then gather
        b, s_loc, _ = x.shape
        router = {"router": tp_lib.shared(params["router"], tp)}
        probs, idx, aux = router_topk(router, x.reshape(-1, d), cfg, group,
                                      tp)
        x = tp_lib.gather_seq(x, tp, partial_grad=share)
        probs = tp_lib.gather_seq(probs.reshape(b, s_loc, k), tp,
                                  partial_grad=share).reshape(-1, k)
        idx = tp_lib.gather(idx.reshape(b, s_loc, k), tp, 1).reshape(-1, k)
    else:
        probs, idx, aux = router_topk(params, x.reshape(-1, d), cfg, group)
        if share:
            x, probs = (tp_lib.copy_to_model(t, tp) for t in (x, probs))
    b, s, _ = x.shape
    ffn = _expert_ffn_dense if impl == "dense" else _expert_ffn_gmm
    y = ffn(params, x.reshape(-1, d), probs, idx, cfg).reshape(b, s, d)
    return tp_lib.leave(y, tp, split, whole=not share), aux
