"""Expert-parallel MoE with explicit all-to-all (``moe_impl="ep_a2a"``).

Counterpart of ``repro/sharding/ep.py``: the two-hop all-to-all schedule
over the mesh's ``data`` axis, with its fixed capacity.

  1. each data shard routes its T_loc * k (token, expert) picks to the
     shard owning that expert, in fixed-capacity buffers [D, C, d]: one
     all-to-all;
  2. the owner runs the grouped product over its E_loc experts, with the
     ff dimension sharded over ``model`` where ``moe_d_ff`` divides it (an
     all-reduce over ``model`` combines the ff partials);
  3. a second all-to-all returns the results; the source applies the gate
     probabilities and adds them into token order.

Tokens beyond capacity C = round_up(int(T_loc * k / D * cf) + 1, 128) are
dropped (Switch semantics).  The all-to-alls and the all-reduce are
``torch.distributed.nn.functional``'s, which carry gradients, so training
differentiates through them.  Without a mesh, or without a ``data`` axis,
``moe_apply(..., "ep_a2a")`` runs the grouped path, as the reference's
single-host fallback does.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import activation
from repro_torch.sharding.context import current_mesh


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(t_loc: int, cfg: ArchConfig, parts: int) -> int:
    """The per-destination buffer length C of a shard of ``t_loc``
    tokens over ``parts`` data shards."""
    return _round_up(int(t_loc * cfg.top_k / parts * cfg.capacity_factor)
                     + 1, 128)


def dispatch(dest: torch.Tensor, parts: int, cap: int):
    """The buffer slot of each (token, expert) copy: ``dest`` [T * k] the
    shard owning its expert.  Copies sorted by destination (stably, as
    ``jnp.argsort``), ranked within their destination by ``bincount``
    offsets; the first ``cap`` of each destination are kept, the rest go
    to the overflow slot ``parts * cap``, which is cut off.  Returns
    (order, keep, slot), ``keep`` and ``slot`` in sorted order."""
    order = torch.argsort(dest, stable=True)
    dest_s = dest[order]
    counts = torch.bincount(dest, minlength=parts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(dest.shape[0], device=dest.device) - starts[dest_s]
    keep = rank < cap
    slot = torch.where(keep, dest_s * cap + rank,
                       torch.full_like(rank, parts * cap))
    return order, keep, slot


def differentiable(name: str):
    """``torch.distributed.nn.functional.<name>`` (its deprecation notice
    silenced: it is the collective that carries a gradient)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        import torch.distributed.nn.functional as dnf
    fn = getattr(dnf, name)

    def call(*args, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            return fn(*args, **kw)
    return call


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal splits of x's leading axis exchanged over ``group``, with a
    gradient (the reverse exchange)."""
    return differentiable("all_to_all_single")(
        torch.empty_like(x), x.contiguous(), group=group)


def _grouped_ffn(xs: torch.Tensor, wg, wu, wo, sizes: list,
                 act: str) -> torch.Tensor:
    """The reference's ``ragged_dot`` over consecutive segments of
    ``sizes`` rows, segment e through expert e's banks: one product a
    non-empty segment."""
    ys = []
    for e, seg in enumerate(torch.split(xs, sizes)):
        if seg.shape[0]:
            h = activation(act, seg @ wg[e]) * (seg @ wu[e])
            ys.append(h @ wo[e])
    return torch.cat(ys)


def moe_apply_ep_a2a(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """This rank's shard: x [B_loc, S, d] (the batch sharded over the
    mesh's data axes), ``params`` the replicated ``router`` and this
    rank's expert banks, ``wi_gate``/``wi_up`` [E / D, d, f_loc] and
    ``wo`` [E / D, f_loc, d] (E over ``data``, f over ``model`` where it
    divides).  Returns (this rank's y [B_loc, S, d], aux): aux is the
    shards' router losses averaged over ``data`` (with a gradient back to
    each shard's router), the same on the ranks of a data group.  The
    mesh is :func:`current_mesh`'s."""
    import torch.distributed as dist
    from repro_torch.models import moe as moe_lib
    mesh = current_mesh()
    if mesh is None or "data" not in mesh.axis_names:
        return moe_lib.moe_apply(params, x, cfg, impl="gmm")
    data_g = mesh.group("data")
    model_ax = "model" if "model" in mesh.axis_names else None
    D = mesh.shape["data"]
    E, k = cfg.num_experts, cfg.top_k
    if E % D:
        raise ValueError(f"{E} experts do not shard over data {D}")
    e_loc = E // D
    if params["wi_gate"].shape[0] != e_loc:
        raise ValueError(f"expert banks of {params['wi_gate'].shape[0]} "
                         f"experts, expected this shard's {e_loc}")
    b_loc, s, d = x.shape
    t_loc = b_loc * s
    cap = capacity(t_loc, cfg, D)
    ff_split = bool(model_ax and mesh.shape[model_ax] > 1
                    and cfg.moe_d_ff % mesh.shape[model_ax] == 0)

    tl = x.reshape(-1, d)                                  # [T_loc, d]
    probs, idx, aux = moe_lib.router_topk(params, tl, cfg)
    flat_e = idx.reshape(-1)                               # [T_loc * k]
    p_flat = probs.reshape(-1)
    dest = flat_e // e_loc
    order, keep, slot = dispatch(dest, D, cap)
    tok_s = order // k

    def scatter(vals, fill=0.0):
        buf = torch.full((D * cap + 1,) + tuple(vals.shape[1:]), fill,
                         dtype=vals.dtype, device=vals.device)
        return buf.index_put((slot,), vals)[:-1]

    send_x = scatter(tl[tok_s])
    send_e = scatter(flat_e[order] % e_loc, e_loc)
    # ---- hop 1: tokens to their expert's shard
    recv_x = _all_to_all(send_x, data_g)                   # [D * cap, d]
    recv_e = torch.empty_like(send_e)
    dist.all_to_all_single(recv_e, send_e, group=data_g)
    # invalid / padded entries: expert 0 with a zero input
    valid = recv_e < e_loc
    re0 = torch.where(valid, recv_e, torch.zeros_like(recv_e))
    rx = torch.where(valid[:, None], recv_x, torch.zeros_like(recv_x))
    order2 = torch.argsort(re0, stable=True)
    sizes = torch.bincount(re0, minlength=e_loc).tolist()
    y = _grouped_ffn(rx[order2], params["wi_gate"], params["wi_up"],
                     params["wo"], sizes, cfg.act)         # [D * cap, d]
    y = y[torch.argsort(order2)]                           # back in slot order
    if ff_split:
        y = differentiable("all_reduce")(y, group=mesh.group(model_ax))
    # ---- hop 2: results back to their source shard
    back = _all_to_all(y, data_g)
    gathered = back[torch.where(keep, slot, torch.zeros_like(slot))]
    vals = gathered * (p_flat[order] * keep)[:, None].to(gathered.dtype)
    # a token's k copies, added in the order the scatter-add meets them
    # (sorted by destination shard), without atomics
    per_copy = torch.empty_like(vals).index_put((order,), vals)
    per_copy = per_copy.reshape(t_loc, k, d)
    by_dest = torch.argsort(dest.reshape(t_loc, k), dim=1, stable=True)
    per_copy = torch.gather(per_copy, 1,
                            by_dest[:, :, None].expand(t_loc, k, d))
    out = torch.zeros((t_loc, d), dtype=vals.dtype, device=x.device)
    for j in range(k):
        out = out + per_copy[:, j]
    aux = differentiable("all_reduce")(aux.reshape(1), group=data_g)[0] / D
    return out.reshape(b_loc, s, d).to(x.dtype), aux
