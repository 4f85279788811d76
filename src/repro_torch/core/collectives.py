"""The ring interchange over a mesh (``agent`` x ``data``).

Counterpart of ``repro/core/collectives.py``.  The paper's chain
1 -> 2 -> ... -> M -> 1 is a ring: with an ``agent`` axis (ranks a
agent) and a ``data`` axis (the length-n score sharded like the batch),
one interchange hop is

  * the local update ``w <- w * exp(alpha(1 - r)) / Z`` (the ignorance
    kernel's unnormalized mode, with the normalizer Z made global by an
    ``all_reduce`` over ``data``: ``ops.ignorance_update(group=)``), then
  * a neighbour exchange along ``agent`` (``batch_isend_irecv``: agent m
    sends to m + 1, agent 0 receives M - 1's), n / |data| floats a rank.

:func:`interchange_step` works on a rank's shard; :func:`make_ring_interchange`
wires it for a mesh and takes and returns full tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def _ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i of ``group`` receives rank i - 1's ``x`` (mod the size)."""
    import torch.distributed as dist
    size = dist.get_world_size(group)
    if size == 1:
        return x
    me = dist.get_rank(group)
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(),
                   dist.get_global_rank(group, (me + 1) % size), group=group),
        dist.P2POp(dist.irecv, out,
                   dist.get_global_rank(group, (me - 1) % size), group=group)])
    for req in reqs:
        req.wait()
    return out


def interchange_step(w_shard: torch.Tensor, r_shard: torch.Tensor,
                     alpha: torch.Tensor, *, agent_group,
                     data_group=None) -> torch.Tensor:
    """One hop of Algorithm 1 (eqs. 10/12) on this rank's shard of a score
    sharded over ``data_group`` (None: the whole score).  Returns the shard
    this rank holds for the next agent: the previous agent's update, after
    the ring shift along ``agent_group``."""
    w_new = ops.ignorance_update(w_shard, r_shard, alpha, group=data_group)
    return _ring_shift(w_new, agent_group)


def make_ring_interchange(mesh, *, agent_axis: str = "agent",
                          data_axis: str = "data"):
    """The ring interchange over ``mesh`` (a
    :class:`~repro_torch.sharding.context.Mesh`), as ``step(w, r, alpha)``.

    Full tensors that every rank passes alike: w [M, n] (each agent's
    score), r [M, n] (each agent's rewards), alpha [M], M the ``agent``
    axis's size and n divisible by the ``data`` axis's.  Each rank takes
    its agent's row and its ``data`` slice, runs :func:`interchange_step`,
    and the shards are all-gathered, so every rank returns the full
    w' [M, n], where agent m + 1 holds agent m's updated score (the
    reference's ``jnp.roll(update, 1, axis=0)``)."""
    import torch.distributed as dist
    agents = mesh.shape[agent_axis]
    parts = mesh.shape.get(data_axis, 1)
    agent_group = mesh.group(agent_axis)
    data_group = mesh.group(data_axis) if data_axis in mesh.shape else None
    m = mesh.coordinate(agent_axis)
    d = mesh.coordinate(data_axis) if data_group is not None else 0
    # the global rank of each (agent, data) cell, for the gather
    cells = mesh.device_mesh.mesh.permute(
        mesh.axis_names.index(agent_axis),
        *([mesh.axis_names.index(data_axis)] if data_group is not None
          else [])
    ).reshape(agents, parts).tolist()
    if mesh.size != agents * parts:
        raise ValueError(f"the ring runs on a mesh of {agent_axis} and "
                         f"{data_axis} only, got {mesh.shape}")

    def step(w: torch.Tensor, r: torch.Tensor,
             alpha: torch.Tensor) -> torch.Tensor:
        if w.shape[0] != agents or w.shape[1] % parts:
            raise ValueError(f"w {tuple(w.shape)} does not shard over "
                             f"{agents} agents x {parts} data parts")
        size = w.shape[1] // parts
        cut = slice(d * size, (d + 1) * size)
        mine = interchange_step(w[m, cut].contiguous(),
                                r[m, cut].contiguous(), alpha[m],
                                agent_group=agent_group,
                                data_group=data_group)
        shards = [torch.empty_like(mine) for _ in range(mesh.size)]
        dist.all_gather(shards, mine)
        return torch.stack([torch.cat([shards[cells[a][p]]
                                       for p in range(parts)])
                            for a in range(agents)])

    return step
