"""One-program FedAvg: the homogeneous round over a participation mask.

Counterpart of ``repro/scenarios/compiled.py``.  ASCII's compiled backend
cannot lower scenario churn (the chain's shape changes a round);
FedAvg's round is a star over a fixed roster, so churn is a boolean mask
over fixed work: every roster slot fits every round, and slots that do
not take part are masked out of the average.  The whole session is then
one fixed-shape program over the scenario's [T, M] mask, carrying the
spent-bit and link-bit counters, with the noise once and then every rung's
codec per uplink (``core.compiled``'s channel decomposition), and it is
bit for bit the eager :class:`~repro_torch.scenarios.protocols.
FedAvgVariant` loop: skipped hops, the exhaustion round and all
(tests/test_torch_scenarios.py).

The roster slots are unrolled in Python and fit one by one, never
``torch.func.vmap``-ed: a vmapped backward sums in another order, and the
program must equal the eager fits bit for bit.  The participation mask is
a device tensor; ``live``, ``stopped``, ``exhausted`` and the spent-bit
counters stay on the device, and from its first launch to its return the
program reads nothing back to the host.  Its draws are taken first
(:func:`draws_for`): a slot's fit and uplink
draws at ``(round, slot)``, those of a slot or round that does not run
included and simply unused (the reference freezes its key on a dead
round; coordinates need no freeze).  The ledger is replayed afterwards
(``FedAvgVariant._replay``) and the round history rebuilt
(``FedAvgVariant._history``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.comm.codecs import channel_apply
from repro_torch.comm.draws import (ChannelDraws, TensorHopDraws,
                                    session_draws)
from repro_torch.core.compiled import (_INT32_MAX, SlotDraws, _full,
                                       ladder_walk, rung_select)
from repro_torch.core.engine import (LabelsMsg, SampleIdsMsg, key_data,
                                     tree_map)
from repro_torch.scenarios.protocols import (fedavg_combine,
                                             fedavg_init_flat,
                                             fedavg_local_delta, one_hot,
                                             param_template)

#: A raw fp32 broadcast element (the downlink GradientMsg is never coded).
_RAW_BITS = 32


@dataclass(frozen=True)
class FedAvgPlan:
    """Everything static about one FedAvg run.  ``codec``, ``privacy`` and
    ``budget`` are the objects the eager transport holds (a budgeted plan
    nulls ``codec``: the ladder picks the rung)."""
    core: object
    num_classes: int
    num_agents: int
    max_rounds: int
    server_lr: float = 1.0
    codec: object = None
    privacy: object = None
    budget: object = None

    def __post_init__(self):
        if self.budget is not None:
            object.__setattr__(self, "codec", None)

    @property
    def ladder(self) -> tuple:
        if self.budget is not None:
            return self.budget.ladder
        return (self.codec,)

    @property
    def has_channel(self) -> bool:
        return (self.codec is not None or self.privacy is not None
                or self.budget is not None)


class FedAvgResult(NamedTuple):
    """What the replay and the history need, all fixed-shape tensors."""
    g: torch.Tensor          # [d] final flat global params
    g_trace: torch.Tensor    # [T, d] global params after each round
    executed: torch.Tensor   # [T] bool: round entered (not yet stopped)
    sent: torch.Tensor       # [T, M] bool: uplink crossed the wire
    codec_idx: torch.Tensor  # [T, M] int64 ladder rung of an uplink (-1)
    exhausted: torch.Tensor  # [] bool: the session budget ran dry


def make_fedavg_fn(plan: FedAvgPlan, feature_shape: tuple):
    """Lower ``plan`` into

        fedavg_fn(draws, Xs, classes, mask, fit_w) -> FedAvgResult

    a fixed-shape function of the pre-taken draws (:func:`draws_for`),
    the feature blocks, the labels, the [T, M] bool participation ``mask``
    and the [M, n] fit weights (non-IID shards ride it as data)."""
    core = plan.core
    k = plan.num_classes
    num = plan.num_agents
    privacy, budget = plan.privacy, plan.budget
    ladder = plan.ladder
    has_channel = plan.has_channel
    shape = tuple(feature_shape)
    d = param_template(core, shape).size
    if budget is not None:
        for cap in (budget.session_bits, budget.link_bits):
            if cap is not None and cap >= _INT32_MAX:
                raise ValueError(f"budget caps must fit int32 (the "
                                 f"reference's spent-bit counters), got "
                                 f"{cap}")
        costs = budget.payload_costs((d,))
        if max(costs) >= _INT32_MAX:
            raise ValueError("uplink payload costs must fit int32")
    bcast_bits = d * _RAW_BITS

    def fedavg_fn(draws: dict, Xs: tuple, classes: torch.Tensor,
                  mask: torch.Tensor, fit_w: torch.Tensor) -> FedAvgResult:
        n = classes.shape[0]
        onehot = one_hot(classes, k)
        g = draws["init"]
        stopped = torch.zeros((), dtype=torch.bool, device=g.device)
        carry: dict = {}
        if budget is not None:
            setup_bits = (num - 1) * (LabelsMsg("", "", n).bits
                                      + SampleIdsMsg("", "", n).bits)
            carry["spent"] = _full(setup_bits, g)
            carry["link"] = torch.zeros(num, dtype=torch.int64,
                                        device=g.device)
            carry["exhausted"] = torch.zeros_like(stopped)
        g_trace, executed_l, sent_rows, rung_rows = [], [], [], []
        for t in range(plan.max_rounds):
            mask_t = mask[t]
            executed = ~stopped
            # a round every participant churned out of runs nothing (the
            # eager engine never enters run_round for it)
            live = executed & torch.any(mask_t)
            rows, pmask, sent_l, rung_l = [], [], [], []
            for j in range(num):
                slot = tree_map(lambda x, _t=t: x[_t], draws["fit"][j])
                part = mask_t[j] & live
                dflat = fedavg_local_delta(core, shape, g,
                                           SlotDraws(slot.get("rows")),
                                           Xs[j], onehot, fit_w[j])
                if j == 0:
                    rows.append(dflat)        # the server's, off the wire
                    pmask.append(part)
                    sent_l.append(torch.zeros_like(part))
                    rung_l.append(_full(-1, g))
                    continue
                if not has_channel:
                    rows.append(dflat)
                    pmask.append(part)
                    sent_l.append(part)
                    rung_l.append(torch.where(part, _full(0, g),
                                              _full(-1, g)))
                    continue
                # the wire: the budget's rung, DP noise, the codec; the
                # walk and channel the eager Transport.ship runs
                if budget is not None:
                    rem = _full(_INT32_MAX, g)
                    if budget.session_bits is not None:
                        rem_s = _full(budget.session_bits, g) - carry["spent"]
                        rem = torch.minimum(rem, rem_s)
                    if budget.link_bits is not None:
                        rem = torch.minimum(rem, _full(budget.link_bits, g)
                                            - carry["link"][j])
                    rung = ladder_walk(costs, rem)
                    sendable = rung >= 0
                else:
                    rung = _full(0, g)
                    sendable = torch.ones_like(part)
                hop = TensorHopDraws(
                    draws["u"][t, j] if "u" in draws else None,
                    draws["z"][t, j] if "z" in draws else None)
                # the noise does not depend on the rung: once, then each
                # rung's codec, the eager fused channel's bits at its rung
                noised, _ = channel_apply(None, privacy, dflat, hop, None)
                pairs = [channel_apply(c, None, noised, hop, None)[0]
                         for c in ladder]
                d_hat = rung_select(rung, pairs, dflat)
                sent = part & sendable
                rows.append(torch.where(sent, d_hat, dflat))
                pmask.append(sent)
                sent_l.append(sent)
                rung_l.append(torch.where(sent, rung, _full(-1, g)))
                if budget is not None:
                    cost = rung_select(rung, [_full(c, g) for c in costs],
                                       _full(0, g))
                    add = torch.where(sent, cost, _full(0, g))
                    carry["spent"] = carry["spent"] + add
                    carry["link"] = carry["link"] + torch.where(
                        torch.arange(num, device=g.device) == j, add,
                        _full(0, g))
                    if budget.session_bits is not None:
                        carry["exhausted"] = carry["exhausted"] | (
                            part & (rem_s < min(costs)))
            g_new = fedavg_combine(g, torch.stack(rows), torch.stack(pmask),
                                   plan.server_lr)
            g = torch.where(live, g_new, g)
            if budget is not None:
                # the raw broadcast to each participating client counts
                # against the session cap (links are not charged for it)
                nb = torch.sum((mask_t[1:] & live).to(torch.int64))
                carry["spent"] = carry["spent"] + torch.where(
                    live, nb * bcast_bits, _full(0, g))
                if budget.session_bits is not None:
                    # the eager engine notices the exhaustion at the next
                    # round's entry: this round finishes, broadcast and all
                    stopped = stopped | carry["exhausted"]
            g_trace.append(g)
            executed_l.append(executed)
            sent_rows.append(torch.stack(sent_l))
            rung_rows.append(torch.stack(rung_l))
        return FedAvgResult(
            g=g, g_trace=torch.stack(g_trace),
            executed=torch.stack(executed_l), sent=torch.stack(sent_rows),
            codec_idx=torch.stack(rung_rows),
            exhausted=carry.get("exhausted", torch.zeros_like(stopped)))

    return fedavg_fn


def draws_for(plan: FedAvgPlan, key, n: int, feature_shape: tuple, device,
              source=None) -> dict:
    """Every draw one FedAvg session reads, taken before it runs: what
    :func:`~repro_torch.comm.draws.session_draws` takes over the flat
    delta's length d (slot j's uplink uniforms and normals at ``hop(key,
    t, j)``, [rounds, slots, d], every roster slot whether or not it takes
    part; each slot's fit draws but the init, since a fit warm-starts from
    ``g``), and ``"init"``: the flat ``g0`` from the source's
    :meth:`~repro_torch.comm.draws.ChannelDraws.init` stream."""
    core = plan.core
    shape = tuple(feature_shape)
    source = ChannelDraws() if source is None else source
    stochastic = any(getattr(c, "stochastic", False) for c in plan.ladder
                     if c is not None)

    def fit(j, fd):
        return {name: x for name, x in core.draw(fd, shape, n).items()
                if name != "init"}

    key = key_data(key)
    out = session_draws(key, plan.max_rounds, plan.num_agents,
                        param_template(core, shape).size, fit,
                        uniform=stochastic, normal=plan.privacy is not None,
                        device=device, source=source)
    out["init"] = fedavg_init_flat(core, shape, source.init(key))
    return out


def fedavg_session(plan: FedAvgPlan, key, Xs: Sequence[torch.Tensor],
                   classes: torch.Tensor, mask, fit_w: torch.Tensor, *,
                   source=None) -> FedAvgResult:
    """One FedAvg session as one program: its draws taken first (``key``:
    an int seed or uint32 key data; ``source``: the draw source, default
    :class:`~repro_torch.comm.draws.ChannelDraws`), then the program,
    which reads nothing back to the host.  ``mask`` is the scenario's
    [max_rounds, M] participation schedule, ``fit_w`` the [M, n]
    fit-weight table."""
    Xs = tuple(Xs)
    shapes = {tuple(x.shape[1:]) for x in Xs}
    if len(shapes) != 1:
        raise ValueError(f"fedavg needs one shared feature shape, got "
                         f"{sorted(shapes)}")
    shape = shapes.pop()
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.array(mask, dtype=bool))
    mask = mask.to(device=classes.device, dtype=torch.bool)
    if tuple(mask.shape) != (plan.max_rounds, plan.num_agents):
        raise ValueError(
            f"participation mask shape {tuple(mask.shape)} != "
            f"{(plan.max_rounds, plan.num_agents)}")
    draws = draws_for(plan, key, int(classes.shape[0]), shape,
                      classes.device, source)
    return make_fedavg_fn(plan, shape)(draws, Xs, classes, mask, fit_w)


__all__ = ["FedAvgPlan", "FedAvgResult", "draws_for", "fedavg_session",
           "make_fedavg_fn"]
