"""Budget-aware round scheduling: spend the same bits in a better order.

Counterpart of ``repro/control/scheduler.py``.  Each round
:class:`BudgetAwareScheduler` orders the active agents by the ascending key

  1. bits the agent has spent as a sender: per-link spend on a
     :class:`~repro_torch.comm.budget.BudgetedTransport`, else the metered
     ledger's interchange tally by sender, else 0;
  2. minus an EMA of the agent's observed weighted accuracy (the
     ``Scheduler.observe`` hook the session calls after each fit), so ties
     break toward agents whose components earned more;
  3. the agent id,

so degradation and skips rotate across the cohort instead of starving a
fixed tail of the chain.  The EMA step is the reference's compiled
float32 arithmetic (``control.adaptive.ema_step``), so the stored EMAs are the
reference's values, bit for bit.  The order itself is
:func:`traced_round_order`, the rule as one tensor program (the
reference's in-scan twin, which its compiled backend lowers; the eager
``round_order`` calls it too).  The scheduler's state (the EMAs, and on a plain metered
transport the per-sender spend of the paused run) crosses a checkpoint
through ``SessionState.comm`` (``state_dict`` / ``load_state_dict``).

The compiled session takes :class:`BudgetAwarePlan`
(:meth:`BudgetAwareScheduler.plan`), carries the spend and the EMAs as
tensors, orders each round with :func:`traced_round_order` and advances
the EMAs with :func:`reward_ema_tensor`, the EMA step on the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.control.adaptive import ema_step, ema_step_tensor
from repro_torch.core.engine import Scheduler

#: The reward EMA's coefficient (the reference's default; no caller of
#: the port sets another).
REWARD_SMOOTHING = 0.5


def reward_ema_update(beta, prev, acc, fresh) -> np.float32:
    """One observed-reward EMA step in float32: ``acc`` on the first
    observation (``fresh``), else :func:`ema_step`."""
    if fresh:
        return np.float32(acc)
    return ema_step(beta, prev, acc)


def reward_ema_tensor(beta, prev: torch.Tensor, acc: torch.Tensor,
                      fresh: torch.Tensor) -> torch.Tensor:
    """:func:`reward_ema_update` on 0-d tensors, on their device: ``acc``
    where ``fresh``, else :func:`ema_step_tensor`; the same bits."""
    acc = acc.to(torch.float32)
    return torch.where(fresh, acc, ema_step_tensor(beta, prev, acc))


@dataclass(frozen=True)
class BudgetAwarePlan:
    """The static twin of :class:`BudgetAwareScheduler` that the compiled
    session lowers.  ``spend_signal`` names what the carried per-agent
    spend tracks: ``"link"`` (a budgeted transport's per-link spend),
    ``"wire"`` (a metered ledger's interchange bits by sender) or
    ``"none"`` (an unmetered transport: order by EMA and id alone).
    The reward EMA steps by :data:`REWARD_SMOOTHING`, as the eager
    scheduler's does."""
    spend_signal: str = "link"

    def __post_init__(self):
        if self.spend_signal not in ("link", "wire", "none"):
            raise ValueError(f"unknown spend_signal {self.spend_signal!r}")


def traced_round_order(spent: torch.Tensor,
                       ema: torch.Tensor) -> torch.Tensor:
    """The round permutation as a tensor program: agents sorted by
    ``(spent bits, -reward EMA, agent id)`` ascending (stable sorts from
    the last key to the first).  Returns int32 agent ids."""
    order = torch.arange(spent.shape[0], device=spent.device)
    neg = -ema.to(torch.float32)
    order = order[torch.sort(neg[order], stable=True).indices]
    order = order[torch.sort(spent[order], stable=True).indices]
    return order.to(torch.int32)


class BudgetAwareScheduler(Scheduler):
    """Order the active agents by remaining outgoing-link budget (module
    note)."""

    def __init__(self) -> None:
        self._transport = None
        self._reward_ema: dict[int, float] = {}
        # per-sender spend a paused run booked into a plain metered ledger
        # (the resumed transport's log starts empty); a budgeted transport
        # restores its link spend itself
        self._spent_baseline: dict[str, int] = {}

    # ---- engine hooks -------------------------------------------------------
    def bind_transport(self, transport) -> None:
        self._transport = transport

    def reset(self) -> None:
        self._reward_ema = {}
        self._spent_baseline = {}

    def observe(self, agent_id: int, acc: float) -> None:
        prev = self._reward_ema.get(agent_id)
        self._reward_ema[agent_id] = float(reward_ema_update(
            REWARD_SMOOTHING, 0.0 if prev is None else prev, acc,
            prev is None))

    def plan(self) -> BudgetAwarePlan:
        """The static twin for the compiled backend, its spend signal from
        the transport this scheduler is bound to."""
        t = self._transport
        signal = ("link" if hasattr(t, "link_spent")
                  else "wire" if hasattr(t, "log") else "none")
        return BudgetAwarePlan(spend_signal=signal)

    # ---- the ordering rule --------------------------------------------------
    def _by_src(self) -> dict[str, int]:
        t = self._transport
        by_src: dict[str, int] = {}
        if hasattr(t, "link_spent"):
            for (src, _dst), bits in t.link_spent.items():
                by_src[src] = by_src.get(src, 0) + int(bits)
        elif hasattr(t, "log"):
            by_src = dict(t.log.bits_by_src(("ignorance", "model_weight")))
            for src, bits in self._spent_baseline.items():
                by_src[src] = by_src.get(src, 0) + bits
        return by_src

    def _spent_by_agent(self, active: list[int]) -> dict[int, int]:
        t = self._transport
        if t is None:
            return {m: 0 for m in active}
        names = {ep.agent_id: ep.name for ep in t._endpoints.values()}
        by_src = self._by_src()
        return {m: by_src.get(names.get(m, ""), 0) for m in active}

    def round_order(self, round_idx: int, active: list[int]) -> list[int]:
        ids = sorted(active)   # ascending: an index tie-break is the id's
        spent = self._spent_by_agent(ids)
        order = traced_round_order(
            torch.tensor([spent.get(m, 0) for m in ids], dtype=torch.int64),
            torch.tensor([self._reward_ema.get(m, 0.0) for m in ids],
                         dtype=torch.float32))
        order = [ids[i] for i in order.tolist()]
        # telemetry (a registry on the transport's ledger): did the spend
        # reorder this round?  Read after the order is decided
        registry = getattr(getattr(self._transport, "log", None),
                           "registry", None)
        if registry is not None:
            registry.inc("scheduler_rounds_total", 1,
                         changed=order != sorted(active))
        return order

    # ---- checkpointing ------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-able state for ``SessionState.comm``: the reward EMAs and,
        on a plain metered transport, the per-sender spend so far."""
        state: dict = {"reward_ema": {str(m): v for m, v
                                      in sorted(self._reward_ema.items())}}
        t = self._transport
        if t is not None and not hasattr(t, "link_spent") \
                and hasattr(t, "log"):
            state["spent_by_src"] = dict(sorted(self._by_src().items()))
        return state

    def load_state_dict(self, state: dict) -> None:
        self._reward_ema = {int(m): float(v)
                            for m, v in state.get("reward_ema", {}).items()}
        self._spent_baseline = {s: int(b) for s, b
                                in state.get("spent_by_src", {}).items()}
