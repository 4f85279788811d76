"""Bit budgets: the byte ledger as an active constraint.

Counterpart of ``repro/comm/budget.py``.  A :class:`BudgetSpec` caps how
many bits a session (and optionally each directed src->dst link) may
spend, and :class:`BudgetedTransport` enforces it per hop in two stages:

  1. **degrade**: walk the codec ladder (best first) and ship the hop with
     the first codec whose wire cost still fits the remaining budget;
  2. **skip**: when not even the cheapest codec fits, the hop is dropped.
     The receiver keeps its stale ignorance score (the fit and its boosting
     component still happen).  A skip caused by the *session* budget marks
     the transport ``exhausted``, and ``Session.step`` stops scheduling
     rounds.

Ladder codecs must be stateless.  Setup messages count against the session
budget, interchange hops against both budgets, an async barrier's release
against the session budget alone (it is a broadcast, not a link).  An
adaptive controller or a serve controller on a budgeted transport shares
the budget's ladder, and its rung is a floor on the walk: the budget may
degrade further, never finer.  A protocol-variant hop (``ship``: a
FedAvg delta, an Assisted-Learning residual) walks the ladder over its
bare payload's costs against both budgets.  :class:`TenantBudget` is the
serve engine's per-tenant view of serve spend, which admission
(``repro_torch.serve.admission``) gates on.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.comm.codecs import Codec, Fp16Codec, Fp32Codec, QuantCodec
from repro_torch.core.engine import MeteredTransport

#: The scalar ModelWeightMsg that accompanies every shipped hop.
MODEL_WEIGHT_BITS = 32

DEFAULT_LADDER = (Fp32Codec(), Fp16Codec(), QuantCodec(bits=8),
                  QuantCodec(bits=4))


@dataclass(frozen=True)
class BudgetSpec:
    """Bit caps plus the degradation ladder (best codec first).
    ``session_bits`` caps everything the transport books; ``link_bits`` each
    directed (src, dst) link.  Either may be None (uncapped)."""
    session_bits: int | None = None
    link_bits: int | None = None
    ladder: tuple = DEFAULT_LADDER

    def __post_init__(self):
        if not self.ladder:
            raise ValueError("budget ladder must hold at least one codec")
        for c in self.ladder:
            if not isinstance(c, Codec) or c.stateful:
                raise ValueError(
                    f"budget ladder entries must be stateless Codecs, got "
                    f"{c!r} (error-feedback state cannot migrate between "
                    f"ladder rungs)")
        for cap in (self.session_bits, self.link_bits):
            if cap is not None and cap <= 0:
                raise ValueError(f"budget caps must be positive, got {cap}")

    def hop_costs(self, n: int) -> tuple:
        """Per-rung cost of one hop for a length-n score: the encoded
        IgnoranceMsg plus the scalar ModelWeightMsg."""
        return tuple(c.wire_bits(n) + MODEL_WEIGHT_BITS for c in self.ladder)

    def payload_costs(self, shape) -> tuple:
        """Per-rung encoded size of one bare payload of ``shape``."""
        return tuple(c.wire_bits(shape) for c in self.ladder)

    def serve_costs(self, shape) -> tuple:
        """Per-rung cost of one prediction-time ScoreBlockMsg (no model
        weight rides with it)."""
        return self.payload_costs(shape)

    def choose_costs(self, costs, remaining_session: float,
                     remaining_link: float, floor: int = 0) -> int | None:
        """First ladder index from ``floor`` on (a controller's rung) that
        both remaining budgets afford, or None when the hop must be
        skipped."""
        remaining = min(remaining_session, remaining_link)
        for i in range(floor, len(costs)):
            if costs[i] <= remaining:
                return i
        return None

    def choose(self, n: int, remaining_session: float,
               remaining_link: float, floor: int = 0) -> int | None:
        """:meth:`choose_costs` over the training-hop cost table."""
        return self.choose_costs(self.hop_costs(n), remaining_session,
                                 remaining_link, floor)


@dataclass
class TenantBudget:
    """A tenant's running serve-traffic bit ledger against an optional cap
    (``bits``, None: uncapped), shared by every session and request the
    tenant submits.  ``charge`` books the encoded bits a request shipped,
    the numbers the transport ledger prices, so the view and the ledger
    never drift."""
    bits: int | None = None
    spent: int = 0

    def __post_init__(self):
        if self.bits is not None and self.bits <= 0:
            raise ValueError(f"tenant bit cap must be positive, got "
                             f"{self.bits}")

    @property
    def remaining(self) -> float:
        return math.inf if self.bits is None else self.bits - self.spent

    def affordable(self, cost: int) -> bool:
        return cost <= self.remaining

    def charge(self, bits: int) -> None:
        if isinstance(bits, bool) or not isinstance(bits, int):
            raise TypeError(f"bits must be an integer, got {bits!r}")
        if bits < 0:
            raise ValueError(f"bits must be >= 0, got {bits}")
        self.spent += bits


class BudgetedTransport(MeteredTransport):
    """Byte-metered transport that enforces a :class:`BudgetSpec`: degrade
    down the codec ladder, then skip hops (see the module note)."""

    def __init__(self, budget: BudgetSpec, log=None, privacy=None,
                 controller=None, accountant=None, serve_controller=None):
        for name, ctrl in (("an adaptive controller", controller),
                           ("a serve controller", serve_controller)):
            if ctrl is not None and tuple(ctrl.ladder) != tuple(budget.ladder):
                raise ValueError(
                    f"{name} on a budgeted transport must share the "
                    f"budget's ladder (its rung is a floor on the same "
                    f"walk); got {ctrl.ladder} vs {budget.ladder}")
        super().__init__(log=log,
                         codec=None if controller is not None
                         else budget.ladder[0],
                         privacy=privacy, controller=controller,
                         accountant=accountant,
                         serve_controller=serve_controller)
        self.budget = budget
        self.link_spent: dict = {}      # (src, dst) -> bits
        self.skipped: list = []         # (src, dst) of dropped hops
        self.exhausted = False
        # rung of the latest ladder walk, stamped onto the ledger entry of
        # the wire-priced booking that follows it
        self._pending_rung: int | None = None
        # bits a paused run already spent against the session cap (restored
        # from SessionState.comm on resume; this process's log starts empty)
        self.carryover_bits = 0

    # ------------------------------------------------------- budget ledger
    # Every skip and every spend (the eager ladder walks, the compiled
    # replays of the engine and the scenarios) goes through these two
    # methods, so a telemetry registry on ``log`` sees the same budget
    # traffic on both backends.
    def record_skip(self, link) -> None:
        """Book one dropped hop on ``link`` = (src, dst)."""
        self.skipped.append(link)
        registry = getattr(self.log, "registry", None)
        if registry is not None:
            registry.inc("budget_skips_total", 1, src=link[0], dst=link[1])

    def record_spend(self, link, cost: int, rung: int) -> None:
        """Book ``cost`` bits of link spend for a hop shipped at ladder
        index ``rung``, and degrade ``codec`` to that rung."""
        self.codec = self.budget.ladder[int(rung)]
        self.link_spent[link] = self.link_spent.get(link, 0) + cost
        self._pending_rung = int(rung)
        registry = getattr(self.log, "registry", None)
        if registry is not None:
            registry.inc("hops_by_rung_total", 1, rung=int(rung))

    @property
    def effective_serve_codec(self):
        # serve_block walks the ladder and sets ``codec`` before shipping
        # (under a controller too: the serve ladder is the budget's)
        return self.serve_codec if self.serve_codec is not None else self.codec

    def _remaining(self, link) -> tuple[float, float]:
        rem_s = (math.inf if self.budget.session_bits is None
                 else self.budget.session_bits - self.log.total_bits
                 - self.carryover_bits)
        rem_l = (math.inf if self.budget.link_bits is None
                 else self.budget.link_bits - self.link_spent.get(link, 0))
        return rem_s, rem_l

    def _walk(self, costs, link, floor: int = 0,
              link_cap: bool = True) -> int | None:
        """The ladder walk from rung ``floor``: the rung to ship at (its
        spend booked), or None for a skip (booked; a session-budget skip
        flips ``exhausted``).  ``link_cap`` False walks against the session
        budget alone."""
        rem_s, rem_l = self._remaining(link)
        if not link_cap:
            rem_l = math.inf
        idx = self.budget.choose_costs(costs, rem_s, rem_l, floor)
        if idx is None:
            if rem_s < min(costs):
                self.exhausted = True
            self.record_skip(link)
            return None
        self.record_spend(link, costs[idx], idx)   # degrades codec too
        return idx

    def _admit(self, src, dst, w, rung) -> bool:
        """The hop's ladder walk from the controller's rung (0 without
        one): degrade, then skip (booked; the receiver keeps its stale
        score)."""
        return self._walk(self.budget.hop_costs(int(w.shape[0])),
                          (src.name, dst.name), rung) is not None

    def serve_block(self, src, dst, block, *, draws=None):
        """Budgeted serve hop: the same ladder walk over the [n, K] block's
        costs, from a serve controller's rung when there is one.  A skipped
        block is not delivered (None): the head predicts without this
        agent's votes and no bits are booked."""
        floor = (0 if self.serve_controller is None
                 else self.serve_controller.rung_for(block))
        link = (src.name, dst.name)
        if self._walk(self.budget.serve_costs(tuple(block.shape)), link,
                      floor) is None:
            return None
        return super().serve_block(src, dst, block, draws=draws)

    def barrier_release(self, head, w_bar, *, draws=None, codec_state=None):
        """Budgeted async release: one session-level ladder walk over the
        bare payload's costs (no link cap: the barrier is a broadcast).  A
        skip leaves the published score stale and flips ``exhausted``."""
        link = ("barrier", head.name)
        if self._walk(self.budget.payload_costs(int(w_bar.shape[0])), link,
                      link_cap=False) is None:
            return None, codec_state
        return super().barrier_release(head, w_bar, draws=draws,
                                       codec_state=codec_state)

    def ship(self, src, dst, payload, wrap, *, draws=None):
        """Budgeted protocol-variant hop: the same degrade-then-skip walk,
        priced at the bare encoded payload.  A skipped hop returns None
        (the receiver keeps its stale state: FedAvg's server averages
        without this client, AL's next agent fits the old residual); a
        session-budget skip flips ``exhausted``."""
        if self._walk(self.budget.payload_costs(tuple(payload.shape)),
                      (src.name, dst.name)) is None:
            return None
        return super().ship(src, dst, payload, wrap, draws=draws)
