"""The serve engine: admission, then the resident cache, then continuous
batching.

Counterpart of ``repro/serve/engine.py``.  :class:`ServeEngine` turns
fitted compiled protocols into servable sessions and takes prediction
requests against them:

    engine = ServeEngine(cache_capacity=8, max_batch=8)
    engine.add_session("s0", fitted_protocol)
    rid, decision = engine.submit("tenant-a", "s0", Xs_block)
    outcomes = engine.flush()          # {rid: ServeOutcome}

``submit`` runs the tenant's admission first (deny, degrade to head-only,
or accept; a denied request touches no session state), then queues the
admitted request as a batch slot: the session's state from the LRU cache
(restored from its spill if evicted), its key data and the request id
(the serve draws are indexed by both), and the ``deliver`` mask.
``flush`` drains the queue through the bucketed batched serve programs
(:mod:`repro_torch.serve.batcher`) and books each request's ledger as
``Protocol._replay_serve`` books it for the request alone: a
``score_block`` entry per shipped block at its rung's encoded size under
session-prefixed endpoint names, the session's DP releases, its budget
counters counted down, and the tenant charged the bits the ledger booked.

The invariant (tests/test_torch_serve_engine.py): a request served
through a batch equals the same request served alone by
``Protocol.predict_distributed(Xs, request=rid)`` bit for bit:
predictions, booked bits, DP releases.  With ``telemetry=`` (a
:class:`repro_torch.telemetry.Telemetry`) every counter goes to its
registry, a flush opens the ``flush`` span (the batcher's
``flush_wave`` and ``bucket_dispatch`` under it), and with
``telemetry.live`` the bucket programs tap each request into the live
sink while they run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from time import perf_counter

import numpy as np
import torch

from repro_torch.comm.privacy import PrivacyAccountant
from repro_torch.core.compiled import _INT32_MAX
from repro_torch.core.transport import TransportLog
from repro_torch.serve.admission import DENY, AdmissionController, Decision
from repro_torch.serve.batcher import Batcher, Slot
from repro_torch.serve.cache import ServeSessionState, SessionCache
from repro_torch.telemetry.live import installed as live_installed
from repro_torch.telemetry.registry import MetricsRegistry
from repro_torch.telemetry.slo import SLOConfig, SLOTracker
from repro_torch.telemetry.spans import span_of


@dataclass
class SessionMeta:
    """The host half of a servable session (never spilled): the plan, the
    endpoint names, the device its tensors live on, its draw source, and
    the session's serve ledgers."""
    plan: object
    names: tuple
    device: torch.device
    draws: object = None
    accountant: PrivacyAccountant = field(default_factory=PrivacyAccountant)
    skipped: list = field(default_factory=list)
    exhausted: bool = False
    served: int = 0


@dataclass(frozen=True)
class ServeOutcome:
    """What one request came to: the admission verdict, the head's
    predictions (None when denied) and what it cost."""
    request_id: int
    session_id: str
    tenant: str
    decision: Decision
    preds: object = None
    bits: int = 0
    releases: int = 0


class ServeEngine:
    """Continuous-batching serve engine over fitted compiled protocols.
    ``device`` is where restored sessions go (the sessions' own device);
    every counter lives in one :class:`~repro_torch.telemetry.registry.
    MetricsRegistry` (``registry``: ``telemetry``'s when given, else the
    engine's own); ``slo`` tracks a latency objective per tenant."""

    def __init__(self, *, cache_capacity: int = 8, max_batch: int = 8,
                 spill_dir: str | None = None,
                 admission: AdmissionController | None = None,
                 telemetry=None, slo: SLOConfig | None = None,
                 device="cuda") -> None:
        self.telemetry = telemetry
        self.registry = (telemetry.registry if telemetry is not None
                         else MetricsRegistry())
        # the live plane: the bucket programs tap each request, and flush
        # installs this sink around them
        self.live = telemetry.live if telemetry is not None else None
        self.cache = SessionCache(cache_capacity, spill_dir,
                                  registry=self.registry, device=device)
        self.batcher = Batcher(
            max_batch=max_batch,
            resolve=lambda slot: self.cache.get(slot.session_id),
            registry=self.registry,
            tracer=telemetry.tracer if telemetry is not None else None,
            live=self.live is not None)
        self.admission = (admission if admission is not None
                          else AdmissionController())
        self.slo = SLOTracker(slo, self.registry) if slo is not None else None
        self.admission.slo = self.slo
        # a caller's controller keeps what it counted: fold its counters
        # into the shared registry, then rebind it
        if self.admission.registry is not self.registry:
            for e in self.admission.registry.to_events():
                if e["type"] == "counter":
                    self.registry.inc(e["name"], e["value"], **e["labels"])
            self.admission.registry = self.registry
        self._submitted: dict[int, float] = {}
        self.log = TransportLog(registry=self.registry)
        self.sessions: dict[str, SessionMeta] = {}
        self.outcomes: dict[int, ServeOutcome] = {}
        self._next_request = 0

    # -------------------------------------------------------------- sessions
    def add_session(self, session_id: str, protocol) -> None:
        """Register a fitted ``backend="compiled"`` Protocol: its plan goes
        into the host registry, its arrays (params, alphas, valid, key
        data, the remaining budget read off its transport) into the
        cache."""
        if session_id in self.sessions:
            raise ValueError(f"session {session_id!r} already registered")
        ctx = getattr(protocol, "_compiled_ctx", None)
        if ctx is None:
            raise ValueError(
                "add_session needs a fitted backend='compiled' Protocol "
                "(the serve engine batches compiled serve steps)")
        endpoints, plan, result = ctx
        dev = result.alphas.device
        if dev.type != self.cache.device.type:
            raise ValueError(f"session {session_id!r} lives on {dev}, the "
                             f"engine on {self.cache.device}")
        rem_session, rem_link = protocol._serve_remaining(endpoints, plan)
        num = plan.num_agents
        state = ServeSessionState(
            params=result.params, alphas=result.alphas, valid=result.valid,
            key_data=np.asarray(protocol._session.state.key, np.uint32),
            rem_session=torch.full(
                (), _INT32_MAX if rem_session is None
                else min(rem_session, _INT32_MAX), dtype=torch.int32,
                device=dev),
            rem_link=torch.as_tensor(np.minimum(np.asarray(
                [_INT32_MAX] * num if rem_link is None else rem_link,
                np.int64), _INT32_MAX).astype(np.int32), device=dev))
        self.sessions[session_id] = SessionMeta(
            plan=plan, names=tuple(ep.name for ep in endpoints), device=dev,
            draws=protocol.draws)
        self.cache.put(session_id, state)

    def _min_full_bits(self, meta: SessionMeta, shape: tuple) -> int:
        """The cheapest full serve's wire cost: the coarsest serve rung's
        price (raw float32 for a None rung) for every non-head block."""
        raw = 32 * shape[0] * shape[1]
        cheapest = min((int(c.wire_bits(shape)) if c is not None else raw)
                       for c in meta.plan.serve_ladder)
        return cheapest * (len(meta.names) - 1)

    # ---------------------------------------------------------------- submit
    def submit(self, tenant: str, session_id: str, Xs,
               request: int | None = None) -> tuple[int, Decision]:
        """Gate and queue one request; ``Xs`` holds the agents' feature
        blocks (as for ``Protocol.predict_distributed``).  Returns
        (request id, decision); a denied request completes here, with no
        predictions, an admitted one at the next :meth:`flush`."""
        meta = self.sessions[session_id]
        rid = self._next_request if request is None else int(request)
        self._next_request = max(self._next_request, rid) + 1
        Xs = tuple(torch.as_tensor(x, device=meta.device) for x in Xs)
        if len(Xs) != len(meta.names):
            raise ValueError(f"session {session_id!r} has "
                             f"{len(meta.names)} agents, got {len(Xs)} "
                             f"feature blocks")
        shape = (int(Xs[0].shape[0]), meta.plan.num_classes)
        releases = (len(meta.names) - 1
                    if meta.plan.privacy is not None else 0)
        decision = self.admission.admit(
            tenant, min_full_bits=self._min_full_bits(meta, shape),
            releases=releases)
        if decision.outcome == DENY:
            self.admission.book(tenant, decision)
            self.outcomes[rid] = ServeOutcome(rid, session_id, tenant,
                                              decision)
            return rid, decision
        state = self.cache.get(session_id)
        deliver = np.ones(len(meta.names), bool)
        if decision.outcome == "degrade":
            deliver[1:] = False                     # head-only
        self._submitted[rid] = perf_counter()
        self.batcher.add(Slot(
            request_id=rid, session_id=session_id, tenant=tenant,
            plan=meta.plan, key=state.key_data, Xs=Xs, deliver=deliver,
            decision=decision, request=rid, source=meta.draws))
        return rid, decision

    # ----------------------------------------------------------------- flush
    def _book(self, slot: Slot, res) -> ServeOutcome:
        """Settle one served slot: the serve ledger the request alone books
        (``Protocol._replay_serve``), under session-prefixed endpoint
        names, the session's counters, and the tenant's charge."""
        sid = slot.session_id
        meta = self.sessions[sid]
        plan, names = meta.plan, meta.names
        shape = (int(slot.Xs[0].shape[0]), plan.num_classes)
        ladder = plan.serve_ladder
        budgeted = plan.budget is not None
        head = f"{sid}:{names[0]}"
        bits_total, releases = 0, 0
        link_cost = np.zeros(len(names), np.int64)
        for j in range(1, len(names)):
            if not slot.deliver[j]:
                continue            # head-only degrade: the hop never ran
            link = (f"{sid}:{names[j]}", head)
            if not res.sent[j]:
                meta.skipped.append(link)       # budget skip
                self.registry.inc("budget_skips_total", 1,
                                  src=link[0], dst=link[1])
                continue
            rung = int(res.codec_idx[j])
            codec = ladder[rung] if rung >= 0 else None
            bits = (int(codec.wire_bits(shape)) if codec is not None
                    else 32 * shape[0] * shape[1])
            self.log.send_bits(link[0], link[1], "score_block", bits)
            bits_total += bits
            link_cost[j] = bits
            if budgeted:
                self.registry.inc("hops_by_rung_total", 1, rung=rung)
            if plan.privacy is not None:
                meta.accountant.record(names[j])
                self.registry.inc("dp_releases_total", 1, agent=link[0])
                releases += 1
        if budgeted:
            state = self.cache.get(sid)
            state.rem_session = state.rem_session - min(bits_total,
                                                         _INT32_MAX)
            state.rem_link = state.rem_link - torch.as_tensor(
                np.minimum(link_cost, _INT32_MAX).astype(np.int32),
                device=state.rem_link.device)
            meta.exhausted = bool(meta.exhausted or bool(res.exhausted))
        meta.served += 1
        self.registry.inc("serve_requests_total", 1, session=sid)
        self.admission.book(slot.tenant, slot.decision, bits=bits_total,
                            releases=releases)
        t0 = self._submitted.pop(slot.request_id, None)
        if t0 is not None:
            seconds = perf_counter() - t0
            self.registry.observe("request_seconds", seconds,
                                  tenant=slot.tenant)
            if self.slo is not None:
                self.slo.observe(slot.tenant, seconds)
        return ServeOutcome(slot.request_id, sid, slot.tenant,
                            slot.decision, preds=res.preds,
                            bits=bits_total, releases=releases)

    def flush(self) -> dict:
        """Drain the queue through the bucketed batch programs and settle
        every request, wave by wave (a later request against the same
        session starts from the counters after the earlier one's spend).
        Returns {request id: ServeOutcome} for the requests this flush
        completed."""
        done = {}

        def settle(slot, res):
            out = self._book(slot, res)
            self.outcomes[out.request_id] = out
            done[out.request_id] = out

        with span_of(self.telemetry, "flush", queued=len(self.batcher)), \
                live_installed(self.live):
            self.batcher.flush(settle=settle)
        return done

    # --------------------------------------------------------------- summary
    def summary(self) -> dict:
        """Per-tenant counters, cache and batcher stats, each session's
        serve ledger."""
        out = {
            "tenants": self.admission.counters(),
            "cache": self.cache.stats(),
            "batcher": self.batcher.stats(),
            "sessions": {
                sid: {"served": m.served, "skipped": len(m.skipped),
                      "exhausted": m.exhausted,
                      "releases": dict(sorted(m.accountant.releases.items()))}
                for sid, m in sorted(self.sessions.items())},
            "total_bits": self.log.total_bits,
            "requests": len(self.outcomes),
        }
        if self.slo is not None:
            out["slo"] = self.slo.report()
        return out

    def close(self) -> None:
        self.cache.close()
