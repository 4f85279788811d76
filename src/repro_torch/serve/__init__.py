"""The prediction service: continuous batching, a resident session cache
and per-tenant admission control.

Counterpart of ``repro/serve/``.  Three layers:

  * :mod:`repro_torch.serve.admission` -- the per-tenant gate (a byte
    budget and an (ε, δ) ledger) before any work: deny, degrade to
    head-only, or accept;
  * :mod:`repro_torch.serve.cache`     -- LRU residency over servable
    session states, spilled to checkpoints and restored exactly;
  * :mod:`repro_torch.serve.batcher`   -- continuous batching: requests in
    buckets by (plan, shapes), each bucket one batched serve program
    (:func:`repro_torch.core.compiled.serve_batch`).

:class:`~repro_torch.serve.engine.ServeEngine` puts them behind
``submit(tenant, session_id, Xs)`` / ``flush()``; the workload driver is
``repro_torch.launch.serve_fleet``.  A request served through a batch
equals the same request served alone, bit for bit.
"""
from repro_torch.serve.admission import (ACCEPT, DEGRADE, DENY,
                                         AdmissionController,
                                         AdmissionPolicy, Decision,
                                         TenantAccount)
from repro_torch.serve.batcher import Batcher, Slot
from repro_torch.serve.cache import ServeSessionState, SessionCache
from repro_torch.serve.engine import ServeEngine, ServeOutcome, SessionMeta

__all__ = [
    "ACCEPT", "DEGRADE", "DENY", "AdmissionController", "AdmissionPolicy",
    "Batcher", "Decision", "ServeEngine", "ServeOutcome",
    "ServeSessionState", "SessionCache", "SessionMeta", "Slot",
    "TenantAccount",
]
