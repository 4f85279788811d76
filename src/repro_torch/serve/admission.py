"""Per-tenant admission control for prediction traffic.

Counterpart of ``repro/serve/admission.py``.  Every accepted request
spends two metered resources when it is served: wire bits (the encoded
ScoreBlockMsg traffic the ledger prices) and, under a DP serve channel,
one (ε, δ) release a non-head agent.  Admission gates on both before any
work is done (no block is computed, no session state touched for a denied
request), with three outcomes:

  * ``ACCEPT``: both gates pass; every agent's block crosses the serve
    channel.
  * ``DEGRADE``: a gate fails and the policy allows degrading: the request
    is served head-only (``deliver = [True, False, ...]`` on the serve
    step), at zero bits and zero releases.
  * ``DENY``: a gate fails and the policy forbids degrading.

The byte gate asks whether the tenant can afford the cheapest full serve
(the coarsest serve-ladder rung for every non-head block); the channel's
own degrade-then-skip walk handles the rest.  An accepted request reserves
that cost (and its releases) until ``book`` settles it with what the
ledger charged, so a burst of submits inside one batch window gates
against the requests in flight too.  The privacy gate asks whether the
full serve's releases would take the tenant past its ε cap under basic
composition.  The outcome counters live in the metrics registry as
``admission_outcomes_total{tenant, outcome}``; ``counters()`` reads them
back per tenant.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.comm.budget import TenantBudget
from repro_torch.telemetry.registry import MetricsRegistry

ACCEPT = "accept"
DEGRADE = "degrade"
DENY = "deny"


@dataclass(frozen=True)
class AdmissionPolicy:
    """What the gate does when a tenant's ledgers cannot cover a request:
    ``allow_degrade`` picks DEGRADE over DENY; ``epsilon_cap`` is the
    tenant's total ε under basic composition (None: no privacy gate)."""
    allow_degrade: bool = True
    epsilon_cap: float | None = None

    def __post_init__(self):
        if self.epsilon_cap is not None and self.epsilon_cap <= 0:
            raise ValueError(
                f"epsilon cap must be positive, got {self.epsilon_cap}")


@dataclass(frozen=True)
class Decision:
    """One verdict: the outcome, why, and what the gate reserved against
    the tenant's ledgers until ``book`` settles the request."""
    outcome: str
    reason: str = ""
    reserved_bits: int = 0
    reserved_releases: int = 0

    @property
    def admitted(self) -> bool:
        return self.outcome in (ACCEPT, DEGRADE)


@dataclass
class TenantAccount:
    """A tenant's gating state: its bit ledger, its DP releases and what
    requests in flight hold."""
    budget: TenantBudget = field(default_factory=TenantBudget)
    released: int = 0
    reserved_bits: int = 0
    pending_releases: int = 0


class AdmissionController:
    """The per-tenant gate in front of the serve engine.  ``tenant_bits``
    caps each new tenant's :class:`TenantBudget` (None: uncapped);
    ``mechanism`` is the serve channel's
    :class:`~repro_torch.comm.privacy.GaussianMechanism` (None: no privacy
    gate).  ``admit`` gives a :class:`Decision`; ``book`` settles the
    request with the bits the ledger booked and the releases recorded."""

    def __init__(self, policy: AdmissionPolicy | None = None, *,
                 tenant_bits: int | None = None, mechanism=None,
                 registry: MetricsRegistry | None = None) -> None:
        self.policy = policy if policy is not None else AdmissionPolicy()
        self.tenant_bits = tenant_bits
        self.mechanism = mechanism
        self.accounts: dict[str, TenantAccount] = {}
        self.registry = registry if registry is not None else MetricsRegistry()
        # an SLOTracker (the serve engine sets it): a denial is a violation
        self.slo = None

    def account(self, tenant: str) -> TenantAccount:
        if tenant not in self.accounts:
            self.accounts[tenant] = TenantAccount(
                budget=TenantBudget(bits=self.tenant_bits))
        return self.accounts[tenant]

    def admit(self, tenant: str, *, min_full_bits: int,
              releases: int) -> Decision:
        """Gate one request before any work: ``min_full_bits`` is the
        cheapest full serve's wire cost, ``releases`` the DP releases a
        full serve records (0 without a mechanism)."""
        acct = self.account(tenant)
        reasons = []
        if not acct.budget.affordable(min_full_bits + acct.reserved_bits):
            reasons.append(
                f"bits: need >= {min_full_bits}, remaining "
                f"{acct.budget.remaining - acct.reserved_bits}")
        if (self.policy.epsilon_cap is not None and self.mechanism is not None
                and releases > 0):
            spent = (acct.released + acct.pending_releases
                     + releases) * self.mechanism.epsilon
            if spent > self.policy.epsilon_cap:
                reasons.append(
                    f"epsilon: {releases} releases would spend "
                    f"{spent:.3g} > cap {self.policy.epsilon_cap:.3g}")
        if not reasons:
            acct.reserved_bits += min_full_bits
            acct.pending_releases += releases
            return Decision(ACCEPT, reserved_bits=min_full_bits,
                            reserved_releases=releases)
        reason = "; ".join(reasons)
        if self.policy.allow_degrade:
            return Decision(DEGRADE, reason)
        return Decision(DENY, reason)

    def book(self, tenant: str, decision: Decision, *, bits: int = 0,
             releases: int = 0) -> None:
        """Settle one decided request: a denial only counts; an admitted
        request frees its reservation and charges what it shipped."""
        acct = self.account(tenant)
        acct.reserved_bits -= decision.reserved_bits
        acct.pending_releases -= decision.reserved_releases
        if decision.outcome == DENY:
            self.registry.inc("admission_outcomes_total", 1, tenant=tenant,
                              outcome="denied")
            if self.slo is not None:
                self.slo.record_denial(tenant)
            return
        acct.budget.charge(int(bits))
        acct.released += int(releases)
        outcome = "degraded" if decision.outcome == DEGRADE else "served"
        self.registry.inc("admission_outcomes_total", 1, tenant=tenant,
                          outcome=outcome)

    def counters(self) -> dict:
        """{tenant: {served, degraded, denied, bits, released}}, tenants in
        order."""
        out = {}
        for t in sorted(self.accounts):
            acct = self.accounts[t]
            out[t] = {outcome: self.registry.value(
                          "admission_outcomes_total", tenant=t,
                          outcome=outcome)
                      for outcome in ("served", "degraded", "denied")}
            out[t]["bits"] = acct.budget.spent
            out[t]["released"] = acct.released
        return out
