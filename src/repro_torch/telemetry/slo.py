"""Per-tenant latency SLOs and their error-budget burn.

Counterpart of ``repro/telemetry/slo.py`` (a copy; the reference module
is pure Python).  An SLO: a fraction ``objective`` of a tenant's requests
completes within ``threshold_s`` seconds.  The error budget is the
violation fraction ``1 - objective`` allows, and the burn is its share
used::

    burn = violations / (requests * (1 - objective))

below 1.0 the tenant is inside its objective.  An admission denial is a
violation: the tenant got no answer.  The state lives in the registry
(``slo_requests_total{tenant}``, ``slo_violations_total{tenant}``, the
``slo_burn{tenant}`` gauge).  :class:`~repro_torch.serve.engine.
ServeEngine` observes each request's submit-to-settle latency and each
denial.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.telemetry.registry import MetricsRegistry


@dataclass(frozen=True)
class SLOConfig:
    """One latency objective for every tenant: at least ``objective`` of
    the requests within ``threshold_s`` seconds."""
    threshold_s: float = 0.25
    objective: float = 0.99

    def __post_init__(self):
        if self.threshold_s <= 0:
            raise ValueError(f"threshold_s must be > 0, "
                             f"got {self.threshold_s}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), "
                             f"got {self.objective}")


class SLOTracker:
    """Folds request outcomes into per-tenant SLO counters and keeps the
    burn gauge current."""

    def __init__(self, config: SLOConfig,
                 registry: MetricsRegistry) -> None:
        self.config = config
        self.registry = registry

    def observe(self, tenant: str, seconds: float) -> None:
        """One completed request, its latency against the threshold."""
        self.registry.inc("slo_requests_total", 1, tenant=tenant)
        if seconds > self.config.threshold_s:
            self.registry.inc("slo_violations_total", 1, tenant=tenant)
        self._update_burn(tenant)

    def record_denial(self, tenant: str) -> None:
        """One admission denial: a violation."""
        self.registry.inc("slo_requests_total", 1, tenant=tenant)
        self.registry.inc("slo_violations_total", 1, tenant=tenant)
        self._update_burn(tenant)

    def _update_burn(self, tenant: str) -> None:
        self.registry.set_gauge("slo_burn", self.burn(tenant),
                                tenant=tenant)

    def burn(self, tenant: str) -> float:
        """The tenant's error-budget burn (0.0 before any request)."""
        requests = self.registry.value("slo_requests_total", tenant=tenant)
        if not requests:
            return 0.0
        violations = self.registry.value("slo_violations_total",
                                         tenant=tenant)
        return violations / (requests * (1.0 - self.config.objective))

    def report(self) -> dict:
        """{threshold_s, objective, tenants: {tenant: {requests,
        violations, burn, ok}}} for every tenant seen."""
        tenants = self.registry.label_values("slo_requests_total", "tenant")
        return {
            "threshold_s": self.config.threshold_s,
            "objective": self.config.objective,
            "tenants": {
                t: {"requests": self.registry.value("slo_requests_total",
                                                    tenant=t),
                    "violations": self.registry.value(
                        "slo_violations_total", tenant=t),
                    "burn": self.burn(t),
                    "ok": self.burn(t) < 1.0}
                for t in tenants},
        }
