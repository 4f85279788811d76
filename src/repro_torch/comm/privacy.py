"""Differentially private interchange: the Gaussian mechanism on outgoing
score vectors, with per-agent epsilon accounting.

Counterpart of ``repro/comm/privacy.py``.  Before each hop the sender clips
its outgoing vector to an L2 ball of radius ``clip`` and adds
N(0, sigma^2 I) with the standard calibration

    sigma = clip * sqrt(2 ln(1.25/delta)) / epsilon,

so each release is (epsilon, delta)-DP for a one-sample change in the
clipped vector.  The noised vector is clamped at zero afterwards
(post-processing, free under DP), because ignorance scores are nonnegative
mass.  The normal draws ``z`` are an argument (the hop's
:class:`~repro_torch.comm.draws.HopDraws` supplies them).

:class:`PrivacyAccountant` tallies releases per agent under basic
composition; ``control/accounting.py`` holds the tighter RDP accountants.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class GaussianMechanism:
    """Per-release Gaussian mechanism on a clipped vector."""
    epsilon: float = 1.0
    delta: float = 1e-5
    clip: float = 1.0
    # signed payloads keep the raw noised vector (nonneg=False)
    nonneg: bool = True

    def __post_init__(self):
        if self.epsilon <= 0 or not (0 < self.delta < 1) or self.clip <= 0:
            raise ValueError(
                f"need epsilon > 0, 0 < delta < 1, clip > 0; got "
                f"({self.epsilon}, {self.delta}, {self.clip})")

    @property
    def sigma(self) -> float:
        return self.clip * math.sqrt(2.0 * math.log(1.25 / self.delta)) \
            / self.epsilon

    def apply(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Clip ``x`` to the L2 ball, add ``sigma * z`` (``z`` standard
        normal, x's shape), clamp at zero when the payload is mass."""
        x = x.to(torch.float32)
        # the norm's sum and root in float64, rounded: the same on the card
        # and the CPU (a float32 sum's rounding depends on its order)
        norm = torch.sqrt(torch.sum((x * x).to(torch.float64))).to(
            torch.float32)
        x = x * torch.clamp(self.clip / torch.clamp(norm, min=1e-12),
                            max=1.0)
        noised = x + self.sigma * z
        if not self.nonneg:
            return noised
        return torch.clamp(noised, min=0.0)


@dataclass
class PrivacyAccountant:
    """Per-agent (epsilon, delta) tally under basic composition: one
    (mechanism.epsilon, mechanism.delta) per release of that agent's
    vector."""
    releases: dict = field(default_factory=dict)   # agent name -> count

    # optional telemetry MetricsRegistry: a class attribute, not a field,
    # so that the RDP accountants' dataclass fields keep their order;
    # Telemetry sets it on the instance
    registry = None

    def record(self, agent: str) -> None:
        self.releases[agent] = self.releases.get(agent, 0) + 1
        if self.registry is not None:
            self.registry.inc("dp_releases_total", 1, agent=agent)

    def spent(self, agent: str, mechanism: GaussianMechanism
              ) -> tuple[float, float]:
        """Cumulative (epsilon, delta) spent by ``agent``."""
        k = self.releases.get(agent, 0)
        return k * mechanism.epsilon, k * mechanism.delta

    def report(self, mechanism: GaussianMechanism) -> dict:
        """{agent: {releases, epsilon, delta}} in name order."""
        return {name: {"releases": self.releases[name],
                       "epsilon": self.releases[name] * mechanism.epsilon,
                       "delta": self.releases[name] * mechanism.delta}
                for name in sorted(self.releases)}
