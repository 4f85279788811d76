"""Rényi-DP (moments) accounting for the interchange privacy mechanism.

Counterpart of ``repro/control/accounting.py``, copied whole: it is pure
Python arithmetic on release counts.

The comm subsystem's :class:`~repro_torch.comm.privacy.PrivacyAccountant` tallies
releases under *basic* additive composition: k releases of an (ε, δ)
Gaussian mechanism report (kε, kδ).  That is honest but loose — over a long
session (or serve traffic, where every predict call releases per agent) the
reported budget grows linearly while the true privacy loss grows like √k.
:class:`RDPAccountant` is the tight replacement, a drop-in behind the same
interface (``record`` / ``spent`` / ``report`` / a ``releases`` dict that
rides the ``SessionState.comm`` snapshot unchanged):

  * each release of the Gaussian mechanism with noise multiplier
    ν = σ/clip has Rényi divergence ε_RDP(α) = α / (2ν²) at every order
    α > 1 (Mironov 2017, Prop. 7);
  * k releases compose *additively in RDP*: k·α / (2ν²) — the accountant
    state is still just the per-agent release count, which is why the
    checkpoint snapshot needs no changes;
  * conversion to (ε, δ) happens **on read**:
    ε(δ) = min_α [ k·α/(2ν²) + log(1/δ)/(α − 1) ] over a fixed order grid,
    reported at the mechanism's own δ.

The reported ε is additionally capped at the basic-composition value k·ε —
both are valid accountings of the same trace, so the tally may always
report the tighter pair.  When the cap binds, the report is the *proven*
additive pair (k·ε at δ = k·δ_mech), never k·ε at the smaller per-release
δ basic composition does not establish.  This keeps the invariant ("RDP
reports ε no larger than additive composition on the same trace") true by
construction at k = 1 — where the classical calibration's slack and the
RDP conversion overhead roughly cancel — while the RDP bound itself wins
whenever the per-release ε is moderate, with the gap widening like √k
vs k over a session.

Reads are *monotone-safe*: ``spent`` and ``report`` are pure functions of
the release counts (the conversion is cached per (k, ν, δ), never stored on
the accountant), so reading ε mid-session, checkpointing, and resuming can
neither double-count nor reset a release.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

from repro_torch.comm.privacy import GaussianMechanism, PrivacyAccountant

#: The order grid the (ε, δ) conversion minimizes over — the standard
#: moments-accountant spread: dense at low orders (small-k traces), doubling
#: into the tail (large-k traces push the optimum toward α → 1).
DEFAULT_ORDERS = (1.25, 1.5, 1.75, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0,
                  12.0, 16.0, 24.0, 32.0, 48.0, 64.0, 128.0, 256.0, 512.0)


@functools.lru_cache(maxsize=4096)
def _rdp_to_eps(k: int, nu: float, delta: float,
                orders: tuple) -> tuple[float, float]:
    """min over orders of k·α/(2ν²) + log(1/δ)/(α−1) → (ε, argmin α).

    Pure and cached per (k, ν, δ, orders): accountant reads never mutate
    accountant state (the monotone-safety contract)."""
    if k <= 0:
        return 0.0, float(orders[0])
    best_eps, best_order = math.inf, float(orders[0])
    log_inv_delta = math.log(1.0 / delta)
    for a in orders:
        eps = k * a / (2.0 * nu * nu) + log_inv_delta / (a - 1.0)
        if eps < best_eps:
            best_eps, best_order = eps, float(a)
    return best_eps, best_order


def rdp_epsilon(k: int, mechanism: GaussianMechanism,
                orders: tuple = DEFAULT_ORDERS) -> tuple[float, float, float]:
    """(ε, δ, argmin order) for k releases of ``mechanism``: the RDP
    composition converted at the mechanism's δ, or — when that is looser —
    the proven additive pair (k·ε, k·δ).  Order 0.0 marks the additive
    bound.  Both accountings are valid for the trace; the tighter-ε pair
    is returned, with the δ that bound actually establishes."""
    nu = mechanism.sigma / mechanism.clip
    eps, order = _rdp_to_eps(int(k), float(nu), float(mechanism.delta),
                             tuple(orders))
    additive = k * mechanism.epsilon
    if additive < eps:
        return additive, min(1.0, k * mechanism.delta), 0.0
    return eps, mechanism.delta, order


@dataclass
class RDPAccountant(PrivacyAccountant):
    """Per-agent release tally reported under Rényi-DP composition.

    Subclasses :class:`~repro_torch.comm.privacy.PrivacyAccountant`, so the
    state (``releases``) and the ``record`` path are identical — transports
    and the checkpoint snapshot treat both accountants
    interchangeably.  Only the *read* changes: ``spent`` returns the RDP ε
    at the mechanism's δ (never above k·ε), and ``report`` additionally
    carries the additive-composition ε for comparison.
    """
    orders: tuple = field(default=DEFAULT_ORDERS)

    def spent(self, agent: str, mechanism: GaussianMechanism
              ) -> tuple[float, float]:
        k = self.releases.get(agent, 0)
        if k == 0:
            return 0.0, 0.0
        eps, delta, _ = rdp_epsilon(k, mechanism, self.orders)
        return eps, delta

    def report(self, mechanism: GaussianMechanism) -> dict:
        out = {}
        for name in sorted(self.releases):
            k = self.releases[name]
            eps, delta, order = rdp_epsilon(k, mechanism, self.orders)
            out[name] = {"releases": k,
                         "epsilon": eps,
                         "delta": delta,
                         "epsilon_additive": k * mechanism.epsilon,
                         "rdp_order": order}
        return out


#: Integer order grid for the sampled-Gaussian-mechanism bound (the
#: binomial expansion below is exact at integer α only) — the integer
#: subset of DEFAULT_ORDERS' spread.
SUBSAMPLED_ORDERS = (2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 48, 64, 128, 256, 512)


@functools.lru_cache(maxsize=4096)
def sgm_rdp(alpha: int, q: float, nu: float) -> float:
    """One release of the sampled Gaussian mechanism at integer order α:
    each round every client is included independently-equivalently with
    probability q, so the released vector is the Gaussian mechanism applied
    to a q-subsample.  Mironov, Talwar & Zhang 2019 (Prop. 10 / eq. 3) give
    the exact integer-order bound

        ε(α) = log A(α) / (α − 1),
        A(α) = Σ_{k=0}^{α} C(α,k) q^k (1−q)^{α−k} exp((k² − k)/(2ν²)),

    evaluated in log space (lgamma binomials + logsumexp) so α = 512 does
    not overflow.  At q = 1 only the k = α term survives and the bound
    reduces exactly to the full-batch α/(2ν²)."""
    if not (0.0 < q <= 1.0):
        raise ValueError(f"subsampling rate must be in (0, 1], got {q}")
    if alpha < 2:
        raise ValueError(f"integer SGM orders start at 2, got {alpha}")
    if q == 1.0:
        return alpha / (2.0 * nu * nu)
    log_q, log_1q = math.log(q), math.log1p(-q)
    terms = []
    for k in range(alpha + 1):
        log_binom = (math.lgamma(alpha + 1) - math.lgamma(k + 1)
                     - math.lgamma(alpha - k + 1))
        terms.append(log_binom + k * log_q + (alpha - k) * log_1q
                     + (k * k - k) / (2.0 * nu * nu))
    hi = max(terms)
    log_a = hi + math.log(sum(math.exp(t - hi) for t in terms))
    return log_a / (alpha - 1)


def subsampled_rdp_epsilon(k: int, mechanism: GaussianMechanism, q: float,
                           orders: tuple = SUBSAMPLED_ORDERS
                           ) -> tuple[float, float, float]:
    """(ε, δ, argmin order) for k releases of ``mechanism`` under q-client
    subsampling: amplified SGM composition converted at the mechanism's δ,
    **capped at the full-batch RDP bound** (and, through it, the additive
    bound) so amplification is never looser than not claiming it.  Assumes
    secrecy of the sample — the adversary must not learn which clients a
    round actually included (the participation schedule is metadata here,
    so treat the amplified figure as the modeled best case).  Order 0.0
    marks a binding additive cap, matching :func:`rdp_epsilon`."""
    full = rdp_epsilon(k, mechanism)
    if k <= 0 or q >= 1.0:
        return full
    nu = mechanism.sigma / mechanism.clip
    log_inv_delta = math.log(1.0 / mechanism.delta)
    best_eps, best_order = math.inf, float(orders[0])
    for a in orders:
        eps = k * sgm_rdp(int(a), float(q), float(nu)) \
            + log_inv_delta / (a - 1.0)
        if eps < best_eps:
            best_eps, best_order = eps, float(a)
    if best_eps < full[0]:
        return best_eps, mechanism.delta, best_order
    return full


@dataclass
class SubsampledRDPAccountant(RDPAccountant):
    """RDP accountant with privacy amplification by client subsampling.

    ``q`` is the per-round client-inclusion rate (the Scenario's
    ``subsample`` knob); each recorded release is treated as one sampled-
    Gaussian release and composed in RDP.  The read-side contract matches
    :class:`RDPAccountant` exactly — same ``releases`` state and checkpoint
    snapshot — and the reported ε is capped at the
    full-batch RDP (hence additive) bound, so switching accountants can
    only tighten the report."""
    q: float = 1.0

    def __post_init__(self):
        if not (0.0 < self.q <= 1.0):
            raise ValueError(
                f"subsampling rate q must be in (0, 1], got {self.q}")

    def spent(self, agent: str, mechanism: GaussianMechanism
              ) -> tuple[float, float]:
        k = self.releases.get(agent, 0)
        if k == 0:
            return 0.0, 0.0
        eps, delta, _ = subsampled_rdp_epsilon(k, mechanism, self.q)
        return eps, delta

    def report(self, mechanism: GaussianMechanism) -> dict:
        out = {}
        for name in sorted(self.releases):
            k = self.releases[name]
            eps, delta, order = subsampled_rdp_epsilon(k, mechanism, self.q)
            full_eps, _, _ = rdp_epsilon(k, mechanism, self.orders)
            out[name] = {"releases": k,
                         "epsilon": eps,
                         "delta": delta,
                         "epsilon_full_batch": full_eps,
                         "epsilon_additive": k * mechanism.epsilon,
                         "q": self.q,
                         "rdp_order": order}
        return out


ACCOUNTANTS = {
    "basic": PrivacyAccountant,
    "rdp": RDPAccountant,
    "subsampled-rdp": SubsampledRDPAccountant,
}


def make_accountant(name: str, q: float | None = None) -> PrivacyAccountant:
    """Accountant registry lookup for CLI / benchmark names.  ``q`` is the
    client-subsampling rate; passing it upgrades ``rdp`` to the amplified
    accountant (and parameterizes ``subsampled-rdp``)."""
    if name not in ACCOUNTANTS:
        raise ValueError(
            f"unknown accountant {name!r}; expected {sorted(ACCOUNTANTS)}")
    if name == "subsampled-rdp" or (name == "rdp" and q is not None
                                    and q < 1.0):
        return SubsampledRDPAccountant(q=1.0 if q is None else float(q))
    return ACCOUNTANTS[name]()
