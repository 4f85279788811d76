"""Scenario engine: protocol variants x deployment-reality knobs.

Counterpart of ``repro/scenarios/``.  Two axes over the one engine and
channel stack:

  * :mod:`repro_torch.scenarios.scenario`: who shows up, with what data,
    when (client subsampling, straggler and dropout churn, non-IID shards,
    clock-skewed stale reads), as pure seeded schedules;
  * :mod:`repro_torch.scenarios.protocols`: what a round does (FedAvg and
    Assisted Learning as protocol variants, shipping GradientMsg and
    ResidualMsg traffic through the same codecs, budgets, DP noise and
    accountants as ASCII's interchange);
  * :mod:`repro_torch.scenarios.compiled`: FedAvg's homogeneous round as
    one fixed-shape program over the participation mask, bit for bit the
    eager loop.
"""
from repro_torch.scenarios.protocols import (PROTOCOLS,
                                             AssistedLearningVariant,
                                             FedAvgVariant, FittedAL,
                                             FittedFedAvg,
                                             fedavg_fit_weights,
                                             make_variant)
from repro_torch.scenarios.scenario import PARTITIONS, PRESETS, Scenario

__all__ = [
    "PARTITIONS", "PRESETS", "PROTOCOLS", "AssistedLearningVariant",
    "FedAvgVariant", "FittedAL", "FittedFedAvg", "Scenario",
    "fedavg_fit_weights", "make_variant",
]
