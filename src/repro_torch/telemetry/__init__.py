"""Telemetry: the metrics registry and the latency SLOs the serve engine
keeps.

Counterpart of ``repro/telemetry/``, the part the serve engine uses:
:mod:`repro_torch.telemetry.registry` (labeled counters, gauges and
histograms in one sink) and :mod:`repro_torch.telemetry.slo` (per-tenant
latency objectives and their error-budget burn).  Spans, live taps, the
exporters, the dashboard and the ``Telemetry`` bundle are later slices of
the port.
"""
from repro_torch.telemetry.registry import MetricsRegistry
from repro_torch.telemetry.slo import SLOConfig, SLOTracker

__all__ = ["MetricsRegistry", "SLOConfig", "SLOTracker"]
