"""Telemetry: the observability layer of sessions, fleets and the serve
engine.

Counterpart of ``repro/telemetry/``.  One :class:`Telemetry` owns a
:class:`MetricsRegistry` (every counter the port keeps: wire bits, DP
releases, budget skips, admission outcomes, cache and batch events) and a
:class:`SpanTracer` (session -> round -> hop on the train path, flush ->
flush_wave -> bucket_dispatch on the serve path), and wires them into a
run::

    tele = Telemetry()
    proto = Protocol(..., telemetry=tele, device="cuda")
    proto.fit(...)
    tele.write_artifacts(trace="run.jsonl", metrics_out="run.json",
                         transport=proto.transport)

The invariant (tests/test_torch_telemetry.py, chip_smoke phase 17): a run
with telemetry is bit for bit the run without it, and makes the same
launches of the hand-written kernels.  Telemetry reads values the run
already computed and draws nothing; without ``live`` it adds no device
work inside a program, and its fences (:meth:`Telemetry.fence`) sit at
dispatch boundaries.  ``live=True`` adds the live plane
(:mod:`repro_torch.telemetry.live`): compiled programs tap each round
into the registry while they run, and a tap costs its round a few small
device ops (pricing and packing the round's values) and one copy
(chip_smoke phase 17(b) counts both).

Emission sits at the choke points both backends share
(``TransportLog.send_bits``, ``PrivacyAccountant.record``,
``BudgetedTransport.record_skip``/``record_spend``,
``BudgetAwareScheduler.round_order``): eager hops emit as they happen,
the compiled backend while its replay books the program's ledger, so an
eager and a compiled run give equal registries wherever their ledgers
agree.  The metric names, labels, span tree and trace schema are the
reference's: each package's checker accepts the other's files.
"""
from __future__ import annotations

from repro_torch.telemetry.export import (StreamingTraceWriter, snapshot,
                                          write_metrics, write_trace)
from repro_torch.telemetry.live import LiveSink
from repro_torch.telemetry.registry import MetricsRegistry
from repro_torch.telemetry.slo import SLOConfig, SLOTracker
from repro_torch.telemetry.spans import Span, SpanTracer

__all__ = ["LiveSink", "MetricsRegistry", "SLOConfig", "SLOTracker", "Span",
           "SpanTracer", "StreamingTraceWriter", "Telemetry", "snapshot",
           "write_metrics", "write_trace"]


class Telemetry:
    """Registry, tracer and the attach and export plumbing of one run.

    ``profile`` also opens a ``torch.profiler.record_function`` range a
    span (run it under ``torch.profiler.profile``); :meth:`fence` waits
    at dispatch boundaries so that spans time the computation; ``live``
    opens the live plane, whose sink compiled programs stream their
    rounds to while they run.
    """

    def __init__(self, *, profile: bool = False, live: bool = False):
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(self.registry, profile=profile)
        self.live: LiveSink | None = (LiveSink(self.registry)
                                      if live else None)
        self._stream: StreamingTraceWriter | None = None

    def stream_trace(self, path: str) -> StreamingTraceWriter:
        """Open a JSONL trace at ``path`` that is written as the run goes:
        the meta line now, each span as it closes, live events as they
        arrive, and the metric events when :meth:`write_artifacts` (or
        the writer's ``close``) seals it."""
        self._stream = StreamingTraceWriter(path, registry=self.registry,
                                            tracer=self.tracer)
        if self.live is not None:
            self.live.writer = self._stream
        return self._stream

    def span(self, name: str, step: int | None = None, **attrs):
        return self.tracer.span(name, step, **attrs)

    def fence(self, value):
        return self.tracer.fence(value)

    # ------------------------------------------------------------- attach
    def attach_transport(self, transport) -> None:
        """Point a transport's ledger and accountant at this registry.
        Idempotent, and it backfills: entries, budget skips and DP
        releases booked before the attach are counted once, budgeted
        entries with the rung that priced them."""
        log = getattr(transport, "log", None)
        if log is None and hasattr(transport, "send_bits"):
            log = transport                  # a bare TransportLog
        if log is not None and \
                getattr(log, "registry", None) is not self.registry:
            for e in log.entries:
                self.registry.inc("wire_bits_total", e["bits"],
                                  kind=e["kind"], src=e["src"],
                                  dst=e["dst"])
                self.registry.inc("messages_total", 1, kind=e["kind"])
                if "rung" in e:
                    self.registry.inc("hops_by_rung_total", 1,
                                      rung=e["rung"])
            for link in getattr(transport, "skipped", ()):
                self.registry.inc("budget_skips_total", 1,
                                  src=link[0], dst=link[1])
            log.registry = self.registry
        accountant = getattr(transport, "accountant", None)
        if accountant is not None and \
                getattr(accountant, "registry", None) is not self.registry:
            for agent, count in accountant.releases.items():
                self.registry.inc("dp_releases_total", count, agent=agent)
            accountant.registry = self.registry

    def sync_gauges(self, transport) -> None:
        """Copy the budget state that is not event-shaped (each link's
        spent bits, the exhausted flag) into gauges; called at export."""
        for (src, dst), bits in sorted(
                getattr(transport, "link_spent", {}).items()):
            self.registry.set_gauge("budget_link_spent_bits", bits,
                                    src=src, dst=dst)
        if hasattr(transport, "exhausted"):
            self.registry.set_gauge("budget_exhausted",
                                    int(transport.exhausted))

    # ------------------------------------------------------------- export
    def write_artifacts(self, *, trace: str | None = None,
                        metrics_out: str | None = None,
                        transport=None) -> None:
        """Write what ``--trace`` (the JSONL event log) and
        ``--metrics-out`` (a JSON snapshot, or Prometheus text for a
        ``.prom`` path) ask for; a trace streamed to the same path is
        sealed instead of rewritten."""
        if transport is not None:
            self.sync_gauges(transport)
        if trace:
            if self._stream is not None and self._stream.path == trace:
                self._stream.close()
            else:
                write_trace(trace, registry=self.registry,
                            tracer=self.tracer)
        if metrics_out:
            write_metrics(metrics_out, self.registry, self.tracer)
