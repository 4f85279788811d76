"""Telemetry exporters: JSONL event traces, JSON snapshots, Prometheus text.

Counterpart of ``repro/telemetry/export.py``, with its schema: the
constants below are the reference's, so each package's checker accepts
the other's files and :func:`load_registry` reads either package's
traces.  Three artifacts from one source (a :class:`~repro_torch.
telemetry.registry.MetricsRegistry` and, optionally, a
:class:`~repro_torch.telemetry.spans.SpanTracer`):

  * **JSONL trace** (``--trace file.jsonl``): a leading ``meta`` line,
    every closed span, then the registry's metric events; loss-free
    (:func:`load_registry` rebuilds an equal registry).
    :class:`StreamingTraceWriter` writes it as the run goes: a run killed
    midway leaves a prefix that ``python -m repro_torch.telemetry.check
    --allow-partial`` accepts.
  * **JSON snapshot** (``--metrics-out file.json``): {counters, gauges,
    histograms}, each series keyed by ``label=value`` pairs.
  * **Prometheus text** (``--metrics-out file.prom``): one scrape in the
    text exposition format, histograms as cumulative ``_bucket{le}``
    samples with ``_sum``/``_count`` and ``_min``/``_max`` gauges.
"""
from __future__ import annotations

import json

from repro_torch.telemetry.registry import BUCKET_BOUNDS, MetricsRegistry

SCHEMA = "repro-telemetry"
#: v2 added bucketed histograms ("buckets" on histogram events /
#: snapshot leaves, ``_bucket{le=...}`` Prometheus exposition) and the
#: in-flight "live" event kind the streaming taps emit.  v1 traces
#: (bucketless histograms, no live events) still validate and reload.
SCHEMA_VERSION = 2
ACCEPTED_VERSIONS = (1, 2)


def meta_event() -> dict:
    return {"type": "meta", "schema": SCHEMA, "version": SCHEMA_VERSION}


def trace_events(registry: MetricsRegistry | None = None,
                 tracer=None) -> list[dict]:
    """The full JSONL payload: meta line, spans, then metric events."""
    events = [meta_event()]
    if tracer is not None:
        events.extend(tracer.to_events())
    if registry is not None:
        events.extend(registry.to_events())
    return events


def write_trace(path: str, *, registry: MetricsRegistry | None = None,
                tracer=None) -> int:
    """Write the JSONL event log; returns the number of events written."""
    events = trace_events(registry, tracer)
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e, sort_keys=True) + "\n")
    return len(events)


class StreamingTraceWriter:
    """Incremental JSONL trace export: the meta line lands on disk at open,
    every span is appended (and flushed) the moment it closes, and the
    registry's metric events are appended at :meth:`close`.

    This is the crash-durable twin of :func:`write_trace`: a session that
    dies mid-run leaves a truncated-but-well-formed *prefix* on disk —
    every span that finished survives — which ``repro_torch.telemetry.check
    --allow-partial`` accepts (a prefix may reference a parent span that
    had not closed yet, and its final line may be torn mid-write).  A run
    that reaches :meth:`close` produces a trace
    :func:`~repro_torch.telemetry.check.validate_events` accepts un-relaxed;
    spans appear in *close* order rather than :func:`write_trace`'s open
    order, which no consumer distinguishes (:func:`load_registry` reads
    only metric events, the validator is order-blind past the meta line).
    """

    def __init__(self, path: str, *, registry: MetricsRegistry | None = None,
                 tracer=None) -> None:
        self.path = path
        self.registry = registry
        self.tracer = tracer
        self.events_written = 0
        self._f = open(path, "w")
        self._emit(meta_event())
        if tracer is not None:
            tracer.on_close = self._on_span

    def _emit(self, event: dict) -> None:
        self._f.write(json.dumps(event, sort_keys=True) + "\n")
        self._f.flush()
        self.events_written += 1

    def _on_span(self, span) -> None:
        if not self._f.closed:
            self._emit(span.to_event())

    def write_event(self, event: dict) -> None:
        """Append one extra event mid-stream (the live-emission taps push
        their per-round progress events here while the compiled program is
        still executing).  Dropped silently after :meth:`close` — a tap
        that outlives the trace has nowhere durable to land anyway."""
        if not self._f.closed:
            self._emit(event)

    def close(self) -> int:
        """Append the metric events and seal the file; returns the total
        event count.  Idempotent (a second close is a no-op)."""
        if self._f.closed:
            return self.events_written
        if self.registry is not None:
            for e in self.registry.to_events():
                self._emit(e)
        self._f.close()
        if self.tracer is not None and self.tracer.on_close == self._on_span:
            self.tracer.on_close = None
        return self.events_written

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_events(path: str, *, allow_partial: bool = False) -> list[dict]:
    """Parse a JSONL trace.  ``allow_partial`` tolerates a torn final line
    (a streaming writer killed mid-``write``): the un-parseable tail line
    is dropped instead of raising; a torn line anywhere *else* still
    raises — truncation only ever eats the end of a stream."""
    events = []
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    lines = [ln for ln in lines if ln]
    for i, line in enumerate(lines):
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if allow_partial and i == len(lines) - 1:
                break
            raise
    return events


def load_registry(path: str) -> MetricsRegistry:
    """Rebuild the metrics registry from a JSONL trace (span and meta
    events are ignored; metric events reload loss-free)."""
    return MetricsRegistry.from_events(
        [e for e in load_events(path)
         if e.get("type") in ("counter", "gauge", "histogram")])


# ------------------------------------------------------------------ snapshots
def snapshot(registry: MetricsRegistry, tracer=None) -> dict:
    """Nested JSON-able snapshot: per-metric series keyed by a stable
    ``label=value`` joined string (empty-label series key "")."""
    def nest(events_of_type, value_of):
        out: dict = {}
        for e in events_of_type:
            key = ",".join(f"{k}={v}" for k, v in sorted(e["labels"].items()))
            out.setdefault(e["name"], {})[key] = value_of(e)
        return out

    events = registry.to_events()
    doc = {
        "schema": SCHEMA, "version": SCHEMA_VERSION,
        "counters": nest((e for e in events if e["type"] == "counter"),
                         lambda e: e["value"]),
        "gauges": nest((e for e in events if e["type"] == "gauge"),
                       lambda e: e["value"]),
        "histograms": nest(
            (e for e in events if e["type"] == "histogram"),
            lambda e: {k: e[k] for k in
                       ("count", "sum", "min", "max", "buckets")
                       if k in e}),
    }
    if tracer is not None:
        doc["spans"] = len(tracer.spans)
    return doc


def _prom_escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_series(name: str, key: tuple, value) -> str:
    if not key:
        return f"{name} {value}"
    labels = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in key)
    return f"{name}{{{labels}}} {value}"


def _prom_bound(bound: float) -> str:
    """A bucket bound as Prometheus renders it: integral bounds without a
    trailing ``.0`` so ``le="1"`` not ``le="1.0"``."""
    return str(int(bound)) if float(bound).is_integer() else repr(bound)


def prometheus_text(registry: MetricsRegistry) -> str:
    """One scrape in the Prometheus text exposition format.  Histograms
    export natively — cumulative ``_bucket{le=...}`` samples over the
    global :data:`~repro_torch.telemetry.registry.BUCKET_BOUNDS` plus
    ``_sum``/``_count`` — with ``_min``/``_max`` kept as companion gauges
    (Prometheus histograms don't carry extrema).  A bucketless aggregate
    (reloaded from a v1 trace) falls back to the summary-style export."""
    lines: list[str] = []
    for name in sorted(registry._counters):
        lines.append(f"# TYPE {name} counter")
        for key, value in sorted(registry._counters[name].items()):
            lines.append(_prom_series(name, key, value))
    for name in sorted(registry._gauges):
        lines.append(f"# TYPE {name} gauge")
        for key, value in sorted(registry._gauges[name].items()):
            lines.append(_prom_series(name, key, value))
    for name in sorted(registry._hists):
        series = sorted(registry._hists[name].items())
        if all(agg.get("buckets") for _, agg in series):
            lines.append(f"# TYPE {name} histogram")
            for key, agg in series:
                cum = 0
                for i, bound in enumerate(BUCKET_BOUNDS):
                    cum += agg["buckets"][i]
                    lines.append(_prom_series(
                        f"{name}_bucket",
                        key + (("le", _prom_bound(bound)),), cum))
                lines.append(_prom_series(f"{name}_bucket",
                                          key + (("le", "+Inf"),),
                                          agg["count"]))
                lines.append(_prom_series(f"{name}_sum", key, agg["sum"]))
                lines.append(_prom_series(f"{name}_count", key,
                                          agg["count"]))
            extrema = ("min", "max")
        else:
            extrema = ("count", "sum", "min", "max")
        for suffix in extrema:
            lines.append(f"# TYPE {name}_{suffix} gauge")
            for key, agg in series:
                lines.append(_prom_series(f"{name}_{suffix}", key,
                                          agg[suffix]))
    return "\n".join(lines) + "\n"


def write_metrics(path: str, registry: MetricsRegistry,
                  tracer=None) -> None:
    """Write the metrics artifact ``--metrics-out`` asks for: Prometheus
    text when the path ends in ``.prom``, else the JSON snapshot."""
    if path.endswith(".prom"):
        with open(path, "w") as f:
            f.write(prometheus_text(registry))
        return
    with open(path, "w") as f:
        json.dump(snapshot(registry, tracer), f, indent=2, sort_keys=True)
        f.write("\n")
