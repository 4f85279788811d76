"""The metrics registry: one sink for every counter the port keeps.

Counterpart of ``repro/telemetry/registry.py`` (a copy; the reference
module is pure Python).  Labeled counters, gauges and histograms with
deterministic ordering and exact integer arithmetic for bit tallies, and
a loss-free event form (:meth:`MetricsRegistry.to_events`,
:meth:`MetricsRegistry.from_events`) in the reference's shapes, so that
traces of either package reload in the other.  The registry is written
from host code that reads values already computed (ledger bookings, the
compiled backend's replays, settle hooks, live taps); it adds no device
work and nothing of the protocol reads it.

Names: ``*_total`` counters, units in the name (``*_bits``,
``*_seconds``), labels for the dimension that varies (tenant, event,
outcome, rung, agent).
"""
from __future__ import annotations

import bisect
import math

#: Fixed exponential histogram bucket bounds (powers of two, ~1 µs to
#: 32 s, plus a +Inf overflow bucket), global so that every histogram
#: buckets identically.
BUCKET_BOUNDS: tuple = tuple(2.0 ** e for e in range(-20, 6))
NUM_BUCKETS = len(BUCKET_BOUNDS) + 1          # trailing +Inf bucket


def bucket_index(value: float) -> int:
    """The bucket a value lands in: the smallest i with value <=
    BUCKET_BOUNDS[i] (Prometheus ``le``), NUM_BUCKETS - 1 for overflow."""
    return bisect.bisect_left(BUCKET_BOUNDS, value)


def quantile_estimate(agg: dict, q: float) -> float | None:
    """The q-quantile of one histogram aggregate from its bucket counts:
    the bucket that holds the target rank, interpolated linearly inside
    it and clamped to the observed [min, max].  None when empty."""
    count = agg.get("count", 0)
    buckets = agg.get("buckets")
    if not count or not buckets:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    rank = max(1, math.ceil(q * count))
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= rank:
            lo = BUCKET_BOUNDS[i - 1] if i > 0 else agg["min"]
            hi = (BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS)
                  else agg["max"])
            est = lo + (hi - lo) * (rank - (cum - c)) / c
            return min(max(est, agg["min"]), agg["max"])
    return agg["max"]


def _label_key(labels: dict) -> tuple:
    """Sorted (name, value) pairs, values as strings."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Labeled counters, gauges and histogram aggregates.  A series is
    (metric name, label set); counters accumulate, gauges hold the last
    value, histograms keep {count, sum, min, max} and the fixed bucket
    counts :meth:`quantile` estimates from (within one bucket)."""

    def __init__(self) -> None:
        self._counters: dict[str, dict[tuple, int | float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        self._hists: dict[str, dict[tuple, dict]] = {}

    # -------------------------------------------------------------- writes
    def inc(self, name: str, value: int | float = 1, /, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {name!r} increments must be >= 0, "
                             f"got {value}")
        series = self._counters.setdefault(name, {})
        key = _label_key(labels)
        series[key] = series.get(key, 0) + value

    def set_gauge(self, name: str, value: float, /, **labels) -> None:
        self._gauges.setdefault(name, {})[_label_key(labels)] = value

    def observe(self, name: str, value: float, /, **labels) -> None:
        series = self._hists.setdefault(name, {})
        key = _label_key(labels)
        agg = series.get(key)
        if agg is None:
            counts = [0] * NUM_BUCKETS
            counts[bucket_index(value)] = 1
            series[key] = {"count": 1, "sum": value, "min": value,
                           "max": value, "buckets": counts}
            return
        agg["count"] += 1
        agg["sum"] += value
        agg["min"] = min(agg["min"], value)
        agg["max"] = max(agg["max"], value)
        if "buckets" in agg:             # absent on reloaded v1 aggregates
            agg["buckets"][bucket_index(value)] += 1

    # --------------------------------------------------------------- reads
    def value(self, name: str, /, **labels) -> int | float:
        """One exact counter series (0 when never incremented)."""
        return self._counters.get(name, {}).get(_label_key(labels), 0)

    def gauge(self, name: str, /, **labels) -> float | None:
        return self._gauges.get(name, {}).get(_label_key(labels))

    def histogram(self, name: str, /, **labels) -> dict | None:
        agg = self._hists.get(name, {}).get(_label_key(labels))
        return None if agg is None else _copy(agg)

    def quantile(self, name: str, q: float, /, **labels) -> float | None:
        """Estimated q-quantile of one exact histogram series."""
        agg = self._hists.get(name, {}).get(_label_key(labels))
        return None if agg is None else quantile_estimate(agg, q)

    def merged_histogram(self, name: str) -> dict | None:
        """One aggregate of every label set of ``name``."""
        series = self._hists.get(name)
        if not series:
            return None
        merged = None
        for agg in series.values():
            if merged is None:
                merged = {**agg, "buckets": list(agg.get("buckets")
                                                 or [0] * NUM_BUCKETS)}
                continue
            merged["count"] += agg["count"]
            merged["sum"] += agg["sum"]
            merged["min"] = min(merged["min"], agg["min"])
            merged["max"] = max(merged["max"], agg["max"])
            for i, c in enumerate(agg.get("buckets") or ()):
                merged["buckets"][i] += c
        return merged

    def quantile_all(self, name: str, q: float) -> float | None:
        """Estimated q-quantile across every label set of ``name``."""
        merged = self.merged_histogram(name)
        return None if merged is None else quantile_estimate(merged, q)

    def total(self, name: str) -> int | float:
        """A counter's total across its label sets."""
        return sum(self._counters.get(name, {}).values())

    def series(self, name: str) -> dict[tuple, int | float]:
        """{label-key tuple: value} of one counter, sorted."""
        return dict(sorted(self._counters.get(name, {}).items()))

    def label_values(self, name: str, label: str) -> list[str]:
        """The distinct values of one label across a counter's series."""
        return sorted({v for key in self._counters.get(name, {})
                       for k, v in key if k == label})

    def counter_names(self) -> list[str]:
        return sorted(self._counters)

    # -------------------------------------------------------------- events
    def to_events(self) -> list[dict]:
        """The registry as a deterministic list of JSON-able events."""
        events: list[dict] = []
        for kind, store in (("counter", self._counters),
                            ("gauge", self._gauges)):
            for name in sorted(store):
                for key, value in sorted(store[name].items()):
                    events.append({"type": kind, "name": name,
                                   "labels": dict(key), "value": value})
        for name in sorted(self._hists):
            for key, agg in sorted(self._hists[name].items()):
                events.append({"type": "histogram", "name": name,
                               "labels": dict(key), **_copy(agg)})
        return events

    @classmethod
    def from_events(cls, events: list[dict]) -> "MetricsRegistry":
        """A registry rebuilt from :meth:`to_events` output (a reloaded
        trace); a histogram without buckets (schema v1) stays without."""
        reg = cls()
        for e in events:
            kind = e.get("type")
            if kind == "counter":
                reg.inc(e["name"], e["value"], **e.get("labels", {}))
            elif kind == "gauge":
                reg.set_gauge(e["name"], e["value"], **e.get("labels", {}))
            elif kind == "histogram":
                agg = {f: e[f] for f in ("count", "sum", "min", "max")}
                if e.get("buckets") is not None:
                    agg["buckets"] = list(e["buckets"])
                reg._hists.setdefault(e["name"], {})[
                    _label_key(e.get("labels", {}))] = agg
        return reg


def _copy(agg: dict) -> dict:
    """A histogram aggregate with its own bucket list (when it has one)."""
    out = dict(agg)
    if "buckets" in out:
        out["buckets"] = list(out["buckets"])
    return out
