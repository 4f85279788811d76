"""Schema validation for telemetry artifacts.

Counterpart of ``repro/telemetry/check.py``, with its exit codes.
``python -m repro_torch.telemetry.check [--allow-partial] FILE [FILE ...]``
validates each file by its suffix and exits 1 when one fails, 2 without
a file, 0 when all pass (``--allow-partial`` accepts the prefix a killed
streaming trace writer leaves; ``.jsonl`` only):

  * ``.jsonl`` — a JSONL trace: a leading meta line with the schema and
    an accepted version, every event one of meta/span/counter/gauge/
    histogram/live with its fields, every span closed with a known
    parent, histogram buckets (v2) that sum to their count, live events
    only under v2;
  * ``.json`` — a metrics snapshot: schema and version, the counters/
    gauges/histograms maps with numeric leaves;
  * ``.prom`` — Prometheus text: every sample line ``name{labels}
    value`` (or ``name value``) with a numeric value, after a ``# TYPE``
    line of its family.

The reference's checker accepts the port's files and this one the
reference's: the schema is the same.
"""
from __future__ import annotations

import json
import re
import sys

from repro_torch.telemetry.export import (ACCEPTED_VERSIONS, SCHEMA,
                                    SCHEMA_VERSION, load_events)
from repro_torch.telemetry.registry import NUM_BUCKETS

_METRIC_FIELDS = {
    "counter": ("name", "labels", "value"),
    "gauge": ("name", "labels", "value"),
    "histogram": ("name", "labels", "count", "sum", "min", "max"),
}
_SPAN_FIELDS = ("id", "parent", "name", "start_s", "end_s", "attrs")
#: In-flight progress events streamed by the live taps (schema v2+):
#: a tag naming the tap plus whatever scalars it carries.
_LIVE_FIELDS = ("tag",)
_PROM_LINE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(-?[0-9.eE+\-infa]+)$')


def validate_events(events: list[dict],
                    allow_partial: bool = False) -> list[str]:
    """Validate a JSONL trace's event list; return human-readable errors
    (empty list == valid).

    ``allow_partial`` accepts the truncated-but-well-formed *prefix* a
    killed :class:`~repro_torch.telemetry.export.StreamingTraceWriter` leaves
    behind: spans stream to disk in close order, so a prefix may reference
    a parent span that had not closed (and hence landed) yet, and a stream
    killed before any event flushed may be empty.  Every event that *is*
    present is still held to the full schema."""
    errors: list[str] = []
    if not events:
        return [] if allow_partial else ["empty trace: no events"]
    head = events[0]
    version = head.get("version")
    if head.get("type") != "meta":
        errors.append("first event must be type=meta")
    elif (head.get("schema") != SCHEMA or
          version not in ACCEPTED_VERSIONS):
        errors.append(f"meta schema/version mismatch: {head}")
    spans: dict = {}
    for i, e in enumerate(events):
        kind = e.get("type")
        if kind == "meta":
            if i != 0:
                errors.append(f"event {i}: meta only allowed first")
        elif kind == "span":
            missing = [f for f in _SPAN_FIELDS if f not in e]
            if missing:
                errors.append(f"event {i}: span missing {missing}")
                continue
            if e["end_s"] is None:
                errors.append(f"event {i}: span {e['name']!r} never closed")
            spans[e["id"]] = e
        elif kind in _METRIC_FIELDS:
            missing = [f for f in _METRIC_FIELDS[kind] if f not in e]
            if missing:
                errors.append(f"event {i}: {kind} missing {missing}")
            elif not isinstance(e["labels"], dict):
                errors.append(f"event {i}: labels must be an object")
            elif kind == "histogram":
                errors.extend(f"event {i}: {msg}"
                              for msg in _check_buckets(e))
        elif kind == "live":
            if version == 1:
                errors.append(f"event {i}: live events are schema v2+ "
                              f"but trace declares v1")
            missing = [f for f in _LIVE_FIELDS if f not in e]
            if missing:
                errors.append(f"event {i}: live missing {missing}")
        else:
            errors.append(f"event {i}: unknown type {kind!r}")
    if not allow_partial:
        for e in spans.values():
            if e["parent"] is not None and e["parent"] not in spans:
                errors.append(f"span {e['id']}: dangling parent "
                              f"{e['parent']}")
    return errors


def _check_buckets(agg: dict) -> list[str]:
    """Validate the optional bucket counts on one histogram aggregate —
    absent is fine (v1), present must be NUM_BUCKETS non-negative ints
    summing to the aggregate's count."""
    buckets = agg.get("buckets")
    if buckets is None:
        return []
    if (not isinstance(buckets, list) or len(buckets) != NUM_BUCKETS or
            not all(isinstance(c, int) and c >= 0 for c in buckets)):
        return [f"histogram {agg.get('name', '?')}: buckets must be "
                f"{NUM_BUCKETS} non-negative ints"]
    if sum(buckets) != agg.get("count"):
        return [f"histogram {agg.get('name', '?')}: bucket counts sum to "
                f"{sum(buckets)}, count says {agg.get('count')}"]
    return []


def validate_snapshot(doc: dict) -> list[str]:
    errors: list[str] = []
    if (doc.get("schema") != SCHEMA or
            doc.get("version") not in ACCEPTED_VERSIONS):
        errors.append(f"snapshot schema/version mismatch: "
                      f"{doc.get('schema')!r} v{doc.get('version')!r}")
    for section in ("counters", "gauges", "histograms"):
        block = doc.get(section)
        if not isinstance(block, dict):
            errors.append(f"missing/invalid section {section!r}")
            continue
        for name, series in block.items():
            if not isinstance(series, dict):
                errors.append(f"{section}.{name}: series must be an object")
                continue
            for key, value in series.items():
                if section == "histograms":
                    ok = (isinstance(value, dict) and
                          all(isinstance(value.get(f), (int, float))
                              for f in ("count", "sum", "min", "max")))
                    if ok and _check_buckets({**value, "name": name}):
                        ok = False
                else:
                    ok = isinstance(value, (int, float))
                if not ok:
                    errors.append(f"{section}.{name}[{key!r}]: bad value "
                                  f"{value!r}")
    return errors


def validate_prometheus(text: str) -> list[str]:
    errors: list[str] = []
    typed: set[str] = set()
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 3 and parts[1] == "TYPE":
                typed.add(parts[2])
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            errors.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name = m.group(1)
        if name not in typed:
            # Histogram families type the base name; their samples carry
            # the standard suffixes (plus our _min/_max companion gauges,
            # which get their own TYPE lines — checked here as a fallback
            # so a suffixed sample never needs a second family).
            base = next((name[:-len(s)] for s in
                         ("_bucket", "_sum", "_count", "_min", "_max")
                         if name.endswith(s)), None)
            if base is None or base not in typed:
                errors.append(f"line {lineno}: {name} sample before # TYPE")
        try:
            float(m.group(3))
        except ValueError:
            errors.append(f"line {lineno}: non-numeric value {m.group(3)!r}")
    return errors


def validate_file(path: str, allow_partial: bool = False) -> list[str]:
    if path.endswith(".jsonl"):
        try:
            events = load_events(path, allow_partial=allow_partial)
        except json.JSONDecodeError as e:
            # a torn line is a validation failure in strict mode (a
            # killed writer leaves one; --allow-partial tolerates it)
            return [f"unparseable line: {e}"]
        return validate_events(events, allow_partial=allow_partial)
    if path.endswith(".prom"):
        with open(path) as f:
            return validate_prometheus(f.read())
    with open(path) as f:
        return validate_snapshot(json.load(f))


def main(argv: list[str] | None = None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    allow_partial = "--allow-partial" in paths
    paths = [p for p in paths if p != "--allow-partial"]
    if not paths:
        print("usage: python -m repro_torch.telemetry.check [--allow-partial] "
              "FILE [FILE ...]", file=sys.stderr)
        return 2
    bad = 0
    for path in paths:
        errors = validate_file(path, allow_partial=allow_partial)
        if errors:
            bad += 1
            for err in errors:
                print(f"{path}: {err}", file=sys.stderr)
        else:
            print(f"{path}: OK")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
