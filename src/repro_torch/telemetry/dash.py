"""Live fleet dashboard: a refreshing terminal view of a running fleet.

Counterpart of ``repro/telemetry/dash.py``; a frame is the reference's
frame, text for text, for an equal registry.  One :class:`Dashboard`
reads everything from the shared :class:`~repro_torch.telemetry.registry.
MetricsRegistry` (the wire ledger, the live taps, the serve counters and
the SLO tracker all feed it), so a frame is a function of the registry
and the sink's tap rate:

  * progress   — live round, rounds seen, taps/s, serve taps
  * wire       — bits in flight, messages by kind, hops by codec rung
  * budget     — skips, exhaustion, per-link spent-bit gauges
  * latency    — per-tenant p50/p99 of ``request_seconds`` and the merged
    quantiles
  * SLO        — per-tenant error-budget burn
  * serve      — admission outcomes, cache and batch events

``--watch`` on the launch CLIs hooks it to a running program
(:meth:`Dashboard.attach`: the sink's ``on_event`` redraws, at most once
every ``min_interval``); ``python -m repro_torch.telemetry.dash run.jsonl``
renders one frame from a recorded trace, a killed run's prefix too.
Rendering reads the registry and never writes it.
"""
from __future__ import annotations

import sys
import time

from repro_torch.telemetry.registry import MetricsRegistry

#: codec-rung bar glyph budget (widest bar in the bits-by-rung block)
_BAR = 24


def _fmt_bits(bits: float) -> str:
    """Human wire-bit count: 12_345 -> '12.3 kb' (decimal, it's a rate
    ledger not a memory size)."""
    for unit, div in (("Gb", 1e9), ("Mb", 1e6), ("kb", 1e3)):
        if bits >= div:
            return f"{bits / div:.1f} {unit}"
    return f"{int(bits)} b"


def _fmt_s(seconds: float | None) -> str:
    if seconds is None:
        return "-"
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f} us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.1f} ms"
    return f"{seconds:.2f} s"


def _bar(value: float, peak: float) -> str:
    if peak <= 0:
        return ""
    return "#" * max(1, round(_BAR * value / peak)) if value else ""


def render(registry: MetricsRegistry, *, sink=None, title: str = "fleet",
           clock=None) -> str:
    """One dashboard frame as plain text (no ANSI — the watcher adds the
    cursor control).  ``sink`` contributes the tap rate; ``clock`` is the
    frame timestamp (None = unstamped, for deterministic render tests)."""
    reg = registry
    lines = [f"== {title} =="]
    if clock is not None:
        lines[0] += f"  t={clock:.1f}s"

    # ------------------------------------------------------------ progress
    rounds = reg.total("live_rounds_total")
    serve_taps = reg.value("live_serve_requests_total")
    if rounds or serve_taps:
        cur = reg.gauge("live_round")
        rate = sink.rate() if sink is not None else 0.0
        seg = [f"round {int(cur)}" if cur is not None else "round -",
               f"{int(rounds)} seen"]
        if rate > 0:
            seg.append(f"{rate:.1f} taps/s")
        if serve_taps:
            seg.append(f"{int(serve_taps)} serve reqs")
        lines.append("progress   " + "  |  ".join(seg))

    # ---------------------------------------------------------------- wire
    live_bits = reg.total("live_wire_bits_total")
    booked_bits = reg.total("wire_bits_total")
    bits = live_bits or booked_bits
    if bits:
        kinds = {dict(k).get("kind", "?"): v
                 for k, v in reg.series("messages_total").items()}
        live_kinds = {dict(k).get("kind", "?"): v
                      for k, v in reg.series("live_messages_total").items()}
        shown = live_kinds or kinds
        msgs = "  ".join(f"{k}={int(v)}" for k, v in sorted(shown.items()))
        src = "live" if live_bits else "booked"
        lines.append(f"wire       {_fmt_bits(bits)} ({src})  |  {msgs}")
    rungs = reg.series("hops_by_rung_total")
    if rungs:
        peak = max(rungs.values())
        for key, count in rungs.items():
            rung = dict(key).get("rung", "?")
            lines.append(f"  rung {rung:>2}  {int(count):6d} hops  "
                         f"{_bar(count, peak)}")

    # -------------------------------------------------------------- budget
    skips = reg.total("live_budget_skips_total") or \
        reg.total("budget_skips_total")
    exh_events = reg.value("live_exhausted_total")
    exh_gauge = reg.gauge("budget_exhausted")
    spent = reg._gauges.get("budget_link_spent_bits", {})
    if skips or exh_events or exh_gauge or spent:
        state = "EXHAUSTED" if (exh_events or exh_gauge) else "ok"
        lines.append(f"budget     {int(skips)} skips  |  {state}")
        for key, bits_spent in sorted(spent.items()):
            kl = dict(key)
            lines.append(f"  link {kl.get('src', '?')}->"
                         f"{kl.get('dst', '?')}  "
                         f"{_fmt_bits(bits_spent)} spent")

    # ------------------------------------------------------------- latency
    tenants = sorted(
        {dict(k).get("tenant") for k in reg._hists.get("request_seconds", {})}
        - {None})
    if tenants:
        p50 = reg.quantile_all("request_seconds", 0.5)
        p99 = reg.quantile_all("request_seconds", 0.99)
        lines.append(f"latency    all: p50 {_fmt_s(p50)}  "
                     f"p99 {_fmt_s(p99)}")
        for t in tenants:
            p50 = reg.quantile("request_seconds", 0.5, tenant=t)
            p99 = reg.quantile("request_seconds", 0.99, tenant=t)
            n = reg.histogram("request_seconds", tenant=t)["count"]
            row = (f"  {t:<12} p50 {_fmt_s(p50):>9}  "
                   f"p99 {_fmt_s(p99):>9}  n={int(n)}")
            burn = reg.gauge("slo_burn", tenant=t)
            if burn is not None:
                row += (f"  burn {burn:6.2f} "
                        f"{'OK' if burn < 1.0 else 'BLOWN'}")
            lines.append(row)

    # --------------------------------------------------------------- serve
    outcomes = reg.series("admission_outcomes_total")
    if outcomes:
        by_outcome: dict[str, int] = {}
        for key, v in outcomes.items():
            o = dict(key).get("outcome", "?")
            by_outcome[o] = by_outcome.get(o, 0) + int(v)
        lines.append("admission  " + "  ".join(
            f"{o}={v}" for o, v in sorted(by_outcome.items())))
    cache = {dict(k).get("event", "?"): int(v)
             for k, v in reg.series("cache_events_total").items()}
    batch = {dict(k).get("event", "?"): int(v)
             for k, v in reg.series("batch_events_total").items()}
    if cache or batch:
        seg = []
        if cache:
            seg.append("cache " + " ".join(
                f"{k}={v}" for k, v in sorted(cache.items())))
        if batch:
            seg.append("batch " + " ".join(
                f"{k}={v}" for k, v in sorted(batch.items())))
        lines.append("engine     " + "  |  ".join(seg))
    return "\n".join(lines)


class Dashboard:
    """Throttled terminal watcher over one registry + live sink.

    ``attach(sink)`` chains onto the sink's ``on_event`` hook (preserving
    any hook already installed); each accepted event redraws the frame
    in place (ANSI home+clear) at most once per ``min_interval`` seconds.
    ``final()`` force-renders the closing frame — the launch CLIs call it
    after the run so the last state stays on screen.
    """

    def __init__(self, registry: MetricsRegistry, *, title: str = "fleet",
                 min_interval: float = 0.25, stream=None) -> None:
        self.registry = registry
        self.title = title
        self.min_interval = min_interval
        self.stream = stream if stream is not None else sys.stderr
        self.sink = None
        self.frames = 0
        self._t0 = time.perf_counter()
        self._last_draw: float | None = None
        self._chained = None

    def attach(self, sink) -> "Dashboard":
        self.sink = sink
        self._chained = sink.on_event
        sink.on_event = self._on_event
        return self

    # ------------------------------------------------------------- drawing
    def _on_event(self, event: dict) -> None:
        if self._chained is not None:
            self._chained(event)
        now = time.perf_counter()
        if self._last_draw is not None and \
                now - self._last_draw < self.min_interval:
            return
        self.draw(now)

    def draw(self, now: float | None = None) -> None:
        now = time.perf_counter() if now is None else now
        self._last_draw = now
        self.frames += 1
        frame = render(self.registry, sink=self.sink, title=self.title,
                       clock=now - self._t0)
        # home + clear-below keeps the frame in place without flashing
        self.stream.write("\x1b[H\x1b[J" + frame + "\n")
        self.stream.flush()

    def final(self) -> None:
        """Force-render the closing frame (ignores the throttle)."""
        self.draw()


def main(argv: list[str] | None = None) -> int:
    """Render one dashboard frame from a recorded JSONL trace (accepts
    the truncated trace a killed run left behind) — the CI render smoke
    and the post-hoc view of any ``--trace`` artifact."""
    args = sys.argv[1:] if argv is None else argv
    if not args or len(args) != 1:
        print("usage: python -m repro_torch.telemetry.dash TRACE.jsonl",
              file=sys.stderr)
        return 2
    from repro_torch.telemetry.export import load_events
    events = load_events(args[0], allow_partial=True)
    registry = MetricsRegistry.from_events(
        [e for e in events if e.get("type") in
         ("counter", "gauge", "histogram")])
    live = [e for e in events if e.get("type") == "live"]
    # a killed run's trace has live events but no sealed registry block:
    # fold the live stream back into registry series so the frame still
    # shows progress (sums are commutative, same arithmetic as the sink)
    if live and not registry.counter_names():
        for e in live:
            if e.get("tag") == "round":
                registry.inc("live_rounds_total", 1)
                registry.inc("live_wire_bits_total", e.get("bits", 0))
                registry.inc("live_budget_skips_total", e.get("skipped", 0))
                registry.inc("live_exhausted_total", e.get("exhausted", 0))
                cur = registry.gauge("live_round")
                registry.set_gauge("live_round",
                                   max(e.get("t", 0),
                                       cur if cur is not None else -1))
            elif e.get("tag") == "serve":
                registry.inc("live_serve_requests_total", 1)
                registry.inc("live_wire_bits_total", e.get("bits", 0))
    frame = render(registry, title=args[0])
    print(frame)
    if live:
        span = live[-1].get("t_s", 0.0)
        print(f"-- {len(live)} live events over {span:.1f}s --")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
