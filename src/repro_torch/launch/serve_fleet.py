"""Serve-fleet driver: a multi-tenant prediction workload against the
port's continuous-batching serve engine (:mod:`repro_torch.serve`), on the
card by default.

Counterpart of ``repro/launch/serve_fleet.py``: fits ``--sessions``
compiled protocol sessions, registers them as servable, and replays a
random request stream (tenants round-robin, sessions and serve-time rows
drawn at random from ``--seed``) through ``ServeEngine.submit`` /
``flush``.  Prints the fit time, then the engine's summary (per-tenant
served / degraded / denied counters, cache and batcher stats, each
session's serve ledger) with the elapsed seconds, the requests a second
and the p50 / p99 of the requests' submit-to-settle seconds.

  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --sessions 6 \
      --tenants 3 --requests 40 --serve-codec int8 --cache-capacity 4
  PYTHONPATH=src python -m repro_torch.launch.serve_fleet \
      --serve-controller margin --dp-epsilon 1.0 --epsilon-cap 8 \
      --tenant-kb 4
  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --device cpu \
      --trace fleet.jsonl --metrics-out fleet.prom --watch   # telemetry

The data are drawn from a ``torch.Generator`` seeded with ``--seed``, so
the numbers differ from the reference CLI's.  ``--trace`` streams a
JSONL telemetry trace (the fits' session/replay spans, each flush's
flush/flush_wave/bucket_dispatch spans), ``--metrics-out`` writes the
fleet's registry, ``--watch`` draws the live dashboard on stderr from the
bucket programs' serve taps.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.comm import (BudgetSpec, BudgetedTransport,
                              GaussianMechanism, make_codec)
from repro_torch.control import ServeController
from repro_torch.control.adaptive import SERVE_STATS
from repro_torch.core.engine import (MeteredTransport, Protocol,
                                     SessionConfig, endpoints_for)
from repro_torch.data import synthetic
from repro_torch.data.partition import train_test_split, vertical_split
from repro_torch.device import resolve_device
from repro_torch.learners.logistic import LogisticRegression
from repro_torch.serve import AdmissionController, AdmissionPolicy, ServeEngine
from repro_torch.telemetry import Telemetry
from repro_torch.telemetry.slo import SLOConfig

DATASETS = {"blob3": synthetic.blob_fig3, "blob4": synthetic.blob_fig4,
            "blob6": synthetic.blob_fig6}


def fit_fleet(args, Xtr, ctr, num_classes, device, telemetry=None) -> dict:
    """Fit ``--sessions`` compiled protocols, session s from seed s (one
    plan for all), each observed by ``telemetry``."""
    protos = {}
    for s in range(args.sessions):
        privacy = (GaussianMechanism(epsilon=args.dp_epsilon)
                   if args.dp_epsilon > 0 else None)
        serve_controller = (ServeController(stat=args.serve_controller)
                            if args.serve_controller else None)
        if args.byte_budget > 0:
            transport = BudgetedTransport(
                BudgetSpec(session_bits=args.byte_budget * 8),
                privacy=privacy, serve_controller=serve_controller)
        else:
            transport = MeteredTransport(
                privacy=privacy, serve_controller=serve_controller,
                serve_codec=(make_codec(args.serve_codec)
                             if args.serve_codec else None))
        proto = Protocol(SessionConfig(num_classes=num_classes,
                                       max_rounds=args.rounds),
                         transport=transport, backend="compiled",
                         telemetry=telemetry, device=device)
        endpoints = endpoints_for(
            [LogisticRegression(steps=args.steps, device=device)
             for _ in Xtr], Xtr)
        proto.fit(s, endpoints, ctr)
        protos[f"s{s}"] = proto
    return protos


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="blob3", choices=sorted(DATASETS))
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--block-n", type=int, default=32,
                    help="serve-time rows per request (one bucket shape)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--cache-capacity", type=int, default=4,
                    help="resident sessions; the rest spill to checkpoints "
                         "and restore exactly on their next touch")
    ap.add_argument("--flush-every", type=int, default=8,
                    help="drain the batch queue after this many submits")
    ap.add_argument("--serve-codec", default="",
                    choices=["", "fp32", "fp16", "int8", "int4"])
    ap.add_argument("--serve-controller", default="",
                    choices=[""] + list(SERVE_STATS))
    ap.add_argument("--byte-budget", type=int, default=0,
                    help="per-session byte budget (serve blocks walk the "
                         "degradation ladder against it)")
    ap.add_argument("--dp-epsilon", type=float, default=0.0)
    ap.add_argument("--tenant-kb", type=int, default=0,
                    help="per-tenant serve byte cap in KB (0 = uncapped); "
                         "requests a tenant cannot afford degrade to "
                         "head-only (or are denied with --no-degrade)")
    ap.add_argument("--epsilon-cap", type=float, default=0.0,
                    help="per-tenant total DP epsilon cap (0 = no gate)")
    ap.add_argument("--no-degrade", action="store_true",
                    help="deny over-budget requests instead of degrading "
                         "them to head-only")
    ap.add_argument("--slo-ms", type=float, default=0.0,
                    help="per-tenant latency SLO threshold in ms (0 = no "
                         "SLO tracking); admission denials count as "
                         "violations")
    ap.add_argument("--slo-objective", type=float, default=0.99,
                    help="fraction of a tenant's requests that must land "
                         "under --slo-ms")
    ap.add_argument("--watch", action="store_true",
                    help="draw the live fleet dashboard on stderr while the "
                         "workload runs: the serve taps, tenant p50/p99, "
                         "SLO burn, admission and cache counters")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="",
                    help="stream a JSONL telemetry trace here (the fits' "
                         "and the flushes' spans, live events with "
                         "--watch), sealed with the final metrics")
    ap.add_argument("--metrics-out", default="",
                    help="write the fleet's metrics registry here (.prom: "
                         "Prometheus text, else a JSON snapshot)")
    ap.add_argument("--device", default="cuda",
                    help="where the sessions run (cuda, or cpu)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    if args.serve_controller and args.serve_codec:
        ap.error("--serve-controller drives serve codec choice through "
                 "its ladder; drop --serve-codec")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    ds = DATASETS[args.dataset](gen, n=args.n, device=device)
    tr, te = train_test_split(args.seed, ds.X.shape[0])
    tr, te = (torch.as_tensor(tr, device=device),
              torch.as_tensor(te, device=device))
    Xs = vertical_split(ds.X, ds.splits)
    Xtr, Xte = [x[tr] for x in Xs], [x[te] for x in Xs]
    ctr = ds.classes[tr]

    telemetry = (Telemetry(live=args.watch)
                 if args.trace or args.metrics_out or args.watch else None)
    if args.trace:
        telemetry.stream_trace(args.trace)
    dash = None
    if args.watch:
        from repro_torch.telemetry.dash import Dashboard
        dash = Dashboard(telemetry.registry,
                         title="serve fleet").attach(telemetry.live)
    t0 = time.time()
    protos = fit_fleet(args, Xtr, ctr, ds.num_classes, device, telemetry)
    print(f"fitted {args.sessions} sessions in {time.time() - t0:.2f}s")

    mechanism = (GaussianMechanism(epsilon=args.dp_epsilon)
                 if args.dp_epsilon > 0 else None)
    slo = (SLOConfig(threshold_s=args.slo_ms / 1e3,
                     objective=args.slo_objective)
           if args.slo_ms > 0 else None)
    engine = ServeEngine(
        cache_capacity=args.cache_capacity, max_batch=args.max_batch,
        admission=AdmissionController(
            AdmissionPolicy(allow_degrade=not args.no_degrade,
                            epsilon_cap=args.epsilon_cap or None),
            tenant_bits=args.tenant_kb * 8 * 1024 or None,
            mechanism=mechanism),
        telemetry=telemetry, slo=slo, device=device)
    for sid, proto in protos.items():
        engine.add_session(sid, proto)

    rng = np.random.default_rng(args.seed)
    n_te = int(Xte[0].shape[0])
    t0 = time.time()
    for i in range(args.requests):
        tenant = f"t{i % args.tenants}"
        sid = f"s{rng.integers(args.sessions)}"
        rows = torch.as_tensor(rng.choice(n_te, size=min(args.block_n, n_te),
                                          replace=False), device=device)
        engine.submit(tenant, sid, [x[rows] for x in Xte])
        if (i + 1) % args.flush_every == 0:
            engine.flush()
    engine.flush()
    dt = time.time() - t0

    summary = engine.summary()
    summary["elapsed_s"] = round(dt, 4)
    summary["qps"] = round(args.requests / max(dt, 1e-9), 2)
    summary["request_seconds"] = {
        q: engine.registry.quantile_all("request_seconds", p)
        for q, p in (("p50", 0.5), ("p99", 0.99))}
    if dash is not None:
        dash.final()
    print(json.dumps(summary, indent=2))
    if telemetry is not None:
        # fleet-wide: the link gauges are a transport's, so no gauge sync
        telemetry.write_artifacts(trace=args.trace or None,
                                  metrics_out=args.metrics_out or None)
        for path in (args.trace, args.metrics_out):
            if path:
                print(f"telemetry: wrote {path}")
    engine.close()
    return summary


if __name__ == "__main__":
    main()
