"""The port's telemetry (``repro_torch.telemetry``: the registry, spans,
exporters, the checker, the dashboard and the ``Telemetry`` bundle, with
its hooks in the engine, the compiled backend and both CLIs) against the
JAX package's, on the reference's blob fixture (n = 240), with the
reference's draws replayed (``ReplayDraws``,
tests/test_torch_comm_session.py).

Exact, across the packages: the registry's events, series, Prometheus text
and snapshot after the same calls; the counter series and gauges of the
same session (eager and compiled; fp32, and the budget + DP (+ adaptive
controller) channel of the reference's tests/test_telemetry.py), its fit
and its ``predict_distributed``; the span tree (names, parents, the
attributes that are not times) and the ``span_seconds`` count of each
name; a dashboard frame of equal registries.  Each package's checker
accepts the other's trace, snapshot and ``.prom``, and each package's
``load_registry`` reads the other's trace.  Within the port: telemetry on
== off bit for bit (w, ledger, releases, link spend, predictions), on
both backends.  No timing is compared.
"""
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import BudgetedTransport as JBudgeted
from repro.comm import BudgetSpec as JBudgetSpec
from repro.comm.privacy import GaussianMechanism as JMech
from repro.control.adaptive import AdaptiveController as JController
from repro.core import engine as J
from repro.core.transport import TransportLog as JLog
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.learners.logistic import LogisticRegression as JLogistic
from repro.telemetry import MetricsRegistry as JRegistry
from repro.telemetry import Telemetry as JTelemetry
from repro.telemetry import check as jcheck
from repro.telemetry import dash as jdash
from repro.telemetry import export as jexport
from repro_torch.comm import BudgetedTransport as TBudgeted
from repro_torch.comm import BudgetSpec as TBudgetSpec
from repro_torch.comm.privacy import GaussianMechanism as TMech
from repro_torch.control.adaptive import AdaptiveController as TController
from repro_torch.core import engine as T
from repro_torch.core.transport import TransportLog as TLog
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from repro_torch.telemetry import MetricsRegistry, SpanTracer, Telemetry
from repro_torch.telemetry import check as tcheck
from repro_torch.telemetry import dash as tdash
from repro_torch.telemetry import export as texport
from repro_torch.telemetry.spans import fence_of, span_of, tensor_leaves
from test_torch_comm_session import ReplayDraws

CPU = "cpu"
KEY = 7
ROUNDS = 3
STEPS = 40
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def blob():
    ds = blob_fig3(jax.random.key(0), n=240)
    tr, te = train_test_split(0, 240)
    Xs = vertical_split(ds.X, ds.splits)
    return ([np.array(x[tr]) for x in Xs], np.array(ds.classes[tr]),
            [np.array(x[te]) for x in Xs], np.array(ds.classes[te]),
            ds.num_classes)


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


# name -> (reference transport, port transport): fp32, and the budget +
# DP (+ resid controller) channel of the reference's telemetry tests
CHANNELS = {
    "fp32": lambda: (J.MeteredTransport(), T.MeteredTransport()),
    "budget-dp": lambda: (
        JBudgeted(JBudgetSpec(session_bits=600_000), log=JLog(),
                  privacy=JMech(epsilon=1.0)),
        TBudgeted(TBudgetSpec(session_bits=600_000), log=TLog(),
                  privacy=TMech(epsilon=1.0))),
    "budget-dp-controller": lambda: (
        JBudgeted(JBudgetSpec(session_bits=600_000), log=JLog(),
                  privacy=JMech(epsilon=1.0),
                  controller=JController(stat="resid")),
        TBudgeted(TBudgetSpec(session_bits=600_000), log=TLog(),
                  privacy=TMech(epsilon=1.0),
                  controller=TController(stat="resid"))),
}


def reference_run(blob, backend, channel, telemetry):
    """The reference's fit and one predict_distributed; returns (protocol,
    predictions, the key its serve draws come from)."""
    Xtr, ctr, Xte, _, k = blob
    jt, _ = CHANNELS[channel]()
    proto = J.Protocol(J.SessionConfig(num_classes=k, max_rounds=ROUNDS),
                       transport=jt, backend=backend, telemetry=telemetry)
    proto.fit(jax.random.key(KEY),
              J.endpoints_for([JLogistic(steps=STEPS) for _ in Xtr],
                              _j(Xtr)), jnp.asarray(ctr))
    final_key = (proto._session.state.key if backend == "eager"
                 else proto._evolved_key(proto._compiled_ctx[2]))
    preds = np.asarray(proto.predict_distributed(_j(Xte)))
    return proto, preds, final_key


def port_run(blob, backend, channel, telemetry, final_key):
    """The port's fit with the reference's draws, and one
    predict_distributed; returns (protocol, predictions)."""
    Xtr, ctr, Xte, _, k = blob
    _, tt = CHANNELS[channel]()
    source = ReplayDraws(jax.random.key(KEY), len(Xtr))
    proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=ROUNDS),
                       transport=tt, backend=backend, telemetry=telemetry,
                       device=CPU, draws=source)
    proto.fit(KEY, T.endpoints_for([TLogistic(steps=STEPS, device=CPU)
                                    for _ in Xtr], _t(Xtr)),
              torch.from_numpy(ctr))
    source.final_key = final_key
    return proto, proto.predict_distributed(_t(Xte)).numpy()


@pytest.fixture(scope="module")
def runs(blob):
    """(backend, channel) -> the reference's and the port's runs with
    telemetry, and the port's without, computed once."""
    cache = {}

    def get(backend, channel):
        if (backend, channel) not in cache:
            jtele, ttele = JTelemetry(), Telemetry()
            jproto, jpreds, final_key = reference_run(blob, backend, channel,
                                                      jtele)
            tproto, tpreds = port_run(blob, backend, channel, ttele,
                                      final_key)
            dark, dpreds = port_run(blob, backend, channel, None, final_key)
            cache[backend, channel] = dict(
                jtele=jtele, jproto=jproto, jpreds=jpreds, ttele=ttele,
                tproto=tproto, tpreds=tpreds, dark=dark, dpreds=dpreds)
        return cache[backend, channel]
    return get


def counters(reg) -> dict:
    return {name: reg.series(name) for name in reg.counter_names()}


def span_tree(tracer) -> list:
    """(name, parent's name, attributes) of every span, in open order."""
    by_id = {s.span_id: s for s in tracer.spans}
    return [(s.name, None if s.parent_id is None
             else by_id[s.parent_id].name, s.attrs) for s in tracer.spans]


def span_counts(reg) -> dict:
    return {dict(key)["name"]: agg["count"]
            for key, agg in reg._hists.get("span_seconds", {}).items()}


def _final_w(proto):
    if proto._compiled_result is not None:
        return proto._compiled_result.w
    return proto._session.state.w


# ============================================================== registry
def _feed(reg) -> None:
    """One sequence of writes, every kind and the label forms the
    registry meets (a label called "name", ints, a quote)."""
    reg.inc("wire_bits_total", 64, src="a0", dst='a"1', kind="ignorance")
    reg.inc("wire_bits_total", 32, kind="ignorance", dst='a"1', src="a0")
    reg.inc("messages_total", 1, kind="labels")
    reg.inc("hops_by_rung_total", 2, rung=3)
    reg.inc("scheduler_rounds_total", 1, changed=True)
    reg.set_gauge("budget_exhausted", 0)
    reg.set_gauge("budget_link_spent_bits", 128, src="a0", dst="a1")
    reg.set_gauge("budget_link_spent_bits", 96, src="a0", dst="a1")
    for v in (2e-6, 0.003, 0.25, 1.0, 40.0):
        reg.observe("span_seconds", v, name="hop")
    reg.observe("request_seconds", 0.01, tenant="t0")


def test_registry_matches_reference():
    ours, ref = MetricsRegistry(), JRegistry()
    _feed(ours)
    _feed(ref)
    assert ours.to_events() == ref.to_events()
    assert ours.counter_names() == ref.counter_names()
    for name in ref.counter_names():
        assert ours.series(name) == ref.series(name)
    assert texport.prometheus_text(ours) == jexport.prometheus_text(ref)
    assert texport.snapshot(ours) == jexport.snapshot(ref)
    for q in (0.5, 0.99):
        assert ours.quantile("span_seconds", q, name="hop") == \
            ref.quantile("span_seconds", q, name="hop")
    # from_events across the packages, both ways
    assert MetricsRegistry.from_events(ref.to_events()).to_events() == \
        ref.to_events()
    assert JRegistry.from_events(ours.to_events()).to_events() == \
        ours.to_events()


def test_registry_reloads_v1_histograms_as_reference():
    """A v1 trace's histogram carries no buckets: it reloads without them,
    takes observations, exports summary-style Prometheus, as the
    reference does."""
    ours, ref = MetricsRegistry(), JRegistry()
    _feed(ours)
    events = [{k: v for k, v in e.items() if k != "buckets"}
              for e in ours.to_events()]
    ours, ref = (MetricsRegistry.from_events(events),
                 JRegistry.from_events(events))
    ours.observe("span_seconds", 0.5, name="hop")
    ref.observe("span_seconds", 0.5, name="hop")
    assert ours.to_events() == ref.to_events()
    assert ours.histogram("span_seconds", name="hop") == \
        ref.histogram("span_seconds", name="hop")
    assert ours.merged_histogram("span_seconds") == \
        ref.merged_histogram("span_seconds")
    assert texport.prometheus_text(ours) == jexport.prometheus_text(ref)
    assert tcheck.validate_prometheus(texport.prometheus_text(ours)) == []


@pytest.mark.parametrize("bad", [-1, -0.5])
def test_negative_increment_rejected(bad):
    with pytest.raises(ValueError):
        MetricsRegistry().inc("x_total", bad)


# ================================================================= spans
def test_span_tree_and_histograms():
    tr = SpanTracer(MetricsRegistry())
    with tr.span("session"):
        with tr.span("round", step=0):
            with tr.span("hop", src="a", dst="b"):
                pass
        with tr.span("round", step=1):
            pass
    assert tr.well_formed()
    assert span_tree(tr) == [("session", None, {}),
                             ("round", "session", {"step": 0}),
                             ("hop", "round", {"src": "a", "dst": "b"}),
                             ("round", "session", {"step": 1})]
    assert all(s.end_s >= s.start_s for s in tr.spans)
    assert span_counts(tr.registry) == {"session": 1, "round": 2, "hop": 1}
    cm = tr.span("dangling")
    cm.__enter__()
    assert not tr.well_formed()
    cm.__exit__(None, None, None)
    assert tr.well_formed()


def test_fence_passes_values_through():
    tr = SpanTracer()
    x = torch.arange(3)
    assert tr.fence(x) is x
    assert tr.fence(None) is None
    tree = {"a": (x, [x]), "b": None}
    assert tr.fence(tree) is tree
    assert list(tensor_leaves(tree)) == [x, x]


def test_span_and_fence_helpers_without_telemetry_are_no_ops():
    x = torch.arange(3)
    assert fence_of(None, x) is x
    with span_of(None, "session", step=1) as sp:
        assert sp is None
    tr = SpanTracer()
    with span_of(tr, "round", step=2, agents=3) as sp:
        assert fence_of(tr, x) is x
    assert (sp.name, sp.attrs) == ("round", {"agents": 3, "step": 2})
    assert tr.well_formed()


def test_profile_spans_are_profiler_ranges():
    tr = SpanTracer(profile=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("session"):
            with tr.span("round", step=4):
                torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert {"session", "round#4"} <= names


# ============================================= sessions against the reference
CASES = [(b, c) for b in ("eager", "compiled") for c in sorted(CHANNELS)]


@pytest.mark.parametrize("backend,channel", CASES)
def test_session_counters_match_reference(runs, backend, channel):
    """The fit's and the serve's counter series, the gauges and the span
    counts of the port equal the reference's for the same session."""
    r = runs(backend, channel)
    assert r["tproto"].transport.log.entries == \
        r["jproto"].transport.log.entries
    np.testing.assert_array_equal(r["tpreds"], r["jpreds"])
    jreg, treg = r["jtele"].registry, r["ttele"].registry
    assert counters(treg) == counters(jreg)
    assert treg.value("messages_total", kind="score_block") > 0
    if channel != "fp32":
        assert treg.total("dp_releases_total") > 0
        assert treg.total("hops_by_rung_total") > 0
    r["jtele"].sync_gauges(r["jproto"].transport)
    r["ttele"].sync_gauges(r["tproto"].transport)
    assert treg._gauges == jreg._gauges
    assert span_counts(treg) == span_counts(jreg)


@pytest.mark.parametrize("backend,channel", CASES)
def test_span_tree_matches_reference(runs, backend, channel):
    r = runs(backend, channel)
    tt, jt = r["ttele"].tracer, r["jtele"].tracer
    assert tt.well_formed() and jt.well_formed()
    assert span_tree(tt) == span_tree(jt)
    names = {s.name for s in tt.spans}
    if backend == "eager":
        assert names == {"session", "round", "hop", "serve"}
    else:
        assert names == {"session", "replay", "serve"}


@pytest.mark.parametrize("backend,channel", CASES)
def test_telemetry_on_equals_off(runs, backend, channel):
    """w, the ledger, the DP releases, the link spend and the predictions
    with telemetry are those without, bit for bit."""
    r = runs(backend, channel)
    on, off = r["tproto"], r["dark"]
    assert torch.equal(_final_w(on), _final_w(off))
    assert on.transport.log.entries == off.transport.log.entries
    np.testing.assert_array_equal(r["tpreds"], r["dpreds"])
    if on.transport.accountant is not None:
        assert on.transport.accountant.releases == \
            off.transport.accountant.releases
    assert getattr(on.transport, "link_spent", None) == \
        getattr(off.transport, "link_spent", None)
    reg = r["ttele"].registry
    assert reg.total("wire_bits_total") == on.transport.log.total_bits
    assert reg.total("messages_total") == len(on.transport.log.entries)


def test_eager_registry_equals_compiled_registry(runs):
    regs = [counters(runs(b, "budget-dp")["ttele"].registry)
            for b in ("eager", "compiled")]
    assert regs[0] == regs[1]


def test_attach_transport_backfills_and_is_idempotent(runs):
    """A registry attached after the traffic counts what was booked before
    it, once."""
    r = runs("compiled", "budget-dp")
    late = Telemetry()
    late.attach_transport(r["dark"].transport)
    late.attach_transport(r["dark"].transport)
    assert counters(late.registry) == counters(r["ttele"].registry)


# ===================================================== exporters and checkers
@pytest.fixture(scope="module")
def artifacts(runs, tmp_path_factory):
    """Each package's trace, JSON snapshot and .prom of the same compiled
    budget + DP session."""
    out = {}
    for pkg in ("port", "reference"):
        r = runs("compiled", "budget-dp")
        tele, proto = ((r["ttele"], r["tproto"]) if pkg == "port"
                       else (r["jtele"], r["jproto"]))
        d = tmp_path_factory.mktemp(pkg)
        paths = {s: str(d / f"run{s}") for s in (".jsonl", ".json", ".prom")}
        tele.write_artifacts(trace=paths[".jsonl"],
                             metrics_out=paths[".json"],
                             transport=proto.transport)
        tele.write_artifacts(metrics_out=paths[".prom"])
        out[pkg] = (tele, paths)
    return out


@pytest.mark.parametrize("suffix", [".jsonl", ".json", ".prom"])
@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_both_checkers_accept_both_packages(artifacts, pkg, suffix):
    path = artifacts[pkg][1][suffix]
    assert tcheck.validate_file(path) == []
    assert jcheck.validate_file(path) == []


def test_artifacts_equal_across_packages(artifacts):
    """The snapshots and .prom files (no times in either) are equal."""
    (_, ours), (_, ref) = artifacts["port"], artifacts["reference"]
    snap = [json.load(open(p[".json"])) for p in (ours, ref)]
    for doc in snap:
        del doc["histograms"]["span_seconds"]
    assert snap[0] == snap[1]
    prom = [[ln for ln in open(p[".prom"]) if "span_seconds" not in ln]
            for p in (ours, ref)]
    assert prom[0] == prom[1]


@pytest.mark.parametrize("reader", ["port", "reference"])
def test_load_registry_round_trips_across_packages(artifacts, reader):
    """Each package reloads the other's trace: counters and gauges equal
    the writer's registry, every histogram its count."""
    load = texport.load_registry if reader == "port" else \
        jexport.load_registry
    writer = "reference" if reader == "port" else "port"
    tele, paths = artifacts[writer]
    got = load(paths[".jsonl"])
    want = tele.registry
    assert counters(got) == counters(want)
    assert got._gauges == want._gauges
    assert span_counts(got) == span_counts(want)


def test_check_cli_exit_codes(tmp_path):
    good = tmp_path / "ok.jsonl"
    reg = MetricsRegistry()
    reg.inc("x_total", 1)
    texport.write_trace(str(good), registry=reg,
                        tracer=SpanTracer(reg))
    assert tcheck.main([str(good)]) == 0
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "metric"}\n')
    assert tcheck.main([str(bad)]) == 1
    assert tcheck.main([]) == 2
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.check",
                           str(good), str(bad)], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 1
    assert "OK" in proc.stdout and "unknown type" in proc.stderr


# ---------------------------------------------------------- streaming trace
def test_streaming_trace_spans_land_before_seal(tmp_path):
    tele = Telemetry()
    path = tmp_path / "stream.jsonl"
    tele.stream_trace(str(path))
    with tele.span("session"):
        with tele.span("round", step=0):
            pass
    tele.registry.inc("x_total", 3)
    pre = texport.load_events(str(path))
    assert [e["type"] for e in pre] == ["meta", "span", "span"]
    assert [e["name"] for e in pre[1:]] == ["round", "session"]
    tele.write_artifacts(trace=str(path))
    assert tcheck.validate_file(str(path)) == []
    assert jcheck.validate_file(str(path)) == []
    assert texport.load_registry(str(path)).to_events() == \
        tele.registry.to_events()


@pytest.mark.parametrize("checker", [tcheck, jcheck],
                         ids=["port", "reference"])
def test_streaming_trace_killed_prefix(tmp_path, checker):
    """A killed stream (the open session span never landed, the last line
    torn) is refused strictly and accepted with allow_partial."""
    tele = Telemetry()
    path = tmp_path / "killed.jsonl"
    tele.stream_trace(str(path))
    with tele.span("session"):
        with tele.span("round", step=0):
            pass
    lines = path.read_text().splitlines()
    path.write_text("\n".join(lines[:-1]) + '\n{"type": "span", "id"')
    assert any("unparseable" in e for e in checker.validate_file(str(path)))
    assert checker.validate_file(str(path), allow_partial=True) == []
    assert checker.main(["--allow-partial", str(path)]) == 0
    events = texport.load_events(str(path), allow_partial=True)
    assert any("dangling" in e for e in checker.validate_events(events))


@pytest.mark.parametrize("checker", [tcheck, jcheck],
                         ids=["port", "reference"])
def test_streaming_trace_empty_prefix(tmp_path, checker):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert checker.validate_file(str(empty), allow_partial=True) == []
    assert checker.validate_file(str(empty)) == ["empty trace: no events"]


def test_prometheus_text_shape():
    reg = MetricsRegistry()
    reg.inc("wire_bits_total", 64, src="a0", dst='a"1')
    reg.set_gauge("budget_exhausted", 0)
    reg.observe("span_seconds", 0.25, name="hop")
    text = texport.prometheus_text(reg)
    assert '# TYPE wire_bits_total counter' in text
    assert 'wire_bits_total{dst="a\\"1",src="a0"} 64' in text
    assert 'span_seconds_bucket{name="hop",le="0.25"} 1' in text
    assert tcheck.validate_prometheus(text) == []


# ================================================================ dashboard
def _dash_registry() -> MetricsRegistry:
    reg = MetricsRegistry()
    _feed(reg)
    for kind, v in (("ignorance", 12), ("score_block", 3)):
        reg.inc("live_messages_total", v, kind=kind)
    reg.inc("live_wire_bits_total", 123_456)
    reg.inc("live_rounds_total", 4)
    reg.set_gauge("live_round", 3)
    reg.inc("live_serve_requests_total", 3)
    reg.inc("live_budget_skips_total", 2)
    reg.inc("live_exhausted_total", 1)
    for t, v in (("t0", 0.002), ("t1", 0.4), ("t1", 0.05)):
        reg.observe("request_seconds", v, tenant=t)
    reg.set_gauge("slo_burn", 0.5, tenant="t0")
    reg.set_gauge("slo_burn", 2.0, tenant="t1")
    for tenant, outcome in (("t0", "served"), ("t1", "degraded"),
                            ("t1", "served")):
        reg.inc("admission_outcomes_total", 1, tenant=tenant,
                outcome=outcome)
    reg.inc("cache_events_total", 2, event="hit")
    reg.inc("batch_events_total", 1, event="batch")
    return reg


@pytest.mark.parametrize("source", ["synthetic", "session"])
def test_dashboard_render_matches_reference(runs, source):
    reg = (_dash_registry() if source == "synthetic"
           else runs("compiled", "budget-dp")["ttele"].registry)
    ref = JRegistry.from_events(reg.to_events())
    frame = tdash.render(reg, title="unit")
    assert frame == jdash.render(ref, title="unit")
    assert "wire" in frame


def test_dashboard_main_renders_a_trace(tmp_path, capsys):
    tele = Telemetry()
    tele.registry.inc("live_rounds_total", 1)
    tele.registry.inc("live_wire_bits_total", 2048)
    path = tmp_path / "t.jsonl"
    tele.write_artifacts(trace=str(path))
    assert tdash.main([str(path)]) == 0
    assert "2.0 kb (live)" in capsys.readouterr().out
    assert tdash.main([]) == 2


def test_dashboard_draws_in_place():
    stream = io.StringIO()
    dash = tdash.Dashboard(_dash_registry(), title="t", min_interval=0.0,
                           stream=stream)
    dash.final()
    assert stream.getvalue().startswith("\x1b[H\x1b[J== t ==")
    assert dash.frames == 1


# ===================================================================== CLIs
CLI_CASES = {
    "session-eager": ["--codec", "int8"],
    "session-compiled": ["--learner", "logistic", "--steps", "10",
                         "--backend", "compiled", "--byte-budget", "6000",
                         "--dp-epsilon", "1"],
    "session-fedavg": ["--protocol", "fedavg", "--learner", "logistic",
                       "--steps", "10", "--backend", "compiled",
                       "--scenario", "churn"],
    "serve-fleet": ["--sessions", "2", "--requests", "6", "--n", "160",
                    "--steps", "10", "--serve-codec", "int8"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
@pytest.mark.parametrize("metrics", [".json", ".prom"])
def test_cli_artifacts_pass_both_checkers(tmp_path, case, metrics):
    from repro_torch.launch import serve_fleet
    from repro_torch.launch import session as cli
    trace, out = tmp_path / "run.jsonl", tmp_path / f"run{metrics}"
    argv = ["--device", CPU, *CLI_CASES[case], "--trace", str(trace),
            "--metrics-out", str(out)]
    if case == "serve-fleet":
        serve_fleet.main(argv)
    else:
        cli.run(cli.parser().parse_args(["--rounds", "3", *argv]))
    for path in (trace, out):
        assert tcheck.validate_file(str(path)) == []
        assert jcheck.validate_file(str(path)) == []
    names = {e["name"] for e in texport.load_events(str(trace))
             if e["type"] == "span"}
    assert names >= ({"flush", "flush_wave", "bucket_dispatch"}
                     if case == "serve-fleet" else {"session"})


def test_session_cli_profile_dir_has_span_ranges(tmp_path, capsys):
    from repro_torch.launch import session as cli
    prof = tmp_path / "prof"
    run = cli.run(cli.parser().parse_args(
        ["--device", CPU, "--rounds", "2", "--profile-dir", str(prof)]))
    assert run.telemetry is not None and run.telemetry.tracer.profile
    trace = json.load(open(prof / "session.pt.trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"session", "round#0", "round#1", "hop", "serve"} <= names
    assert f"profile: wrote {prof}" in capsys.readouterr().out


def test_session_cli_lines_unchanged_by_telemetry(tmp_path, capsys):
    """The CLI's printed lines with telemetry are those without it."""
    from repro_torch.launch import session as cli
    base = ["--device", CPU, "--rounds", "3", "--codec", "int4",
            "--dp-epsilon", "2"]
    cli.run(cli.parser().parse_args(base))
    dark = capsys.readouterr().out
    cli.run(cli.parser().parse_args(
        [*base, "--watch", "--trace", str(tmp_path / "t.jsonl")]))
    lit = capsys.readouterr().out
    assert [ln for ln in lit.splitlines()
            if not ln.startswith("telemetry:")] == dark.splitlines()
