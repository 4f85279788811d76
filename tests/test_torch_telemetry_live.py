"""The port's live plane (``repro_torch.telemetry.live``: the round and
serve taps of compiled programs, the eager taps, the ``LiveSink``), the
dashboard and the streamed trace, against the JAX package's, on the
reference's blob fixture (n = 240), with the reference's draws replayed
(``ReplayDraws``, tests/test_torch_comm_session.py).

The contract of the reference's tests/test_telemetry_live.py, on the port:

  * live on == live off bit for bit (predictions, ledger, releases), on
    both backends, under a loose and a tight budget;
  * at exit the ``live_*`` series equal the replay-booked ones;
  * the eager and the compiled backends stream the same live series, and
    so does the reference (its ``live_*`` series equal the port's);
  * a fleet streams one tap a (session, round), a round's taps as one
    copy, and its sums equal the single sessions' sums;
  * the serve engine taps each request (its counters equal the
    reference's on the same stream); a bucket's pad slots are dropped;
  * a killed run's streamed trace validates with ``allow_partial`` and
    renders a dashboard frame; live events need schema v2.
"""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import BudgetedTransport as JBudgeted
from repro.comm import BudgetSpec as JBudgetSpec
from repro.comm.privacy import GaussianMechanism as JMech
from repro.core import engine as J
from repro.core.transport import TransportLog as JLog
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.learners.logistic import LogisticRegression as JLogistic
from repro.serve import ServeEngine as JServeEngine
from repro.telemetry import Telemetry as JTelemetry
from repro.telemetry import check as jcheck
from repro.telemetry.registry import MetricsRegistry as JRegistry
from repro.telemetry.slo import SLOConfig as JSLOConfig
from repro_torch.comm import BudgetedTransport as TBudgeted
from repro_torch.comm import BudgetSpec as TBudgetSpec
from repro_torch.comm.codecs import QuantCodec
from repro_torch.comm.privacy import GaussianMechanism as TMech
from repro_torch.core import compiled as TC
from repro_torch.core import engine as T
from repro_torch.core.transport import TransportLog as TLog
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from repro_torch.serve import ServeEngine
from repro_torch.telemetry import MetricsRegistry, Telemetry
from repro_torch.telemetry import check as tcheck
from repro_torch.telemetry import dash as tdash
from repro_torch.telemetry import live
from repro_torch.telemetry.export import SCHEMA, load_events
from repro_torch.telemetry.live import LiveSink, installed
from repro_torch.telemetry.registry import BUCKET_BOUNDS, bucket_index
from repro_torch.telemetry.slo import SLOConfig
from test_torch_comm_session import ReplayDraws

CPU = "cpu"
KEY = 7
LOOSE, TIGHT = 600_000, 20_000


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


def _reference(blob, backend, telemetry, session_bits):
    Xtr, ctr, Xte, _, k = blob
    transport = JBudgeted(JBudgetSpec(session_bits=session_bits), log=JLog(),
                          privacy=JMech(epsilon=1.0))
    proto = J.Protocol(J.SessionConfig(num_classes=k, max_rounds=3),
                       transport=transport, backend=backend,
                       telemetry=telemetry)
    proto.fit(jax.random.key(KEY),
              J.endpoints_for([JLogistic(steps=40) for _ in Xtr], _j(Xtr)),
              jnp.asarray(ctr))
    final_key = (proto._session.state.key if backend == "eager"
                 else proto._evolved_key(proto._compiled_ctx[2]))
    return np.asarray(proto.predict_distributed(_j(Xte))), final_key


def _port(blob, backend, telemetry, session_bits, final_key):
    Xtr, ctr, Xte, _, k = blob
    transport = TBudgeted(TBudgetSpec(session_bits=session_bits), log=TLog(),
                          privacy=TMech(epsilon=1.0))
    source = ReplayDraws(jax.random.key(KEY), len(Xtr))
    proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=3),
                       transport=transport, backend=backend,
                       telemetry=telemetry, device=CPU, draws=source)
    proto.fit(KEY, T.endpoints_for([TLogistic(steps=40, device=CPU)
                                    for _ in Xtr], _t(Xtr)),
              torch.from_numpy(ctr))
    source.final_key = final_key
    return proto.predict_distributed(_t(Xte)).numpy(), transport


@pytest.fixture(scope="module")
def runs(blob):
    """(backend, session bits) -> the reference's live registry and the
    port's live and dark runs, computed once."""
    cache = {}

    def get(backend, session_bits):
        if (backend, session_bits) not in cache:
            jtele, ttele = JTelemetry(live=True), Telemetry(live=True)
            _, final_key = _reference(blob, backend, jtele, session_bits)
            lit = _port(blob, backend, ttele, session_bits, final_key)
            dark = _port(blob, backend, None, session_bits, final_key)
            cache[backend, session_bits] = (jtele, ttele, lit, dark)
        return cache[backend, session_bits]
    return get


def live_series(reg) -> dict:
    return {name: reg.series(name) for name in reg.counter_names()
            if name.startswith("live_")}


CASES = [(b, bits) for b in ("eager", "compiled") for bits in (LOOSE, TIGHT)]


# ----------------------------------------------------- train/serve parity
@pytest.mark.parametrize("backend,session_bits", CASES)
def test_live_on_off_identical_and_matches_replay(runs, backend,
                                                  session_bits):
    _, tele, (p_on, t_on), (p_off, t_off) = runs(backend, session_bits)
    np.testing.assert_array_equal(p_on, p_off)
    assert t_on.log.entries == t_off.log.entries
    assert t_on.accountant.releases == t_off.accountant.releases
    reg = tele.registry
    assert reg.total("live_wire_bits_total") == reg.total("wire_bits_total")
    for kind in ("ignorance", "score_block"):
        assert reg.value("live_messages_total", kind=kind) == \
            reg.value("messages_total", kind=kind)
    assert reg.total("live_budget_skips_total") == \
        reg.total("budget_skips_total")
    if session_bits == TIGHT:          # the tight channel must skip
        assert reg.total("budget_skips_total") > 0
        assert reg.total("live_exhausted_total") >= 1


@pytest.mark.parametrize("backend,session_bits", CASES)
def test_live_series_match_reference(runs, backend, session_bits):
    jtele, ttele, _, _ = runs(backend, session_bits)
    assert live_series(ttele.registry) == live_series(jtele.registry)
    assert ttele.registry.gauge("live_round") == \
        jtele.registry.gauge("live_round")


@pytest.mark.parametrize("session_bits", [LOOSE, TIGHT])
def test_live_eager_equals_compiled(runs, session_bits):
    series = [live_series(runs(b, session_bits)[1].registry)
              for b in ("eager", "compiled")]
    assert series[0] == series[1]
    assert series[0]                    # and they streamed


def test_live_off_emits_nothing(blob):
    tele = Telemetry()
    _port(blob, "compiled", tele, LOOSE, jax.random.key(0))
    assert tele.live is None
    assert tele.registry.total("wire_bits_total") > 0
    assert live_series(tele.registry) == {}


def test_serve_batch_taps_each_slot_and_drops_pads(blob):
    Xtr, ctr, Xte, _, k = blob
    proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=2),
                       transport=T.MeteredTransport(), backend="compiled",
                       device=CPU)
    proto.fit(3, T.endpoints_for([TLogistic(steps=10, device=CPU)
                                  for _ in Xtr], _t(Xtr)),
              torch.from_numpy(ctr))
    _, plan, result = proto._compiled_ctx
    num = plan.num_agents
    slots = [{"key": proto._session.state.key, "request": rid,
              "Xs": [x[:8] for x in _t(Xte)], "params": result.params,
              "alphas": result.alphas, "valid": result.valid,
              "rem_session": None, "rem_link": None,
              "deliver": np.arange(num) < (num if rid < 3 else 0)}
             for rid in range(4)]       # three requests and a pad slot
    sink = LiveSink(MetricsRegistry())
    dark = TC.serve_batch(plan, slots)
    with installed(sink):
        lit = TC.serve_batch(plan, slots, live=True)
    for got, want in zip(lit, dark):
        assert torch.equal(got, want)
    assert sink.copies == 1
    assert sink.registry.total("live_serve_requests_total") == 3
    assert sink.registry.total("live_wire_bits_total") == \
        3 * (num - 1) * 32 * 8 * k
    assert sink.registry.value("live_messages_total",
                               kind="score_block") == 3 * (num - 1)


# ------------------------------------------------------------------ fleets
FLEET_PLANS = {
    "fp32": {},
    "int8-budget": {"budget": TBudgetSpec(session_bits=TIGHT)},
}


@pytest.mark.parametrize("name", sorted(FLEET_PLANS))
def test_fleet_live_matches_dark_and_sums(blob, name):
    Xtr, ctr, _, _, k = blob
    plan = TC.plan_for([TLogistic(steps=20, device=CPU) for _ in Xtr], k,
                       max_rounds=2, codec=QuantCodec(8),
                       **FLEET_PLANS[name])
    keys = [3, 4, 5]
    Xs, c = _t(Xtr), torch.from_numpy(ctr)
    dark = TC.fleet_run(plan, keys, Xs, c)
    sink = LiveSink(MetricsRegistry())
    with installed(sink):
        lit = TC.fleet_run(plan, keys, Xs, c, live=True)
    for got, want in zip(lit, dark):
        if isinstance(got, torch.Tensor):
            assert torch.equal(got, want)
    assert sink.copies == plan.max_rounds      # one copy a round
    singles = MetricsRegistry()
    for key in keys:
        one = LiveSink(singles)
        with installed(one):
            TC.compiled_session(plan, key, Xs, c, live=True)
        assert one.copies == plan.max_rounds
    assert live_series(sink.registry) == live_series(singles)
    rounds = int(dark.executed.any(-1).sum())
    assert sink.registry.total("live_rounds_total") == rounds


def test_tap_vmap_rule_replicates_an_unbatched_payload():
    """Under vmap a payload no batched value reaches still delivers once a
    batch element (the salt carries the batch axis), as one copy."""
    sink = LiveSink(MetricsRegistry())

    def body(salt):
        live.emit_round(salt, 2, True, 40, 1, 0, 0)
        return salt * 2

    with installed(sink):
        torch.func.vmap(body)(torch.arange(5.0))
    assert sink.registry.total("live_rounds_total") == 5
    assert sink.registry.total("live_wire_bits_total") == 200
    assert sink.copies == 1
    assert sink.registry.gauge("live_round") == 2


def test_taps_without_a_sink_are_dropped_and_installed_nests():
    outer, inner = LiveSink(MetricsRegistry()), LiveSink(MetricsRegistry())
    salt = torch.zeros(1)
    live.emit_serve(salt, True, 8, 1, 0)           # no sink: dropped
    with installed(outer):
        with installed(inner):
            live.emit_serve(salt, True, 8, 1, 0)
        live.emit_serve(salt, True, 16, 1, 0)
        live.emit_serve(salt, False, 99, 1, 0)      # a pad slot: dropped
    with installed(None):
        pass
    assert inner.registry.total("live_wire_bits_total") == 8
    assert outer.registry.total("live_wire_bits_total") == 16
    assert outer.taps == 1 and outer.copies == 2
    assert live._SINK is None


# ------------------------------------------------------------ serve + SLO
def _serve_engines(blob):
    """The reference test's workload on both packages: two compiled
    sessions, an engine with live telemetry and a minute's SLO, six
    requests.  Returns the two telemetries."""
    Xtr, ctr, Xte, _, k = blob
    out = []
    for pkg in ("reference", "port"):
        protos = {}
        for s in range(2):
            key = jax.random.key(100 + s)
            if pkg == "reference":
                proto = J.Protocol(J.SessionConfig(num_classes=k,
                                                   max_rounds=2),
                                   transport=J.MeteredTransport(),
                                   backend="compiled")
                proto.fit(key, J.endpoints_for(
                    [JLogistic(steps=30) for _ in Xtr], _j(Xtr)),
                    jnp.asarray(ctr))
            else:
                proto = T.Protocol(T.SessionConfig(num_classes=k,
                                                   max_rounds=2),
                                   transport=T.MeteredTransport(),
                                   backend="compiled", device=CPU,
                                   draws=ReplayDraws(key, len(Xtr)))
                proto.fit(100 + s, T.endpoints_for(
                    [TLogistic(steps=30, device=CPU) for _ in Xtr],
                    _t(Xtr)), torch.from_numpy(ctr))
            protos[f"s{s}"] = proto
        if pkg == "reference":
            tele = JTelemetry(live=True)
            engine = JServeEngine(cache_capacity=2, max_batch=4,
                                  telemetry=tele,
                                  slo=JSLOConfig(threshold_s=60.0,
                                                 objective=0.9))
            blocks = [x[:16] for x in _j(Xte)]
        else:
            tele = Telemetry(live=True)
            engine = ServeEngine(cache_capacity=2, max_batch=4,
                                 telemetry=tele,
                                 slo=SLOConfig(threshold_s=60.0,
                                               objective=0.9), device=CPU)
            blocks = [x[:16] for x in _t(Xte)]
        for sid, proto in protos.items():
            engine.add_session(sid, proto)
        for rid in range(6):
            engine.submit(f"t{rid % 2}", f"s{rid % 2}", blocks, request=rid)
        engine.flush()
        engine.close()
        out.append(tele)
    return out


def test_serve_engine_live_taps_and_slo_match_reference(blob):
    jtele, tele = _serve_engines(blob)
    reg = tele.registry
    assert reg.total("live_serve_requests_total") == 6
    assert reg.total("serve_requests_total") == 6
    blocks = sum(v for key, v in reg.series("wire_bits_total").items()
                 if dict(key)["kind"] == "score_block")
    assert reg.total("live_wire_bits_total") == blocks > 0
    for t in ("t0", "t1"):
        assert reg.histogram("request_seconds", tenant=t)["count"] == 3
        assert reg.value("slo_requests_total", tenant=t) == 3
        assert reg.value("slo_violations_total", tenant=t) == 0
    counters = {n: reg.series(n) for n in reg.counter_names()}
    assert counters == {n: jtele.registry.series(n)
                        for n in jtele.registry.counter_names()}
    assert reg._gauges == jtele.registry._gauges
    spans = [(s.name, s.attrs) for s in tele.tracer.spans]
    assert spans == [(s.name, s.attrs) for s in jtele.tracer.spans]
    assert {"flush", "flush_wave", "bucket_dispatch"} <= {n for n, _ in spans}


# ----------------------------------------------------- quantile estimation
@pytest.mark.parametrize("seed", [2_654_435_761 * i % (2 ** 31)
                                  for i in range(12)])
def test_quantile_within_one_bucket_and_as_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 200))
    xs = np.exp(rng.uniform(np.log(BUCKET_BOUNDS[0]),
                            np.log(BUCKET_BOUNDS[-1]), size=n))
    ours, ref = MetricsRegistry(), JRegistry()
    for x in xs:
        ours.observe("lat", float(x))
        ref.observe("lat", float(x))
    for q in (0.5, 0.9, 0.99):
        est = ours.quantile("lat", q)
        true = float(np.sort(xs)[min(n - 1, int(np.ceil(q * n)) - 1)])
        assert abs(bucket_index(est) - bucket_index(true)) <= 1
        assert est == ref.quantile("lat", q)


# ------------------------------------------- killed runs and the dashboard
def test_killed_live_trace_validates_and_renders(blob, tmp_path, capsys):
    path = tmp_path / "trace.jsonl"
    tele = Telemetry(live=True)
    tele.stream_trace(str(path))
    _port(blob, "compiled", tele, TIGHT, jax.random.key(0))   # never sealed
    lines = path.read_text().splitlines()
    assert [ln for ln in lines if '"type": "live"' in ln]
    torn = tmp_path / "torn.jsonl"
    torn.write_text("\n".join(lines[:-1]) + "\n" + lines[-1][:10])
    for checker in (tcheck, jcheck):
        assert checker.validate_file(str(torn), allow_partial=True) == []
        assert checker.main([str(torn), "--allow-partial"]) == 0
        assert checker.main([str(torn)]) == 1
    capsys.readouterr()
    assert tdash.main([str(torn)]) == 0
    frame = capsys.readouterr().out
    assert "live events" in frame and "round" in frame
    tele.write_artifacts(trace=str(path))      # sealed: the full registry
    events = load_events(str(path))
    assert events[0]["version"] == 2
    reloaded = MetricsRegistry.from_events(
        [e for e in events if e["type"] in ("counter", "gauge",
                                            "histogram")])
    for name in tele.registry.counter_names():
        assert reloaded.series(name) == tele.registry.series(name)


def test_dashboard_events_drive_draw():
    reg = MetricsRegistry()
    stream = io.StringIO()
    dash = tdash.Dashboard(reg, title="t", min_interval=0.0, stream=stream)
    sink = LiveSink(reg)
    dash.attach(sink)
    sink.round_tap(0, 128, 2, 0, 0)
    sink.serve_tap(64, 1, 0)
    dash.final()
    assert dash.frames == 3
    assert "wire" in stream.getvalue()
    assert reg.total("live_rounds_total") == 1
    assert tdash.render(reg, sink=sink, title="t") == \
        tdash.render(reg, sink=sink, title="t")


# ------------------------------------------------------------ trace schema
def _meta(version):
    return {"type": "meta", "schema": SCHEMA, "version": version}


@pytest.mark.parametrize("checker", [tcheck, jcheck],
                         ids=["port", "reference"])
def test_live_events_need_schema_v2(checker):
    event = {"type": "live", "tag": "round", "t": 0, "bits": 1, "sent": 1,
             "skipped": 0, "exhausted": 0, "t_s": 0.0}
    assert any("v1" in e for e in checker.validate_events([_meta(1), event]))
    assert checker.validate_events([_meta(2), event]) == []
    assert any("tag" in e for e in checker.validate_events(
        [_meta(2), {"type": "live", "bits": 1}]))
    assert checker.validate_events(
        [_meta(1), {"type": "counter", "name": "x", "labels": {},
                    "value": 1}]) == []
