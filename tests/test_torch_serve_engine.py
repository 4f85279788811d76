"""The port's serve engine (``repro_torch.serve``: admission, the resident
cache, the continuous batcher, ``ServeEngine``), the invariants of the
reference's tests/test_serve_engine.py on the port, on the reference's
blob fixture (n = 240, the data converted from numpy).

The defining one: a request served through the batched engine equals the
same request served alone by ``Protocol.predict_distributed(Xs,
request=rid)`` bit for bit: predictions, booked bits, DP releases.  Also:
budgeted requests against one session serialize across waves as
sequential serving does; a spilled and restored session serves as a
resident one; admission denies or degrades before any work, within the
byte and ε caps; ``serve_batch`` equals ``serve_session`` slot by slot;
the serve controller's rungs are the same on both backends.  The
bookkeeping modules the reference holds too (``TenantBudget``,
``AdmissionController``, ``MetricsRegistry``, ``SLOTracker``) are fed one
stream on both sides and their counters compared exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro.comm.budget import TenantBudget as JTenantBudget
from repro.comm.privacy import GaussianMechanism as JMech
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.serve.admission import AdmissionController as JAdmission
from repro.serve.admission import AdmissionPolicy as JPolicy
from repro.telemetry.registry import MetricsRegistry as JRegistry
from repro.telemetry.slo import SLOConfig as JSLOConfig
from repro.telemetry.slo import SLOTracker as JSLOTracker
from repro_torch.comm import (BudgetSpec, BudgetedTransport,
                              GaussianMechanism, make_codec)
from repro_torch.comm.budget import TenantBudget
from repro_torch.control import ServeController
from repro_torch.core import compiled
from repro_torch.core.engine import (MeteredTransport, Protocol,
                                     SessionConfig, endpoints_for)
from repro_torch.learners.logistic import LogisticRegression
from repro_torch.serve import (ACCEPT, DEGRADE, DENY, AdmissionController,
                               AdmissionPolicy, Batcher, ServeEngine, Slot)
from repro_torch.serve.cache import ServeSessionState, SessionCache
from repro_torch.telemetry import SpanTracer, Telemetry
from repro_torch.telemetry.registry import MetricsRegistry
from repro_torch.telemetry.slo import SLOConfig, SLOTracker

CPU = "cpu"
BIG = 2 ** 31 - 1


@pytest.fixture(scope="module")
def blob():
    ds = blob_fig3(jax.random.key(0), n=240)
    tr, te = train_test_split(0, 240)
    Xs = vertical_split(ds.X, ds.splits)
    return ([torch.from_numpy(np.array(x[tr])) for x in Xs],
            torch.from_numpy(np.array(ds.classes[tr])),
            [torch.from_numpy(np.array(x[te])) for x in Xs], ds.num_classes)


def _fit(blob, make_transport, seed=11, rounds=2, steps=30,
         backend="compiled"):
    Xtr, ctr, _, k = blob
    transport = make_transport()
    proto = Protocol(SessionConfig(num_classes=k, max_rounds=rounds),
                     transport=transport, backend=backend, device=CPU)
    proto.fit(seed, endpoints_for([LogisticRegression(steps=steps,
                                                      device=CPU)
                                   for _ in Xtr], Xtr), ctr)
    return proto, transport


def _requests(blob, sessions, count, block_n=16, seed=7):
    _, _, Xte, _ = blob
    rng = np.random.default_rng(seed)
    n = int(Xte[0].shape[0])
    out = []
    for _ in range(count):
        sid = sessions[rng.integers(len(sessions))]
        rows = torch.from_numpy(rng.choice(n, size=block_n, replace=False))
        out.append((sid, tuple(x[rows] for x in Xte)))
    return out


def _engine(**kw):
    return ServeEngine(device=CPU, **kw)


@pytest.fixture(scope="module")
def fleet(blob):
    """Three fitted DP + int8 sessions sharing one plan."""
    mech = GaussianMechanism(epsilon=2.0, clip=0.1)
    protos = {
        f"s{i}": _fit(blob, lambda: MeteredTransport(
            serve_codec=make_codec("int8"), privacy=mech), seed=20 + i)
        for i in range(3)}
    return protos, mech


# ================================================= the batched-parity pin
def test_batched_bit_identical_to_per_request(blob, fleet):
    protos, _ = fleet
    engine = _engine(cache_capacity=3, max_batch=4)
    for sid, (proto, _) in protos.items():
        engine.add_session(sid, proto)      # before the baselines serve
    reqs = _requests(blob, list(protos), 10)
    for rid, (sid, Xblk) in enumerate(reqs):
        engine.submit("t0", sid, Xblk, request=rid)
        if (rid + 1) % 4 == 0:
            engine.flush()
    engine.flush()
    for rid, (sid, Xblk) in enumerate(reqs):
        proto, transport = protos[sid]
        n_before = len(transport.log.entries)
        rel_before = dict(transport.accountant.releases)
        base = proto.predict_distributed(Xblk, request=rid)
        out = engine.outcomes[rid]
        np.testing.assert_array_equal(out.preds, base.numpy())
        new = transport.log.entries[n_before:]
        assert all(e["kind"] == "score_block" for e in new)
        assert out.bits == sum(e["bits"] for e in new) > 0
        rel_delta = sum(transport.accountant.releases.get(a, 0)
                        - rel_before.get(a, 0)
                        for a in transport.accountant.releases)
        assert out.releases == rel_delta == len(new)
    assert engine.log.total_bits == sum(
        o.bits for o in engine.outcomes.values())
    for sid in protos:
        meta = engine.sessions[sid]
        assert all(v == meta.served
                   for v in meta.accountant.releases.values())
    assert engine.batcher.batches_run < len(reqs)   # it batched
    engine.close()


def test_batched_budget_waves_match_sequential(blob):
    """Same-session requests in one flush serialize across waves: preds,
    bits, skips and exhaustion as serving them one at a time."""
    Xtr, ctr, _, _ = blob
    n, m = len(ctr), len(Xtr)
    setup = (m - 1) * 2 * n * 32
    spec = BudgetSpec(session_bits=setup + 2 * m * (n * 32 + 32) + 14_000)
    proto, transport = _fit(blob, lambda: BudgetedTransport(spec))
    engine = _engine(cache_capacity=1, max_batch=8)
    engine.add_session("s0", proto)
    reqs = _requests(blob, ["s0"], 6)
    for rid, (sid, Xblk) in enumerate(reqs):
        engine.submit("t0", sid, Xblk, request=rid)
    engine.flush()                          # six waves of one slot
    assert engine.batcher.batches_run == 6
    for rid, (sid, Xblk) in enumerate(reqs):
        n_before = len(transport.log.entries)
        base = proto.predict_distributed(Xblk, request=rid)
        out = engine.outcomes[rid]
        np.testing.assert_array_equal(out.preds, base.numpy())
        assert out.bits == sum(e["bits"]
                               for e in transport.log.entries[n_before:])
    meta = engine.sessions["s0"]
    assert len(meta.skipped) > 0            # the budget bit
    assert meta.exhausted == transport.exhausted
    state = engine.cache.get("s0")
    assert int(state.rem_session) == spec.session_bits - \
        transport.log.total_bits
    engine.close()


# ============================================= spill and restore, exactly
def test_evicted_session_serves_bit_identically(blob, fleet):
    protos, _ = fleet
    resident = _engine(cache_capacity=3, max_batch=4)
    pressured = _engine(cache_capacity=1, max_batch=4)
    for sid, (proto, _) in protos.items():
        resident.add_session(sid, proto)
        pressured.add_session(sid, proto)
    reqs = _requests(blob, list(protos), 9, seed=13)
    for rid, (sid, Xblk) in enumerate(reqs):
        resident.submit("t0", sid, Xblk, request=rid)
        pressured.submit("t0", sid, Xblk, request=rid)
        if rid % 2 == 0:
            resident.flush()
            pressured.flush()
            for s in list(pressured.cache.resident_ids):
                pressured.cache.evict(s)
    resident.flush()
    pressured.flush()
    assert pressured.cache.stats()["spills"] > 0
    assert pressured.cache.stats()["restores"] > 0
    for rid in range(len(reqs)):
        a, b = resident.outcomes[rid], pressured.outcomes[rid]
        np.testing.assert_array_equal(a.preds, b.preds)
        assert (a.bits, a.releases) == (b.bits, b.releases)
    for sid in protos:
        assert (resident.sessions[sid].accountant.releases
                == pressured.sessions[sid].accountant.releases)
    assert resident.log.total_bits == pressured.log.total_bits
    resident.close()
    pressured.close()


def test_cache_spill_roundtrip_exact(tmp_path):
    cache = SessionCache(1, str(tmp_path), device=CPU)

    def state(v):
        return ServeSessionState(
            params=({"w": torch.arange(4.0) * v},), alphas=torch.ones(3) * v,
            valid=torch.tensor([True, True, False]),
            key_data=np.array([0, 4000000000 + int(v)], np.uint32),
            rem_session=torch.tensor(1000 + int(v), dtype=torch.int32),
            rem_link=torch.tensor([7, 8, 9], dtype=torch.int32))
    cache.put("a", state(1.0))
    cache.put("b", state(2.0))              # spills a
    assert cache.resident_ids == ("b",) and "a" in cache
    a = cache.get("a")                      # restored
    assert torch.equal(a.params[0]["w"], torch.arange(4.0))
    assert a.key_data.dtype == np.uint32
    np.testing.assert_array_equal(a.key_data, [0, 4000000001])
    assert a.rem_session.dtype == torch.int32 and int(a.rem_session) == 1001
    assert torch.equal(a.valid, torch.tensor([True, True, False]))
    assert cache.stats()["spills"] >= 1 and cache.stats()["restores"] == 1
    with pytest.raises(KeyError):
        cache.get("never-put")


# ====================================================== admission control
def test_admission_deny_degrade_and_counters(blob, fleet):
    protos, mech = fleet
    proto, _ = protos["s0"]
    endpoints, plan, _ = proto._compiled_ctx
    shape = (16, plan.num_classes)
    full = int(plan.serve_ladder[0].wire_bits(shape)) * (len(endpoints) - 1)
    cap_bits = int(full * 1.5)              # one full request, not two
    engine = _engine(cache_capacity=2, max_batch=4,
                     admission=AdmissionController(
                         AdmissionPolicy(allow_degrade=True),
                         tenant_bits=cap_bits, mechanism=mech))
    engine.add_session("s0", proto)
    reqs = _requests(blob, ["s0"], 4, seed=3)
    decisions = [engine.submit("poor", sid, X, request=r)[1]
                 for r, (sid, X) in enumerate(reqs)]
    engine.flush()
    outcomes = [d.outcome for d in decisions]
    assert outcomes[0] == ACCEPT and DEGRADE in outcomes
    first = outcomes.index(DEGRADE)
    assert all(o == DEGRADE for o in outcomes[first:])
    for rid, o in enumerate(outcomes):
        out = engine.outcomes[rid]
        assert out.preds is not None        # a degraded request answers
        if o == DEGRADE:
            assert out.bits == 0 and out.releases == 0
    c = engine.admission.counters()["poor"]
    assert (c["served"], c["degraded"], c["denied"]) == (
        outcomes.count(ACCEPT), outcomes.count(DEGRADE), 0)
    assert c["bits"] <= cap_bits
    engine.close()

    deny = _engine(cache_capacity=2, max_batch=4,
                   admission=AdmissionController(
                       AdmissionPolicy(allow_degrade=False), tenant_bits=1))
    deny.add_session("s0", proto)
    _, d = deny.submit("poor", "s0", reqs[0][1], request=0)
    assert d.outcome == DENY
    assert deny.outcomes[0].preds is None and len(deny.batcher) == 0
    assert deny.admission.counters()["poor"]["denied"] == 1
    deny.close()


def test_degraded_request_is_the_head_only_prediction(blob, fleet):
    """deliver = [True, False, ...]: the head's own argmax, nothing
    shipped, no release."""
    protos, _ = fleet
    proto, _ = protos["s1"]
    endpoints, plan, result = proto._compiled_ctx
    _, X = _requests(blob, ["s1"], 1, seed=21)[0]
    deliver = np.zeros(len(endpoints), bool)
    deliver[0] = True
    out = compiled.serve_session(plan, result, proto._session.state.key, X,
                                 request=0, deliver=deliver)
    assert not out.sent.any()
    assert torch.equal(out.preds, out.blocks[0].argmax(dim=-1))


def test_admission_epsilon_cap(blob, fleet):
    protos, mech = fleet
    proto, _ = protos["s1"]
    m = len(proto._compiled_ctx[0])
    cap = mech.epsilon * (m - 1) * 1.5      # one full request's releases
    engine = _engine(cache_capacity=2, max_batch=4,
                     admission=AdmissionController(
                         AdmissionPolicy(allow_degrade=True,
                                         epsilon_cap=cap), mechanism=mech))
    engine.add_session("s1", proto)
    reqs = _requests(blob, ["s1"], 2, seed=5)
    d0 = engine.submit("tA", "s1", reqs[0][1], request=0)[1]
    engine.flush()
    d1 = engine.submit("tA", "s1", reqs[1][1], request=1)[1]
    engine.flush()
    assert (d0.outcome, d1.outcome) == (ACCEPT, DEGRADE)
    assert engine.outcomes[1].releases == 0 and "epsilon" in d1.reason
    engine.close()


# ================================== serve_batch and the batcher's padding
def test_serve_batch_matches_serve_session_per_slot(blob, fleet):
    protos, _ = fleet
    proto, _ = protos["s2"]
    _, plan, result = proto._compiled_ctx
    key = proto._session.state.key
    reqs = _requests(blob, ["s2"], 3, seed=9)
    num = plan.num_agents
    slots = [{"key": key, "request": rid, "Xs": Xblk,
              "params": result.params, "alphas": result.alphas,
              "valid": result.valid, "rem_session": BIG,
              "rem_link": [BIG] * num, "deliver": np.ones(num, bool)}
             for rid, (_, Xblk) in enumerate(reqs)]
    batched = compiled.serve_batch(plan, slots)
    for rid, (_, Xblk) in enumerate(reqs):
        alone = compiled.serve_session(plan, result, key, Xblk, request=rid)
        for got, want in zip(batched, alone):
            assert torch.equal(got[rid], want)
    batcher = Batcher(max_batch=4)
    state = ServeSessionState(
        params=result.params, alphas=result.alphas, valid=result.valid,
        key_data=np.asarray(key), rem_session=torch.tensor(BIG),
        rem_link=torch.full((num,), BIG, dtype=torch.int32))
    for rid, (_, Xblk) in enumerate(reqs):
        batcher.add(Slot(request_id=rid, session_id=f"sess{rid}", tenant="t",
                         plan=plan, key=key, Xs=Xblk,
                         deliver=np.ones(num, bool), state=state,
                         request=rid))
    out = batcher.flush()
    assert batcher.stats()["padded_slots"] == 1     # 3 slots pad to 4
    assert batcher.stats()["batches_run"] == 1
    for slot, res in out:
        np.testing.assert_array_equal(
            res.preds, batched.preds[slot.request_id].numpy())
    # with a tracer: the same results, a flush_wave span a wave and a
    # bucket_dispatch span a bucket program under it
    tracer = SpanTracer()
    traced = Batcher(max_batch=4, tracer=tracer)
    for rid, (_, Xblk) in enumerate(reqs):
        traced.add(Slot(request_id=rid, session_id=f"sess{rid}", tenant="t",
                        plan=plan, key=key, Xs=Xblk,
                        deliver=np.ones(num, bool), state=state,
                        request=rid))
    for (_, res), (_, want) in zip(traced.flush(), out):
        np.testing.assert_array_equal(res.preds, want.preds)
    assert [(s.name, s.attrs) for s in tracer.spans] == [
        ("flush_wave", {"slots": 3, "step": 0}),
        ("bucket_dispatch", {"slots": 3, "pad": 1})]
    assert tracer.well_formed()


# ================================== the serve controller on both backends
@pytest.mark.parametrize("stat", ["margin", "entropy"])
def test_serve_controller_eager_matches_compiled(blob, stat):
    _, _, Xte, k = blob
    ctl = ServeController(stat=stat)
    mech = GaussianMechanism(epsilon=2.0, clip=0.1)
    runs = {}
    for backend in ("eager", "compiled"):
        proto, transport = _fit(
            blob, lambda: MeteredTransport(serve_controller=ctl,
                                           privacy=mech), backend=backend)
        runs[backend] = (proto.predict_distributed(Xte).numpy(), transport)
    (pe, te), (pc, tc) = runs["eager"], runs["compiled"]
    np.testing.assert_array_equal(pe, pc)
    assert te.log.entries == tc.log.entries
    assert te.accountant.releases == tc.accountant.releases
    blocks = [e for e in te.log.entries if e["kind"] == "score_block"]
    raw = 32 * Xte[0].shape[0] * k
    assert blocks and all(e["bits"] < raw for e in blocks)


def test_serve_controller_respects_budget_floor(blob):
    ctl = ServeController(stat="margin")
    Xtr, ctr, Xte, _ = blob
    n, m = len(ctr), len(Xtr)
    spec = BudgetSpec(session_bits=(m - 1) * 2 * n * 32
                      + 2 * m * (n * 32 + 32) + 6000)
    runs = {}
    for backend in ("eager", "compiled"):
        proto, transport = _fit(
            blob, lambda: BudgetedTransport(spec, serve_controller=ctl),
            backend=backend)
        runs[backend] = ([proto.predict_distributed(Xte).numpy()
                          for _ in range(2)], transport)
    (pe, te), (pc, tc) = runs["eager"], runs["compiled"]
    assert te.log.entries == tc.log.entries
    assert (te.skipped, te.exhausted) == (tc.skipped, tc.exhausted)
    for a, b in zip(pe, pc):
        np.testing.assert_array_equal(a, b)


# ======================================================== engine plumbing
def test_engine_rejects_unfit_duplicate_and_later_slices(blob, fleet):
    protos, _ = fleet
    proto, _ = protos["s0"]
    engine = _engine(cache_capacity=2)
    engine.add_session("s0", proto)
    with pytest.raises(ValueError, match="already registered"):
        engine.add_session("s0", proto)
    eager, _ = _fit(blob, MeteredTransport, backend="eager", rounds=1,
                    steps=5)
    with pytest.raises(ValueError, match="compiled"):
        engine.add_session("e0", eager)
    with pytest.raises(KeyError):
        engine.submit("t", "missing", [torch.ones((4, 2))] * 3)
    engine.close()
    # a Telemetry bundle's registry is the engine's one registry
    tele = Telemetry()
    assert ServeEngine(telemetry=tele, device=CPU).registry is tele.registry


def test_summary_schema(blob, fleet):
    protos, _ = fleet
    engine = _engine(cache_capacity=2, max_batch=4,
                     slo=SLOConfig(threshold_s=10.0))
    for sid, (proto, _) in protos.items():
        engine.add_session(sid, proto)
    for rid, (sid, Xblk) in enumerate(_requests(blob, list(protos), 5)):
        engine.submit(f"t{rid % 2}", sid, Xblk, request=rid)
    engine.flush()
    s = engine.summary()
    assert set(s) == {"tenants", "cache", "batcher", "sessions",
                      "total_bits", "requests", "slo"}
    assert s["requests"] == 5
    assert sum(t["served"] for t in s["tenants"].values()) == 5
    assert s["batcher"]["slots_run"] == 5
    assert all(t["ok"] for t in s["slo"]["tenants"].values())
    assert engine.registry.quantile_all("request_seconds", 0.99) > 0
    engine.close()


def test_serve_fleet_cli_runs(capsys, tmp_path):
    from repro_torch.launch import serve_fleet
    summary = serve_fleet.main(["--device", "cpu", "--sessions", "3",
                                "--requests", "12", "--serve-codec", "int8",
                                "--cache-capacity", "2", "--flush-every",
                                "4", "--n", "240", "--steps", "20"])
    assert summary["requests"] == 12
    assert summary["cache"]["spills"] > 0
    assert summary["request_seconds"]["p99"] > 0
    # --trace, --metrics-out (tests/test_torch_telemetry.py checks them)
    trace = tmp_path / "t.jsonl"
    serve_fleet.main(["--device", "cpu", "--sessions", "1", "--requests",
                      "2", "--n", "120", "--steps", "5", "--trace",
                      str(trace)])
    assert trace.read_text().startswith('{"schema": "repro-telemetry"')


# ===================== the bookkeeping modules, one stream on both sides
def test_tenant_budget_matches_reference():
    ours, ref = TenantBudget(bits=1000), JTenantBudget(bits=1000)
    for cost in (300, 0, 450, 400, 250):
        assert ours.affordable(cost) == ref.affordable(cost)
        if ref.affordable(cost):
            ours.charge(cost)
            ref.charge(cost)
        assert (ours.spent, ours.remaining) == (ref.spent, ref.remaining)
    for budget in (TenantBudget, JTenantBudget):
        with pytest.raises(ValueError):
            budget(bits=0)
        with pytest.raises(TypeError):
            budget().charge(1.5)


def test_admission_controller_matches_reference():
    """One stream of admits and books against two tenants, a byte cap and
    an ε cap, deny and degrade policies: the same decisions and
    counters."""
    for allow in (True, False):
        ours = AdmissionController(AdmissionPolicy(allow, 5.0),
                                   tenant_bits=900,
                                   mechanism=GaussianMechanism(1.0))
        ref = JAdmission(JPolicy(allow, 5.0), tenant_bits=900,
                         mechanism=JMech(1.0))
        rng = np.random.default_rng(allow)
        for i in range(40):
            tenant = f"t{i % 2}"
            bits, rel = int(rng.integers(50, 300)), int(rng.integers(0, 3))
            a = ours.admit(tenant, min_full_bits=bits, releases=rel)
            b = ref.admit(tenant, min_full_bits=bits, releases=rel)
            assert (a.outcome, a.reason, a.reserved_bits,
                    a.reserved_releases) == (b.outcome, b.reason,
                                             b.reserved_bits,
                                             b.reserved_releases)
            if i % 3 != 2:
                shipped = bits if a.outcome == ACCEPT else 0
                ours.book(tenant, a, bits=shipped,
                          releases=rel if a.outcome == ACCEPT else 0)
                ref.book(tenant, b, bits=shipped,
                         releases=rel if b.outcome == ACCEPT else 0)
        assert ours.counters() == ref.counters()


def test_metrics_registry_matches_reference():
    ours, ref = MetricsRegistry(), JRegistry()
    rng = np.random.default_rng(4)
    for i in range(200):
        labels = {"tenant": f"t{i % 3}", "event": ("hit", "spill")[i % 2]}
        for reg in (ours, ref):
            reg.inc("events_total", i % 5, **labels)
            reg.set_gauge("burn", i / 7, tenant=labels["tenant"])
        value = float(rng.lognormal(-6, 2))
        ours.observe("request_seconds", value, tenant=labels["tenant"])
        ref.observe("request_seconds", value, tenant=labels["tenant"])
    assert ours.to_events() == ref.to_events()
    for q in (0.5, 0.9, 0.99):
        assert ours.quantile_all("request_seconds", q) == \
            ref.quantile_all("request_seconds", q)
        assert ours.quantile("request_seconds", q, tenant="t1") == \
            ref.quantile("request_seconds", q, tenant="t1")
    assert ours.total("events_total") == ref.total("events_total")
    assert ours.label_values("events_total", "tenant") == \
        ref.label_values("events_total", "tenant")
    with pytest.raises(ValueError):
        ours.inc("x", -1)


def test_slo_tracker_matches_reference():
    ours = SLOTracker(SLOConfig(0.01, 0.9), MetricsRegistry())
    ref = JSLOTracker(JSLOConfig(0.01, 0.9), JRegistry())
    rng = np.random.default_rng(8)
    for i in range(60):
        tenant = f"t{i % 3}"
        if i % 11 == 0:
            ours.record_denial(tenant)
            ref.record_denial(tenant)
        else:
            seconds = float(rng.exponential(0.008))
            ours.observe(tenant, seconds)
            ref.observe(tenant, seconds)
    assert ours.report() == ref.report()
    assert ours.registry.to_events() == ref.registry.to_events()
