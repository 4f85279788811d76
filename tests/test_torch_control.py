"""The port's control plane and async variant against the JAX package's.

Units: the adaptive controller's and the serve controller's rungs (and
the EMA within float32 rounding) against the reference's jitted programs,
the reward EMA's float32 step exactly, the budget-aware order against the
reference's ``traced_round_order``.

Sessions, on the blob3 n=300 data of tests/test_torch_comm_session.py and
its replayed draws: a controller per statistic, a serve controller, a
controller under a bit budget (its rung a floor on the walk), the
budget-aware scheduler on a budgeted and on a plain metered transport, and
the async variant without a channel, with int8, with top-k and DP, and
under a budget that ends it exhausted.  Equal: the rung sequences (not
near: an EMA one ulp off a threshold picks another rung), the components
and so the round orders, the stop round and every ledger entry (whose bits
name each hop's and block's codec).  Within rtol 1e-5: the alphas; atol
1e-6: the final w; the distributed predictions equal.  An async round
splits the reference's key once per agent and, under a channel, once more
for its barrier, so its replay advances M + 1 keys a round.

Then pause and resume of each new path (the controller's EMA, the
scheduler's state and the barrier's top-k residual cross the checkpoint;
the resumed run is the uninterrupted one bit for bit), and the CLI's new
flags with the reference's argument rules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import BudgetedTransport as JBudgeted
from repro.comm import BudgetSpec as JBudgetSpec
from repro.comm import codecs as jcodecs
from repro.comm.privacy import GaussianMechanism as JMech
from repro.control import adaptive as jadaptive
from repro.control import scheduler as jscheduler
from repro.core import engine as J
from repro_torch.comm import BudgetedTransport as TBudgeted
from repro_torch.comm import BudgetSpec as TBudgetSpec
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.privacy import GaussianMechanism as TMech
from repro_torch.control import adaptive as tadaptive
from repro_torch.control import scheduler as tscheduler
from repro_torch.core import engine as T
from repro_torch.launch import session as cli
from repro_torch.learners.base import Learner as TLearner
from repro_torch.learners.tree import DecisionTree as TTree
from test_torch_comm_session import (CPU, ReplayDraws, _jlearners, _record,
                                     _tlearners, blob)  # noqa: F401

ROUNDS = 4


# ==================================================================== units
def _vectors(seed, n=257, count=12):
    """Ignorance-like vectors that concentrate step by step."""
    rng = np.random.default_rng(seed)
    w = np.full(n, 1.0 / n, np.float32)
    out = [w]
    for _ in range(count):
        r = (rng.random(n) < 0.7).astype(np.float32)
        w = w * np.exp(rng.uniform(0.2, 1.5) * (1 - r)).astype(np.float32)
        w = (w / w.sum()).astype(np.float32)
        out.append(w)
    return out


@pytest.mark.parametrize("stat", tadaptive.STATS)
def test_controller_rungs_equal_the_jitted_reference(stat):
    """Twelve hops of one controller: every rung equal, the EMA within
    float32 rounding (its statistic is rounded from float64 here, summed
    in float32 there)."""
    jc = jadaptive.AdaptiveController(stat=stat)
    tc = tadaptive.AdaptiveController(stat=stat)
    assert tc.thresholds == jc.thresholds
    step = jadaptive.jitted_controller(jc)
    vs = _vectors(1)
    j_ema, t_ema = jc.init_state(), tc.init_state()
    j_rungs, t_rungs = [], []
    for prev, out in zip(vs[:-1], vs[1:]):
        rung, j_ema = step(jnp.asarray(prev), jnp.asarray(out), j_ema)
        j_rungs.append(int(rung))
        t_rung, t_ema = tc.step(torch.from_numpy(prev), torch.from_numpy(out),
                                t_ema)
        t_rungs.append(t_rung)
        assert abs(float(t_ema) - float(j_ema)) <= 1e-6
        assert isinstance(t_ema, np.float32)
    assert t_rungs == j_rungs
    assert len(set(t_rungs)) > 1, t_rungs     # the policy moves


@pytest.mark.parametrize("stat", tadaptive.SERVE_STATS)
def test_serve_controller_rungs_equal_the_jitted_reference(stat):
    """Score blocks from confident to near-tied: the serve rung of each
    equals the reference's, and the statistic is within float32 rounding."""
    jc = jadaptive.ServeController(stat=stat)
    tc = tadaptive.ServeController(stat=stat)
    rung_of = jadaptive.jitted_serve_controller(jc)
    rng = np.random.default_rng(2)
    rungs = []
    for spread in (0.05, 0.3, 1.0, 3.0, 10.0):
        block = (rng.normal(size=(90, 10)) * spread).astype(np.float32)
        block[:, 0] += 2.0
        want = int(rung_of(jnp.asarray(block)))
        assert tc.rung_for(torch.from_numpy(block)) == want
        assert abs(float(tc.observe(torch.from_numpy(block)))
                   - float(jc.observe(jnp.asarray(block)))) <= 1e-6
        rungs.append(want)
    assert len(set(rungs)) > 1, rungs


def test_controller_rejects_what_the_reference_rejects():
    for bad in (dict(stat="nope"), dict(thresholds=(0.1, 0.5, 0.9)),
                dict(thresholds=(0.5,)), dict(beta=1.0),
                dict(ladder=(tcodecs.TopKCodec(),))):
        with pytest.raises(ValueError):
            tadaptive.AdaptiveController(**bad)
    with pytest.raises(ValueError):
        tadaptive.ServeController(stat="resid")
    with pytest.raises(ValueError):              # a fixed codec and a ladder
        T.MeteredTransport(codec=tcodecs.Fp16Codec(),
                           controller=tadaptive.AdaptiveController())
    with pytest.raises(ValueError):
        T.MeteredTransport(serve_codec=tcodecs.Fp16Codec(),
                           serve_controller=tadaptive.ServeController())
    with pytest.raises(ValueError):              # another ladder than the budget's
        TBudgeted(TBudgetSpec(), controller=tadaptive.AdaptiveController(
            ladder=(tcodecs.Fp32Codec(), tcodecs.Fp16Codec())))


def test_reward_ema_step_is_the_reference_float32():
    rng = np.random.default_rng(3)
    for beta in (0.0, 0.3, 0.5, 0.9):
        step = jscheduler.jitted_reward_ema(beta)
        for _ in range(50):
            prev, acc = float(np.float32(rng.random())), float(rng.random())
            for fresh in (True, False):
                want = float(step(prev, acc, fresh))
                got = float(tscheduler.reward_ema_update(beta, prev, acc,
                                                         fresh))
                assert got == want, (beta, prev, acc, fresh)


def test_budget_aware_order_is_the_reference_rule():
    """The port's tensor rule, the scheduler's ``round_order`` over it and
    the reference's traced ``lexsort`` give one order, ties broken by -EMA
    then id."""
    rng = np.random.default_rng(4)
    for _ in range(40):
        m = int(rng.integers(2, 7))
        spent = rng.integers(0, 3, m) * 1000
        ema = np.round(rng.random(m), 1).astype(np.float32)
        want = np.asarray(jscheduler.traced_round_order(
            jnp.asarray(spent), jnp.asarray(ema)))
        got = tscheduler.traced_round_order(torch.from_numpy(spent),
                                            torch.from_numpy(ema)).numpy()
        np.testing.assert_array_equal(got, want)
        sched = tscheduler.BudgetAwareScheduler()
        sched._reward_ema = {i: float(e) for i, e in enumerate(ema)}
        sched._spent_by_agent = lambda active: dict(enumerate(spent))
        assert sched.round_order(0, list(range(m))) == list(want)


# ================================================================= sessions
def _hop_costs(n):
    return JBudgetSpec().hop_costs(n)


def _pairs(n, m):
    """(reference transport, port transport, reference scheduler, port
    scheduler, replay's keys a round) per session config."""
    setup = (m - 1) * 2 * n * 32
    tight = setup + 7 * (n * 32 + 32)         # the walk degrades, then skips
    tighter = setup + 4 * (n * 32 + 32)       # ... past the controller's floor
    async_budget = (setup + 3 * 32 * m * 3 + n * (32 + 16 + 8 + 4) + 100)

    def ctrl(stat):
        return (J.MeteredTransport(
                    controller=jadaptive.AdaptiveController(stat=stat)),
                T.MeteredTransport(
                    controller=tadaptive.AdaptiveController(stat=stat)))

    return {
        "resid": (*ctrl("resid"), None, None, m),
        "entropy": (*ctrl("entropy"), None, None, m),
        "l2": (*ctrl("l2"), None, None, m),
        "entropy+serve-margin": (
            J.MeteredTransport(
                controller=jadaptive.AdaptiveController(stat="entropy"),
                serve_controller=jadaptive.ServeController(stat="margin")),
            T.MeteredTransport(
                controller=tadaptive.AdaptiveController(stat="entropy"),
                serve_controller=tadaptive.ServeController(stat="margin")),
            None, None, m),
        "int8+serve-entropy": (
            J.MeteredTransport(
                codec=jcodecs.QuantCodec(bits=8),
                serve_controller=jadaptive.ServeController(stat="entropy")),
            T.MeteredTransport(
                codec=tcodecs.QuantCodec(bits=8),
                serve_controller=tadaptive.ServeController(stat="entropy")),
            None, None, m),
        "budget+resid": (
            JBudgeted(JBudgetSpec(session_bits=tighter),
                      controller=jadaptive.AdaptiveController(),
                      serve_controller=jadaptive.ServeController()),
            TBudgeted(TBudgetSpec(session_bits=tighter),
                      controller=tadaptive.AdaptiveController(),
                      serve_controller=tadaptive.ServeController()),
            None, None, m),
        "budget-aware+links": (
            JBudgeted(JBudgetSpec(session_bits=tight,
                                  link_bits=3 * (n * 32 + 32))),
            TBudgeted(TBudgetSpec(session_bits=tight,
                                  link_bits=3 * (n * 32 + 32))),
            jscheduler.BudgetAwareScheduler(),
            tscheduler.BudgetAwareScheduler(), m),
        "budget-aware+metered": (
            J.MeteredTransport(), T.MeteredTransport(),
            jscheduler.BudgetAwareScheduler(),
            tscheduler.BudgetAwareScheduler(), m),
        "async": (J.MeteredTransport(), T.MeteredTransport(),
                  J.AsyncStaleScheduler(), T.AsyncStaleScheduler(), m),
        "async+int8": (
            J.MeteredTransport(codec=jcodecs.QuantCodec(bits=8)),
            T.MeteredTransport(codec=tcodecs.QuantCodec(bits=8)),
            J.AsyncStaleScheduler(), T.AsyncStaleScheduler(), m + 1),
        "async+topk+dp": (
            J.MeteredTransport(codec=jcodecs.TopKCodec(),
                               privacy=JMech(epsilon=10.0)),
            T.MeteredTransport(codec=tcodecs.TopKCodec(),
                               privacy=TMech(epsilon=10.0)),
            J.AsyncStaleScheduler(), T.AsyncStaleScheduler(), m + 1),
        "async+budget": (
            JBudgeted(JBudgetSpec(session_bits=async_budget)),
            TBudgeted(TBudgetSpec(session_bits=async_budget)),
            J.AsyncStaleScheduler(), T.AsyncStaleScheduler(), m + 1),
    }


def _rung_log(transport):
    """Record each controller step's rung."""
    rungs = []
    inner = transport._controller_rung

    def step(w_prev, w_out):
        rungs.append(int(inner(w_prev, w_out)))
        return rungs[-1]
    transport._controller_rung = step
    return rungs


def _run_pair(blob, name, rounds=ROUNDS):
    Xtr, ctr, _, _, k = blob
    m, n = len(Xtr), len(ctr)
    jt, tt, jsched, tsched, per_round = _pairs(n, m)[name]
    j_rungs = _rung_log(jt) if jt.controller is not None else []
    t_rungs = _rung_log(tt) if tt.controller is not None else []
    jhops, thops = _record(jt), _record(tt)
    key = jax.random.key(2)
    cfg = dict(num_classes=k, max_rounds=rounds)
    js = J.Protocol(J.SessionConfig(**cfg), scheduler=jsched,
                    transport=jt).start(
        key, J.endpoints_for(_jlearners(m), [jnp.asarray(x) for x in Xtr]),
        jnp.asarray(ctr))
    js.run()
    draws = ReplayDraws(key, m, per_round=per_round)
    ts = T.Protocol(T.SessionConfig(**cfg), scheduler=tsched, transport=tt,
                    device=CPU, draws=draws).start(
        2, T.endpoints_for(_tlearners(m), [torch.from_numpy(x) for x in Xtr]),
        torch.from_numpy(ctr))
    ts.run()
    draws.final_key = js.state.key
    return js, ts, (j_rungs, t_rungs), (jhops, thops)


@pytest.mark.parametrize("name", sorted(_pairs(210, 4)))
def test_control_session_matches_reference(blob, name):
    Xtr, ctr, Xte, _, k = blob
    js, ts, (j_rungs, t_rungs), (jhops, thops) = _run_pair(blob, name)
    assert t_rungs == j_rungs
    jc, tc = js.state.components, ts.state.components
    assert [(c.agent, c.round) for c in tc] == [(c.agent, c.round) for c in jc]
    assert (ts.state.round, ts.state.stopped) == (js.state.round,
                                                  js.state.stopped)
    assert ts.transport.log.entries == js.transport.log.entries
    np.testing.assert_allclose([c.alpha for c in tc], [c.alpha for c in jc],
                               rtol=1e-5)
    np.testing.assert_allclose(ts.state.w.numpy(), np.asarray(js.state.w),
                               rtol=0, atol=1e-6)
    jp = np.asarray(js.predict_distributed([jnp.asarray(x) for x in Xte]))
    tp = ts.predict_distributed([torch.from_numpy(x) for x in Xte]).numpy()
    np.testing.assert_array_equal(tp, jp)
    assert ts.transport.log.entries == js.transport.log.entries
    tt = ts.transport
    if tt.controller is not None:
        assert len(set(t_rungs)) > 1, t_rungs
        assert float(tt.ctrl_state) == pytest.approx(
            float(js.transport.ctrl_state), abs=1e-6)
    if tt.serve_controller is not None and not hasattr(tt, "budget"):
        # each block priced at its controller's rung (the same entries as
        # the reference's), not at raw float32
        blocks = [e["bits"] for e in tt.log.entries
                  if e["kind"] == "score_block"]
        assert len(blocks) == len(Xtr) - 1
        assert all(b < 32 * len(tp) * k for b in blocks), blocks
    if hasattr(tt, "budget"):
        assert (tt.skipped, tt.exhausted, tt.link_spent) == (
            js.transport.skipped, js.transport.exhausted,
            js.transport.link_spent)
    if name.startswith("budget-aware"):
        orders = {}
        for c in tc:
            orders.setdefault(c.round, []).append(c.agent)
        assert any(o != sorted(o) for o in orders.values()), orders
    if name.startswith("budget+"):
        # the walk went past the controller's floor, then skipped
        rungs = [e["rung"] for e in tt.log.entries if e["kind"] == "ignorance"]
        assert any(r > f for r, f in zip(rungs, t_rungs)), (rungs, t_rungs)
        assert tt.skipped
    if name.startswith("async"):
        assert all(not h["skipped"] for h in thops)     # no interchange hop
        senders = {e["src"] for e in tt.log.entries if e["kind"] == "ignorance"}
        assert senders == ({"barrier"} if tt.has_channel
                           else {f"agent{i}" for i in range(len(Xtr))})
    if name == "async+budget":
        assert tt.exhausted and ts.state.round < ROUNDS
    if name == "async+topk+dp":
        np.testing.assert_allclose(
            ts.state.codec_state["barrier"].numpy(),
            np.asarray(js.state.codec_state["barrier"]), rtol=0, atol=1e-6)
        assert tt.accountant.releases == js.transport.accountant.releases


def test_async_stop_and_controller_exclusion(blob):
    """The async round stops when no alpha is positive, as the reference's;
    a controller on the async path is refused, as there."""
    Xtr, ctr, _, _, k = blob
    with pytest.raises(ValueError):
        T.Protocol(T.SessionConfig(num_classes=k),
                   scheduler=T.AsyncStaleScheduler(),
                   transport=T.MeteredTransport(
                       controller=tadaptive.AdaptiveController()),
                   device=CPU).start(
            2, T.endpoints_for(_tlearners(len(Xtr)),
                               [torch.from_numpy(x) for x in Xtr]),
            torch.from_numpy(ctr))

    class Contrary(TLearner):
        """Predicts the next class of every training row's label."""
        device = CPU

        def fit(self, key, X, classes, w, num_classes):
            return {"c": (classes + 1) % num_classes}

        def predict(self, params, X):
            return params["c"]

    session = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=3),
                         scheduler=T.AsyncStaleScheduler(),
                         device=CPU).start(
        2, T.endpoints_for([Contrary() for _ in Xtr],
                           [torch.from_numpy(x) for x in Xtr]),
        torch.from_numpy(ctr))                      # every fit scores 0
    w0 = session.state.w.clone()
    session.run()
    assert session.state.stopped and not session.state.components
    assert all(a <= 0 for a in session.state.history[0]["alphas"])
    assert torch.equal(session.state.w, w0)


# ============================================================ pause / resume
RESUME = {
    "controller+budget": lambda n, m: (
        TBudgeted(TBudgetSpec(session_bits=(m - 1) * 2 * n * 32
                              + 14 * (n * 32 + 32)),
                  controller=tadaptive.AdaptiveController(stat="entropy")),
        None),
    "resid+serve": lambda n, m: (
        T.MeteredTransport(controller=tadaptive.AdaptiveController(),
                           serve_controller=tadaptive.ServeController()),
        None),
    "budget-aware": lambda n, m: (
        T.MeteredTransport(), tscheduler.BudgetAwareScheduler()),
    "budget-aware+links": lambda n, m: (
        TBudgeted(TBudgetSpec(link_bits=3 * (n * 32 + 32))),
        tscheduler.BudgetAwareScheduler()),
    "async+topk+dp": lambda n, m: (
        T.MeteredTransport(codec=tcodecs.TopKCodec(),
                           privacy=TMech(epsilon=1.0)),
        T.AsyncStaleScheduler()),
}


@pytest.mark.parametrize("name", sorted(RESUME))
def test_pause_and_resume_bit_exact(blob, tmp_path, name):
    Xtr, ctr, Xte, _, k = blob
    m, n = len(Xtr), len(ctr)

    def session(resume=False):
        transport, scheduler = RESUME[name](n, m)
        proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=5),
                           scheduler=scheduler, transport=transport,
                           device=CPU)
        eps = T.endpoints_for(_tlearners(m), [torch.from_numpy(x)
                                              for x in Xtr])
        if resume:
            return proto.resume(str(tmp_path), eps, torch.from_numpy(ctr))
        return proto.start(2, eps, torch.from_numpy(ctr))

    full = session()
    full.run()
    part = session()
    part.step()
    part.step()
    part.checkpoint(str(tmp_path))
    paused_bits = part.transport.total_bits
    resumed = session(resume=True)
    assert resumed.state.round == 2
    if resumed.transport.controller is not None:
        assert resumed.transport.ctrl_state == part.transport.ctrl_state
    resumed.run()
    assert torch.equal(resumed.state.w, full.state.w)
    assert [(c.agent, c.round, c.alpha) for c in resumed.state.components] \
        == [(c.agent, c.round, c.alpha) for c in full.state.components]
    assert resumed.state.history == full.state.history
    ft, rt = full.transport, resumed.transport
    assert paused_bits + rt.total_bits == ft.total_bits
    assert rt.log.entries == ft.log.entries[len(ft.log.entries)
                                            - len(rt.log.entries):]
    if ft.controller is not None:
        assert rt.ctrl_state == ft.ctrl_state
    if name == "async+topk+dp":
        assert torch.equal(resumed.state.codec_state["barrier"],
                           full.state.codec_state["barrier"])
        assert rt.accountant.releases == ft.accountant.releases
    Xte_t = [torch.from_numpy(x) for x in Xte]
    assert torch.equal(resumed.predict_distributed(Xte_t),
                       full.predict_distributed(Xte_t))


# ====================================================================== CLI
def _cli(args, capsys):
    out = cli.run(cli.parser().parse_args(["--device", CPU, "--n", "300",
                                           "--rounds", "3", *args]))
    return out, capsys.readouterr().out.splitlines()


def test_cli_runs_the_control_plane(capsys):
    run, lines = _cli(["--controller", "entropy", "--serve-controller",
                       "margin"], capsys)
    t = run.transport
    assert [x for x in lines if x.startswith("controller: ")] == [
        f"controller: stat=entropy,rungs=4,ema={float(t.ctrl_state):.4f}"]
    assert "serve_controller: stat=margin,rungs=4" in lines
    run, lines = _cli(["--scheduler", "budget-aware", "--byte-budget",
                       "20000"], capsys)
    assert isinstance(run.session.scheduler, tscheduler.BudgetAwareScheduler)
    assert any(x.startswith("budget: ") for x in lines)
    run, lines = _cli(["--variant", "async", "--codec", "int8"], capsys)
    assert run.session.scheduler.stale
    assert {e["src"] for e in t.log.entries} >= {"agent0"}
    assert {e["src"] for e in run.transport.log.entries
            if e["kind"] == "ignorance"} == {"barrier"}
    run, lines = _cli(["--learner", "mlp", "--steps", "20"], capsys)
    assert run.session.endpoints[0].learner.hidden == (32, 16)
    assert lines[0].startswith("blob3,ascii,metered,rounds=")


@pytest.mark.parametrize("bad", [
    ["--variant", "async", "--controller", "resid"],
    ["--controller", "resid", "--codec", "int8"],
    ["--serve-controller", "margin", "--serve-codec", "int8"],
    ["--scheduler", "budget-aware", "--variant", "random"],
    ["--scheduler", "budget-aware", "--variant", "async"],
])
def test_cli_applies_the_reference_control_rules(bad, capsys):
    with pytest.raises(SystemExit):
        _cli(bad, capsys)


def test_cli_pauses_and_resumes_the_control_plane(tmp_path, capsys):
    base = ["--controller", "resid", "--scheduler", "budget-aware",
            "--byte-budget", "30000"]
    full, _ = _cli(base, capsys)
    ckpt = ["--ckpt-dir", str(tmp_path)]
    paused, _ = _cli(base + ckpt + ["--stop-after", "2"], capsys)
    assert paused.paused
    resumed, _ = _cli(base + ckpt + ["--resume"], capsys)
    assert torch.equal(resumed.session.state.w, full.session.state.w)
    assert resumed.transport.ctrl_state == full.transport.ctrl_state
    with pytest.raises(SystemExit):         # another controller: a mismatch
        _cli(["--controller", "l2", "--scheduler", "budget-aware",
              "--byte-budget", "30000"] + ckpt + ["--resume"], capsys)


# ================================================================ the card
@pytest.mark.gpu
def test_control_plane_on_card_equals_cpu(blob):
    """A resid controller with a margin serve controller, the budget-aware
    scheduler under a budget and the async variant with int8, each on the
    card and on the CPU with the default draws: the rungs, the ledger, the
    components and the final w the same (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Xtr, ctr, Xte, _, k = blob
    m, n = len(Xtr), len(ctr)
    bits = (m - 1) * 2 * n * 32 + 7 * (n * 32 + 32)
    configs = {
        "resid+margin": lambda: (T.MeteredTransport(
            controller=tadaptive.AdaptiveController(),
            serve_controller=tadaptive.ServeController()), None),
        "budget-aware": lambda: (TBudgeted(TBudgetSpec(session_bits=bits)),
                                 tscheduler.BudgetAwareScheduler()),
        "async+int8": lambda: (T.MeteredTransport(
            codec=tcodecs.QuantCodec(bits=8)), T.AsyncStaleScheduler()),
    }
    for name, make in configs.items():
        out = {}
        for dev in ("cuda", CPU):
            transport, scheduler = make()
            rungs = _rung_log(transport) if transport.controller else []
            s = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=ROUNDS),
                           scheduler=scheduler, transport=transport,
                           device=dev).start(
                2, T.endpoints_for(
                    [TTree(depth=3, num_thresholds=8, device=dev)
                     for _ in Xtr],
                    [torch.from_numpy(x).to(dev) for x in Xtr]),
                torch.from_numpy(ctr).to(dev))
            s.run()
            served = s.predict_distributed([torch.from_numpy(x).to(dev)
                                            for x in Xte]).cpu()
            out[dev] = (rungs, transport.log.entries,
                        [(c.agent, c.round) for c in s.state.components],
                        s.state.w.cpu(), served)
        g, c = out["cuda"], out[CPU]
        assert g[:3] == c[:3], name
        assert torch.equal(g[3], c[3]) and torch.equal(g[4], c[4]), name
