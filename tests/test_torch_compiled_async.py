"""The port's compiled async-stale lowering (``repro_torch.core.compiled``:
``async_session``, ``fitted_from_async_result``; ``Protocol(backend=
"compiled")`` with ``AsyncStaleScheduler``) against the port's eager
async path and the JAX package's eager one, on the reference's blob
fixture (n = 240) and its five async channels
(tests/test_comm_engine.py's ``ASYNC_CHANNELS``: plain, int8, DP, a
budget, a tight budget).

Port compiled = port eager on the CPU, bit for bit, with the default draw
source: components and alphas, history, w, every ledger entry, link spend,
skips, exhaustion, DP releases and both predictions.  Against the
reference's eager run on the same arrays and its draws replayed
(``ReplayDraws`` with M + 1 keys a round under a channel: the barrier's
split): integers exact (components, ledger, skips), alphas within rtol
1e-5 and w within atol 1e-6 (ROADMAP Queue 3: the port's fits and
updates are within float32 rounding of the reference's).

Then the program's structure: no host read inside it, one unnormalized
ignorance call a (round, agent) and one quantize a round and int rung,
the result's fields; the session CLI's ``--variant async --backend
compiled`` line; the live round taps (live = dark, the live series = the
replay-booked ones = the eager run's = the reference's).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import BudgetedTransport as JBudgeted
from repro.comm import BudgetSpec as JBudgetSpec
from repro.comm import codecs as jcodecs
from repro.comm.privacy import GaussianMechanism as JMech
from repro.core import engine as J
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.learners.logistic import LogisticRegression as JLogistic
from repro.telemetry import Telemetry as JTelemetry
from repro_torch.comm import BudgetedTransport as TBudgeted
from repro_torch.comm import BudgetSpec as TBudgetSpec
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.privacy import GaussianMechanism as TMech
from repro_torch.control.adaptive import AdaptiveController
from repro_torch.core import compiled as TC
from repro_torch.core import engine as T
from repro_torch.kernels import ignorance as tig
from repro_torch.kernels import quantize as tq
from repro_torch.launch import session as cli
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from repro_torch.telemetry import Telemetry
from test_torch_comm_session import ReplayDraws

CPU = "cpu"
ROUNDS = 4
KEY = 11


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


def _ladders():
    return ((jcodecs.QuantCodec(bits=8), jcodecs.QuantCodec(bits=4)),
            (tcodecs.QuantCodec(bits=8), tcodecs.QuantCodec(bits=4)))


# name -> (reference transport, port transport): the reference's
# ASYNC_CHANNELS; "budget-tight" runs dry at the first release
ASYNC_CHANNELS = {
    "plain": lambda: (J.MeteredTransport(), T.MeteredTransport()),
    "codec": lambda: (J.MeteredTransport(codec=jcodecs.QuantCodec(8)),
                      T.MeteredTransport(codec=tcodecs.QuantCodec(8))),
    "dp": lambda: (J.MeteredTransport(privacy=JMech(epsilon=2.0, clip=0.1)),
                   T.MeteredTransport(privacy=TMech(epsilon=2.0, clip=0.1))),
    "budget": lambda: (
        JBudgeted(JBudgetSpec(session_bits=40_000, ladder=_ladders()[0])),
        TBudgeted(TBudgetSpec(session_bits=40_000, ladder=_ladders()[1]))),
    "budget-tight": lambda: (
        JBudgeted(JBudgetSpec(session_bits=12_000, ladder=_ladders()[0])),
        TBudgeted(TBudgetSpec(session_bits=12_000, ladder=_ladders()[1]))),
}


def _port(blob, name, backend, draws=None, telemetry=None):
    Xtr, ctr, _, _, k = blob
    transport = ASYNC_CHANNELS[name]()[1]
    proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=ROUNDS),
                       scheduler=T.AsyncStaleScheduler(),
                       transport=transport, backend=backend, device=CPU,
                       draws=draws, telemetry=telemetry)
    fitted = proto.fit(KEY, T.endpoints_for(
        [TLogistic(steps=40, device=CPU) for _ in Xtr], _t(Xtr)),
        torch.from_numpy(ctr))
    return proto, fitted


def _reference(blob, name, telemetry=None):
    Xtr, ctr, _, _, k = blob
    transport = ASYNC_CHANNELS[name]()[0]
    proto = J.Protocol(J.SessionConfig(num_classes=k, max_rounds=ROUNDS),
                       scheduler=J.AsyncStaleScheduler(),
                       transport=transport, telemetry=telemetry)
    fitted = proto.fit(jax.random.key(KEY), J.endpoints_for(
        [JLogistic(steps=40) for _ in Xtr], _j(Xtr)), jnp.asarray(ctr))
    return proto, fitted


def _replay(blob, name):
    """The reference's draws: an async round splits its key once an agent
    and, under a channel, once more for the barrier."""
    m = len(blob[0])
    channel = ASYNC_CHANNELS[name]()[1].has_channel
    return ReplayDraws(jax.random.key(KEY), m,
                       per_round=m + 1 if channel else m)


def _w(proto):
    return proto._session.state.w


# ================================================ port compiled = port eager
@pytest.mark.parametrize("name", sorted(ASYNC_CHANNELS))
def test_async_compiled_equals_port_eager(blob, name):
    (ep, ef), (cp, cf) = (_port(blob, name, b) for b in ("eager",
                                                         "compiled"))
    assert [(c.agent, c.round, c.alpha) for c in cf.components] == \
        [(c.agent, c.round, c.alpha) for c in ef.components]
    assert cf.history == ef.history
    assert torch.equal(_w(cp), _w(ep))
    assert torch.equal(cp._compiled_result.w, _w(ep))
    et, ct = ep.transport, cp.transport
    assert ct.log.entries == et.log.entries
    if hasattr(et, "budget"):
        assert (ct.skipped, ct.exhausted, ct.link_spent) == \
            (et.skipped, et.exhausted, et.link_spent)
    if et.accountant is not None:
        assert ct.accountant.releases == et.accountant.releases
    Xte = _t(blob[2])
    assert torch.equal(cf.predict(Xte), ef.predict(Xte))
    assert torch.equal(cp.predict_distributed(Xte),
                       ep.predict_distributed(Xte))
    assert ct.log.entries == et.log.entries      # the serve ledger too
    res = cp._compiled_result
    if name == "budget-tight":
        assert ct.exhausted and not bool(res.sent.any())
    if name == "budget":
        # a release or more, then the walk runs dry mid-session
        assert ct.exhausted and bool(res.sent.any()) and ct.skipped


# ================================================== against the reference
@pytest.mark.parametrize("backend", ["eager", "compiled"])
@pytest.mark.parametrize("name", sorted(ASYNC_CHANNELS))
def test_async_matches_reference_eager(blob, name, backend):
    jproto, jfit = _reference(blob, name)
    draws = _replay(blob, name)
    tproto, tfit = _port(blob, name, backend, draws=draws)
    draws.final_key = jproto._session.state.key
    assert [(c.agent, c.round) for c in tfit.components] == \
        [(c.agent, c.round) for c in jfit.components]
    assert [len(h["alphas"]) for h in tfit.history] == \
        [len(h["alphas"]) for h in jfit.history]
    np.testing.assert_allclose([c.alpha for c in tfit.components],
                               [c.alpha for c in jfit.components], rtol=1e-5)
    np.testing.assert_allclose(_w(tproto).numpy(),
                               np.asarray(jproto._session.state.w), rtol=0,
                               atol=1e-6)
    Xte = blob[2]
    np.testing.assert_array_equal(tfit.predict(_t(Xte)).numpy(),
                                  np.asarray(jfit.predict(_j(Xte))))
    jt, tt = jproto.transport, tproto.transport
    assert tt.log.entries == jt.log.entries
    if hasattr(jt, "budget"):
        assert (tt.skipped, tt.exhausted, tt.link_spent) == \
            (jt.skipped, jt.exhausted, jt.link_spent)
    if jt.accountant is not None:
        assert tt.accountant.releases == jt.accountant.releases
    np.testing.assert_array_equal(
        tproto.predict_distributed(_t(Xte)).numpy(),
        np.asarray(jproto.predict_distributed(_j(Xte))))
    assert tt.log.entries == jt.log.entries


# ============================================================ the program
def _plan(blob, **channel):
    Xtr, _, _, _, k = blob
    return TC.plan_for([TLogistic(steps=20, device=CPU) for _ in Xtr], k,
                       max_rounds=ROUNDS, scheduler=TC.AsyncStalePlan(),
                       **channel)


def test_fitted_from_async_result_is_the_eager_fit(blob):
    """``async_session`` + ``fitted_from_async_result`` give the eager
    session's fitted ensemble; the result's fields are agent-major, the
    executed rows whole, valid the positive alphas of executed rounds, and
    each released round's w_bar the score the next round reads."""
    Xtr, ctr, Xte, _, k = blob
    plan = _plan(blob, codec=tcodecs.QuantCodec(8))
    res = TC.async_session(plan, KEY, _t(Xtr), torch.from_numpy(ctr))
    learners = [TLogistic(steps=20, device=CPU) for _ in Xtr]
    fitted = TC.fitted_from_async_result(plan, res, learners)
    proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=ROUNDS),
                       scheduler=T.AsyncStaleScheduler(),
                       transport=T.MeteredTransport(
                           codec=tcodecs.QuantCodec(8)), device=CPU)
    eager = proto.fit(KEY, T.endpoints_for(learners, _t(Xtr)),
                      torch.from_numpy(ctr))
    assert [(c.agent, c.round, c.alpha) for c in fitted.components] == \
        [(c.agent, c.round, c.alpha) for c in eager.components]
    assert fitted.history == eager.history
    assert torch.equal(fitted.predict(_t(Xte)), eager.predict(_t(Xte)))
    m = len(Xtr)
    assert tuple(res.alphas.shape) == (ROUNDS, m)
    assert tuple(res.w_trace.shape) == (ROUNDS, m, len(ctr))
    assert tuple(res.w_bar.shape) == (ROUNDS, len(ctr))
    ex = res.executed
    assert torch.equal(ex.all(1), ex.any(1))
    assert torch.equal(res.valid, ex & (res.alphas > 0))
    assert torch.equal(res.codec_idx, torch.where(res.sent, 0, -1))
    rounds = int(ex.any(1).sum())
    assert torch.equal(res.w, res.w_bar[rounds - 1])


def test_round_with_no_positive_alpha_normalizes_as_eager(blob):
    """A round whose alphas are all <= 0 merges nothing: the compiled
    barrier normalizes the score with its own tile sums, as the eager
    ``partials=None``, and the session stops there (alpha_cap 0 makes
    every alpha 0)."""
    Xtr, ctr, _, _, k = blob
    out = {}
    for backend in ("eager", "compiled"):
        proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=3,
                                           alpha_cap=0.0),
                           scheduler=T.AsyncStaleScheduler(),
                           transport=T.MeteredTransport(), backend=backend,
                           device=CPU)
        fit = proto.fit(3, T.endpoints_for(
            [TLogistic(steps=10, device=CPU) for _ in Xtr], _t(Xtr)),
            torch.from_numpy(ctr))
        out[backend] = (fit, _w(proto), proto.transport.log.entries)
    (ef, ew, el), (cf, cw, cl) = out["eager"], out["compiled"]
    assert len(ef.history) == 1 and not ef.components
    assert cf.history == ef.history and not cf.components
    assert torch.equal(cw, ew) and cl == el


def test_async_session_reads_nothing_back_to_the_host(blob, monkeypatch):
    """No tensor is read to the host inside the async program (on the
    card, chip_smoke phase 18(a) runs it under
    torch.cuda.set_sync_debug_mode("error"))."""
    Xtr, ctr, _, _, k = blob
    plan = _plan(blob, budget=TBudgetSpec(session_bits=40_000,
                                          ladder=_ladders()[1]),
                 privacy=TMech(epsilon=2.0))
    shapes = tuple(tuple(x.shape[1:]) for x in Xtr)
    fn = TC.make_async_session_fn(plan, shapes, live=False)
    draws = TC._draws_for(plan, T.key_data(1), len(ctr), shapes, CPU, None,
                          fleet=False)

    def refuse(*a, **kw):
        raise AssertionError("a host read inside the async program")
    for name in ("item", "tolist", "numpy", "nonzero", "__bool__",
                 "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    res = fn(draws, tuple(_t(Xtr)), torch.from_numpy(ctr))
    monkeypatch.undo()
    assert res.executed.any()


def test_async_program_calls_each_kernel_every_slot(blob, monkeypatch):
    """Every (round, agent) runs the unnormalized update (the stop and a
    non-positive alpha are masks) and every round each int rung's
    quantize of the release, whatever ran."""
    Xtr, ctr, _, _, k = blob
    calls = {"merge": 0, "quantize": 0}
    merge, quantize = tig.ignorance_update_unnormalized, \
        tq.quantize_dequant_tiles

    def counted_merge(*a):
        calls["merge"] += 1
        return merge(*a)

    def counted_quantize(*a, **kw):
        calls["quantize"] += 1
        return quantize(*a, **kw)
    monkeypatch.setattr(tig, "ignorance_update_unnormalized", counted_merge)
    monkeypatch.setattr(tq, "quantize_dequant_tiles", counted_quantize)
    plan = _plan(blob, budget=TBudgetSpec(session_bits=12_000,
                                          ladder=_ladders()[1]))
    res = TC.async_session(plan, 0, _t(Xtr), torch.from_numpy(ctr))
    assert not bool(res.executed[1:].any())          # dry at round 0
    assert calls == {"merge": ROUNDS * len(Xtr), "quantize": ROUNDS * 2}


def test_async_lowering_rules(blob):
    Xtr, ctr, _, _, k = blob
    shapes = tuple(tuple(x.shape[1:]) for x in Xtr)
    with pytest.raises(ValueError, match="adaptive controllers"):
        TC.make_async_session_fn(
            _plan(blob, controller=AdaptiveController()), shapes)
    with pytest.raises(ValueError, match="async_session"):
        TC.make_session_fn(_plan(blob), shapes)
    with pytest.raises(ValueError, match="AsyncStalePlan"):
        TC.async_session(replace(_plan(blob), scheduler=None), 0, _t(Xtr),
                         torch.from_numpy(ctr))
    with pytest.raises(ValueError, match="int32"):
        TC.make_async_session_fn(
            _plan(blob, budget=TBudgetSpec(session_bits=2 ** 31)), shapes)


# ======================================================================= CLI
@pytest.mark.parametrize("argv", [[], ["--codec", "int8"],
                                  ["--dp-epsilon", "1"],
                                  ["--byte-budget", "6000"]])
def test_cli_async_compiled_line_equals_eager(argv, capsys):
    base = ["--device", CPU, "--learner", "logistic", "--steps", "20",
            "--n", "300", "--rounds", "3", "--variant", "async", *argv]
    eager = cli.run(cli.parser().parse_args(base))
    out_eager = capsys.readouterr().out
    comp = cli.run(cli.parser().parse_args(base + ["--backend", "compiled"]))
    out_comp = capsys.readouterr().out
    assert comp.line == eager.line
    assert out_comp == out_eager
    if argv[:1] == ["--byte-budget"]:
        assert "exhausted=True" in out_comp      # it ran dry mid-session


# ================================================================ live taps
def _live_series(reg) -> dict:
    return {name: reg.series(name) for name in reg.counter_names()
            if name.startswith("live_")}


@pytest.mark.parametrize("name", ["plain", "budget"])
def test_async_live_taps(blob, name):
    """The compiled async program's round taps: live = dark bit for bit,
    the live series = the replay-booked counters = the eager run's live
    series = the reference's eager run's."""
    jtele = JTelemetry(live=True)
    _reference(blob, name, telemetry=jtele)
    series = {}
    for backend in ("eager", "compiled"):
        tele = Telemetry(live=True)
        lit, lfit = _port(blob, name, backend, draws=_replay(blob, name),
                          telemetry=tele)
        reg = tele.registry
        assert reg.total("live_wire_bits_total") == \
            reg.total("wire_bits_total")
        assert reg.value("live_messages_total", kind="ignorance") == \
            reg.value("messages_total", kind="ignorance")
        assert reg.total("live_budget_skips_total") == \
            reg.total("budget_skips_total")
        series[backend] = _live_series(reg)
        if backend == "compiled":
            dark, dfit = _port(blob, name, backend, draws=_replay(blob, name))
            assert torch.equal(_w(lit), _w(dark))
            assert lit.transport.log.entries == dark.transport.log.entries
            assert [c.alpha for c in lfit.components] == \
                [c.alpha for c in dfit.components]
    assert series["compiled"] == series["eager"]
    assert series["compiled"]["live_rounds_total"]
    assert series["compiled"] == _live_series(jtele.registry)
