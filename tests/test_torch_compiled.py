"""The port's compiled backend (``repro_torch.core.compiled``:
``compiled_session``, ``fleet_run``, ``Protocol(backend="compiled")``)
against the JAX package's, on the reference's own blob fixture (n = 240),
with the reference's draws replayed (``ReplayDraws``,
tests/test_torch_comm_session.py): every hop's channel draws and every
fit's draws come from the reference's split of its session key.

Exact: the components (agent, round), the history's shape, the stop
round, the ledger (every entry), the budget's rungs, skips and
exhaustion, the DP releases, the controller's rungs, the budget-aware
round orders and the predictions.  Within a tolerance: the alphas (rtol
1e-5) and the ignorance vector (atol 1e-6), the tolerances of
tests/test_torch_session.py: the port's fits and updates are within
float32 rounding of the reference's, not equal to them.

Where the reference's compiled path disagrees with its own eager path
(``exact_reweight`` and the alpha <= 0 stop: tests/test_compiled.py,
ROADMAP Queue 3), the port's compiled path is held to the eager
reference.

The port's compiled path is also held to the port's eager path on the CPU
bit for bit (w, alphas, ledgers, predictions).  The fleets (``fleet_run``)
are held in tests/test_torch_compiled_fleet.py, on this file's fixture.
"""
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import BudgetedTransport as JBudgeted
from repro.comm import BudgetSpec as JBudgetSpec
from repro.comm import codecs as jcodecs
from repro.comm.privacy import GaussianMechanism as JMech
from repro.control.accounting import RDPAccountant as JRDP
from repro.control.adaptive import AdaptiveController as JController
from repro.control.adaptive import ServeController as JServeController
from repro.control.scheduler import BudgetAwareScheduler as JBudgetAware
from repro.configs.registry import ARCHS as JARCHS
from repro.core import compiled as JC
from repro.core import engine as J
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.learners.logistic import LogisticRegression as JLogistic
from repro.learners.mlp import MLP as JMLP
from repro.learners.neural import NeuralBackbone as JNeural
from repro_torch.comm import BudgetedTransport as TBudgeted
from repro_torch.comm import BudgetSpec as TBudgetSpec
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.privacy import GaussianMechanism as TMech
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.control.accounting import RDPAccountant as TRDP
from repro_torch.control.adaptive import AdaptiveController as TController
from repro_torch.control.adaptive import ServeController as TServeController
from repro_torch.control.scheduler import BudgetAwareScheduler as TBudgetAware
from repro_torch.convert import neural_params_from_numpy
from repro_torch.core import compiled as TC
from repro_torch.core import engine as T
from repro_torch.launch import session as cli
from repro_torch.learners.base import Learner as TLearner
from repro_torch.learners.base import LearnerCore as TLearnerCore
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from repro_torch.learners.mlp import MLP as TMLP
from repro_torch.learners.neural import NeuralBackbone as TNeural
from repro_torch.learners.neural import NeuralCore as TNeuralCore
from repro_torch.learners.tree import DecisionTree as TTree
from test_torch_comm_session import ReplayDraws

CPU = "cpu"
ROUNDS = 3
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


LEARNERS = {
    "logistic": (lambda: JLogistic(steps=60),
                 lambda: TLogistic(steps=60, device=CPU)),
    "mlp": (lambda: JMLP(hidden=(16,), steps=40),
            lambda: TMLP(hidden=(16,), steps=40, device=CPU)),
}


def _budget_bits(n, agents, rungs=(0, 0, 1, 2, 3)):
    """A session cap that setup plus one hop at each listed rung exhausts
    (100 bits to spare): the run degrades down the ladder, then skips and
    stops."""
    spec = JBudgetSpec()
    return (agents - 1) * 2 * n * 32 + sum(spec.hop_costs(n)[r]
                                           for r in rungs) + 100


# name -> (reference transport, port transport, reference scheduler, port
# scheduler), each built for n rows and m agents
CHANNELS = {
    "fp32": lambda n, m: (J.MeteredTransport(), T.MeteredTransport(),
                          None, None),
    "int8": lambda n, m: (J.MeteredTransport(codec=jcodecs.QuantCodec(8)),
                          T.MeteredTransport(codec=tcodecs.QuantCodec(8)),
                          None, None),
    "int4+int8serve": lambda n, m: (
        J.MeteredTransport(codec=jcodecs.QuantCodec(4),
                           serve_codec=jcodecs.QuantCodec(8)),
        T.MeteredTransport(codec=tcodecs.QuantCodec(4),
                           serve_codec=tcodecs.QuantCodec(8)), None, None),
    "topk": lambda n, m: (J.MeteredTransport(codec=jcodecs.TopKCodec()),
                          T.MeteredTransport(codec=tcodecs.TopKCodec()),
                          None, None),
    "dp-rdp": lambda n, m: (
        J.MeteredTransport(privacy=JMech(epsilon=10.0), accountant=JRDP()),
        T.MeteredTransport(privacy=TMech(epsilon=10.0), accountant=TRDP()),
        None, None),
    "budget": lambda n, m: (
        JBudgeted(JBudgetSpec(session_bits=_budget_bits(n, m))),
        TBudgeted(TBudgetSpec(session_bits=_budget_bits(n, m))),
        None, None),
    "controller-resid": lambda n, m: (
        J.MeteredTransport(controller=JController(stat="resid")),
        T.MeteredTransport(controller=TController(stat="resid")),
        None, None),
    "controller-entropy": lambda n, m: (
        J.MeteredTransport(controller=JController(stat="entropy"),
                           serve_controller=JServeController()),
        T.MeteredTransport(controller=TController(stat="entropy"),
                           serve_controller=TServeController()),
        None, None),
    "budget-aware": lambda n, m: (
        JBudgeted(JBudgetSpec(session_bits=_budget_bits(
            n, m, (0, 0, 0, 1, 1, 2, 2, 3)))),
        TBudgeted(TBudgetSpec(session_bits=_budget_bits(
            n, m, (0, 0, 0, 1, 1, 2, 2, 3)))),
        JBudgetAware(), TBudgetAware()),
    "budget-aware-metered": lambda n, m: (
        J.MeteredTransport(codec=jcodecs.QuantCodec(8)),
        T.MeteredTransport(codec=tcodecs.QuantCodec(8)),
        JBudgetAware(), TBudgetAware()),
}


def _reference(blob, jlearners, channel, backend="compiled", rounds=ROUNDS,
               **cfg):
    Xtr, ctr, _, _, k = blob
    jt, _, jsched, _ = CHANNELS[channel](len(ctr), len(Xtr))
    proto = J.Protocol(J.SessionConfig(num_classes=k, max_rounds=rounds,
                                       **cfg),
                       scheduler=jsched, transport=jt, backend=backend)
    fitted = proto.fit(jax.random.key(KEY),
                       J.endpoints_for(jlearners, _j(Xtr)), jnp.asarray(ctr))
    return proto, fitted


def _port(blob, tlearners, channel, backend="compiled", rounds=ROUNDS,
          draws="replay", **cfg):
    Xtr, ctr, _, _, k = blob
    _, tt, _, tsched = CHANNELS[channel](len(ctr), len(Xtr))
    source = (ReplayDraws(jax.random.key(KEY), len(Xtr))
              if draws == "replay" else None)
    proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=rounds,
                                       **cfg),
                       scheduler=tsched, transport=tt, backend=backend,
                       device=CPU, draws=source)
    fitted = proto.fit(KEY, T.endpoints_for(tlearners, _t(Xtr)),
                       torch.from_numpy(ctr))
    if isinstance(source, ReplayDraws):
        source.final_key = jax.random.key(KEY)   # serve draws: any key
    return proto, fitted


def _final_w(proto):
    if getattr(proto, "_compiled_ctx", None) is not None:      # reference
        return np.asarray(proto._compiled_ctx[2].w)
    if getattr(proto, "_compiled_result", None) is not None:   # port
        return proto._compiled_result.w.numpy()
    st = proto._session.state
    return np.asarray(st.w) if not isinstance(st.w, torch.Tensor) \
        else st.w.numpy()


def _assert_match(blob, jproto, jfit, tproto, tfit):
    Xte = blob[2]
    assert [(c.agent, c.round) for c in tfit.components] == \
        [(c.agent, c.round) for c in jfit.components]
    assert [len(h["alphas"]) for h in tfit.history] == \
        [len(h["alphas"]) for h in jfit.history]
    np.testing.assert_allclose([c.alpha for c in tfit.components],
                               [c.alpha for c in jfit.components], rtol=1e-5)
    np.testing.assert_allclose(_final_w(tproto), _final_w(jproto), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(
        tfit.predict(_t(Xte)).numpy(), np.asarray(jfit.predict(_j(Xte))))
    jt, tt = jproto.transport, tproto.transport
    if isinstance(jt, J.MeteredTransport):
        assert tt.log.entries == jt.log.entries
    if hasattr(jt, "budget"):
        assert (tt.skipped, tt.exhausted) == (jt.skipped, jt.exhausted)
    if jt.accountant is not None:
        assert tt.accountant.releases == jt.accountant.releases


# ============================================ the reference's compiled path
@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_compiled_matches_reference_compiled(blob, name):
    jl, tl = LEARNERS[name]
    jproto, jfit = _reference(blob, [jl() for _ in blob[0]], "fp32")
    tproto, tfit = _port(blob, [tl() for _ in blob[0]], "fp32")
    _assert_match(blob, jproto, jfit, tproto, tfit)


@pytest.mark.parametrize("channel", [c for c in sorted(CHANNELS)
                                     if c != "fp32"])
def test_compiled_channel_matches_reference_compiled(blob, channel):
    """The wire channel, the budget, both controllers and budget-aware
    scheduling inside the program, with the ledger replayed."""
    m = len(blob[0])
    jproto, jfit = _reference(blob, [JLogistic(steps=60)] * m, channel)
    tproto, tfit = _port(blob, [TLogistic(steps=60, device=CPU)] * m,
                         channel)
    _assert_match(blob, jproto, jfit, tproto, tfit)
    jres, tres = jproto._compiled_ctx[2], tproto._compiled_result
    if channel.startswith(("budget", "controller")):
        # the rung of every hop (-1: not sent), agent-major on both sides
        got = TC.agent_major_result(tres)
        np.testing.assert_array_equal(got.codec_idx.numpy(),
                                      np.asarray(jres.codec_idx))
        np.testing.assert_array_equal(got.sent.numpy(), np.asarray(jres.sent))
    if channel == "budget-aware":
        orders = [[c.agent for c in tfit.components if c.round == t]
                  for t in range(len(tfit.history))]
        assert any(o != sorted(o) for o in orders), orders   # it permuted
    if channel == "budget":
        assert tproto.transport.exhausted
        assert len({e["rung"] for e in tproto.transport.log.entries
                    if "rung" in e}) >= 3


def test_compiled_mlp_int8_matches_reference_compiled(blob):
    m = len(blob[0])
    jproto, jfit = _reference(blob, [JMLP(hidden=(16,), steps=40)] * m,
                              "int8")
    tproto, tfit = _port(blob, [TMLP(hidden=(16,), steps=40, device=CPU)] * m,
                         "int8")
    _assert_match(blob, jproto, jfit, tproto, tfit)


def test_compiled_simple_variant_matches_reference(blob):
    """upstream=False (ASCII-Simple's alphas)."""
    m = len(blob[0])
    jproto, jfit = _reference(blob, [JLogistic(steps=60)] * m, "fp32",
                              upstream=False)
    tproto, tfit = _port(blob, [TLogistic(steps=60, device=CPU)] * m, "fp32",
                         upstream=False)
    _assert_match(blob, jproto, jfit, tproto, tfit)


def _narrow():
    return JARCHS["qwen3-0.6b"].reduced(), TARCHS["qwen3-0.6b"].reduced()


def test_compiled_neural_backbone_matches_reference_compiled(blob,
                                                             monkeypatch):
    """A two-layer narrow backbone: the port's fits start from the
    reference's init of each slot (its key, carried across: the port's
    init draws are its own), then run inside the port's program."""
    jcfg, tcfg = _narrow()
    assert jcfg.num_layers == 2
    k = blob[4]
    jcore = JNeural(cfg=jcfg, steps=3).core(k)

    def draw(self, key, shapes, n):
        init = jcore.init(key.sub, shapes)
        return {"init": neural_params_from_numpy(
            tcfg, jax.tree.map(np.asarray, init), device=CPU)}
    monkeypatch.setattr(TNeuralCore, "draw", draw)
    m = 2
    Xtr = blob[0][:m]
    small = (Xtr, blob[1], blob[2][:m], blob[3], k)
    jproto, jfit = _reference(small, [JNeural(cfg=jcfg, steps=3)] * m,
                              "fp32", rounds=2)
    tproto, tfit = _port(small, [TNeural(cfg=tcfg, steps=3, device=CPU)] * m,
                         "fp32", rounds=2)
    _assert_match(small, jproto, jfit, tproto, tfit)


# ======================== where the reference's compiled path is not eager
def test_compiled_exact_reweight_matches_eager_reference(blob):
    m = len(blob[0])
    jproto, jfit = _reference(blob, [JLogistic(steps=60)] * m, "fp32",
                              backend="eager", exact_reweight=True)
    tproto, tfit = _port(blob, [TLogistic(steps=60, device=CPU)] * m, "fp32",
                         exact_reweight=True)
    _assert_match(blob, jproto, jfit, tproto, tfit)


@dataclass(frozen=True)
class _TConstCore(TLearnerCore):
    """Always predicts class 0: its weighted accuracy is about 1/K, so its
    alpha is negative and trips Algorithm 1's line-8 stop."""
    num_classes: int

    def init(self, key, shapes):
        return {"z": torch.zeros(())}

    def fit(self, params, key, X, onehot, w):
        return params

    def logits(self, params, X):
        base = torch.zeros((X.shape[0], self.num_classes))
        base[:, 0] = 1.0
        return base + params["z"]


@dataclass(frozen=True)
class _TConst(TLearner):
    num_classes: int = 3
    device: str = CPU
    functional = True

    def core(self, num_classes):
        return _TConstCore(num_classes)

    def fit(self, key, X, classes, w, num_classes):
        return {"z": torch.zeros(())}

    def predict(self, params, X):
        return self.core(self.num_classes).predict(params, X)


def test_compiled_stop_matches_eager_reference(blob):
    """The alpha <= 0 stop mid-round, and the masked tail after it."""
    from test_compiled import _ConstLearner
    Xtr, ctr, Xte, _, k = blob
    small = (Xtr[:3], ctr, Xte[:3], blob[3], k)
    jproto, jfit = _reference(small, [JLogistic(steps=60), _ConstLearner(k),
                                      JLogistic(steps=60)], "fp32",
                              backend="eager")
    tproto, tfit = _port(small, [TLogistic(steps=60, device=CPU),
                                 _TConst(k), TLogistic(steps=60, device=CPU)],
                         "fp32")
    # the constant agent trips the stop mid-round (here in the last round)
    last = jfit.history[-1]["alphas"]
    assert len(last) == 2 and last[-1] <= 0
    _assert_match(small, jproto, jfit, tproto, tfit)
    res = tproto._compiled_result
    t = len(jfit.history) - 1
    assert int(res.executed.sum()) == 3 * t + 2
    assert not res.executed[t, 2] and not res.valid[t, 1]
    np.testing.assert_allclose(tfit.history[-1]["alphas"], last, rtol=1e-5)


# ============================================== the port's own eager path
@pytest.mark.parametrize("channel", ["fp32", "int8", "int4+int8serve",
                                     "topk", "dp-rdp", "budget",
                                     "controller-resid", "budget-aware"])
def test_compiled_equals_port_eager(blob, channel):
    """Port compiled = port eager on the CPU with the default draw source:
    w, alphas, ledgers, rungs, orders and predictions, bit for bit."""
    m = len(blob[0])
    runs = {}
    for backend in ("eager", "compiled"):
        proto, fit = _port(blob, [TLogistic(steps=40, device=CPU)] * m,
                           channel, backend=backend, draws=None)
        runs[backend] = (proto, fit)
    (ep, ef), (cp, cf) = runs["eager"], runs["compiled"]
    assert [(c.agent, c.round, c.alpha) for c in cf.components] == \
        [(c.agent, c.round, c.alpha) for c in ef.components]
    assert cf.history == ef.history
    assert torch.equal(cp._compiled_result.w, ep._session.state.w)
    assert cp.transport.log.entries == ep.transport.log.entries
    Xte = _t(blob[2])
    assert torch.equal(cf.predict(Xte), ef.predict(Xte))
    assert torch.equal(cp.predict_distributed(Xte),
                       ep.predict_distributed(Xte))
    if ep.transport.controller is not None:
        assert cp.transport.ctrl_state == ep.transport.ctrl_state
    if hasattr(ep.transport, "budget"):
        assert (cp.transport.skipped, cp.transport.exhausted) == \
            (ep.transport.skipped, ep.transport.exhausted)


@pytest.mark.parametrize("agents", ["widths", "learners"])
def test_budget_aware_over_agents_that_differ_equals_port_eager(blob, agents):
    """The reference lowers budget-aware scheduling for equal agents only;
    the port's program fits every agent in every slot and selects the
    slot's, which equals the eager run bit for bit (here agents of 2, 3
    and 3 features, or a logistic among MLPs)."""
    Xtr, ctr, Xte, _, k = blob
    if agents == "widths":
        Xtr = [np.concatenate([Xtr[0], Xtr[1][:, :1]], 1), Xtr[2],
               np.concatenate([Xtr[1], Xtr[3]], 1)]
        Xte = [np.concatenate([Xte[0], Xte[1][:, :1]], 1), Xte[2],
               np.concatenate([Xte[1], Xte[3]], 1)]
        learners = [TLogistic(steps=30, device=CPU) for _ in Xtr]
    else:
        learners = [TLogistic(steps=30, device=CPU) if i % 2 else
                    TMLP(hidden=(16,), steps=40, device=CPU)
                    for i in range(len(Xtr))]
    n, m = len(ctr), len(Xtr)
    runs = {}
    for backend in ("eager", "compiled"):
        t = TBudgeted(TBudgetSpec(session_bits=_budget_bits(
            n, m, (0, 0, 0, 1, 1, 2, 2, 3))))
        proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=3),
                           scheduler=TBudgetAware(), transport=t,
                           backend=backend, device=CPU)
        fit = proto.fit(4, T.endpoints_for(learners, _t(Xtr)),
                        torch.from_numpy(ctr))
        w = (proto._compiled_result.w if backend == "compiled"
             else proto._session.state.w)
        runs[backend] = (fit, t, w)
    (ef, et, ew), (cf, ct, cw) = runs["eager"], runs["compiled"]
    assert [(c.agent, c.round, c.alpha) for c in cf.components] == \
        [(c.agent, c.round, c.alpha) for c in ef.components]
    assert ct.log.entries == et.log.entries and torch.equal(cw, ew)
    assert torch.equal(cf.predict(_t(Xte)), ef.predict(_t(Xte)))
    orders = [[c.agent for c in cf.components if c.round == r]
              for r in range(len(cf.history))]
    assert any(o != sorted(o) for o in orders), orders


def test_session_reads_nothing_back_to_the_host(blob, monkeypatch):
    """Inside the session function no tensor is read to the host: every
    way of reading one raises while it runs (on the card, chip_smoke
    phase 14 runs it under torch.cuda.set_sync_debug_mode("error"))."""
    Xtr, ctr, _, _, k = blob
    plan = TC.plan_for([TLogistic(steps=5, device=CPU) for _ in Xtr], k,
                       max_rounds=2,
                       budget=TBudgetSpec(session_bits=_budget_bits(
                           len(ctr), len(Xtr))),
                       controller=TController(stat="resid",
                                              ladder=TBudgetSpec().ladder),
                       privacy=TMech(epsilon=10.0),
                       scheduler=TBudgetAware().plan())
    shapes = tuple(tuple(x.shape[1:]) for x in Xtr)
    fn = TC.make_session_fn(plan, shapes)
    draws = TC._draws_for(plan, T.key_data(1), len(ctr), shapes, CPU, None,
                          fleet=False)

    def refuse(*a, **kw):
        raise AssertionError("a host read inside the session")
    for name in ("item", "tolist", "numpy", "nonzero", "__bool__",
                 "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    res = fn(draws, tuple(_t(Xtr)), torch.from_numpy(ctr))
    monkeypatch.undo()
    assert res.executed.any()


# =============================================================== rejections
def test_compiled_rejects_eager_only_learners(blob):
    Xtr, ctr, _, _, k = blob
    eng = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=2),
                     backend="compiled", device=CPU)
    eps = T.endpoints_for([TTree(depth=2, device=CPU) for _ in Xtr], _t(Xtr))
    with pytest.raises(ValueError, match="eager-only"):
        eng.fit(0, eps, torch.from_numpy(ctr))


def test_compiled_rejects_what_it_does_not_lower(blob):
    Xtr, ctr, _, _, k = blob
    cfg = T.SessionConfig(num_classes=k, max_rounds=2)
    eps = T.endpoints_for([TLogistic(steps=5, device=CPU) for _ in Xtr],
                          _t(Xtr))
    c = torch.from_numpy(ctr)
    with pytest.raises(ValueError, match="sequential, budget-aware and "
                                         "async-stale"):
        T.Protocol(cfg, scheduler=T.RandomScheduler(), backend="compiled",
                   device=CPU).fit(0, eps, c)
    with pytest.raises(ValueError, match="validation"):
        T.Protocol(cfg, backend="compiled", device=CPU).fit(
            0, eps, c, validation=(_t(Xtr), c))
    with pytest.raises(ValueError, match="fit-to-completion"):
        T.Protocol(cfg, backend="compiled", device=CPU).start(0, eps, c)
    with pytest.raises(ValueError, match="unknown backend"):
        T.Protocol(cfg, backend="jit", device=CPU)
    plan = TC.plan_for([TLogistic(steps=5, device=CPU) for _ in Xtr], k,
                       codec=tcodecs.QuantCodec(8))
    shapes = tuple(tuple(x.shape[1:]) for x in Xtr)
    TC.make_session_fn(plan, shapes, qmax_arg=True)   # the codec sweep
    with pytest.raises(ValueError, match="neither"):    # no control plane
        TC.make_session_fn(plan, shapes, control_arg=True)
    TC.make_session_fn(plan, shapes, live=True)   # the live taps lower
    # a sharded fleet in a gloo world of one: the unsharded fleet's bits;
    # live taps do not shard (the reference raises too)
    import torch.distributed as dist
    short = replace(plan, max_rounds=2)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        whole = TC.fleet_run(short, [0, 1], _t(Xtr), c)
        sharded = TC.fleet_run(short, [0, 1], _t(Xtr), c, shard_axis="data")
        with pytest.raises(ValueError, match="live emission"):
            TC.fleet_run(short, [0, 1], _t(Xtr), c, shard_axis="data",
                         live=True)
    finally:
        dist.destroy_process_group()
    for a, b in zip(jax.tree.leaves(whole), jax.tree.leaves(sharded)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="initialised process group"):
        TC.fleet_run(short, [0, 1], _t(Xtr), c, shard_axis="data")
    with pytest.raises(ValueError, match="async_session"):
        TC.compiled_session(replace(plan, scheduler=TC.AsyncStalePlan()), 0,
                            _t(Xtr), c)


def test_ladder_walk_is_the_budget_rule():
    spec = TBudgetSpec()
    costs = spec.hop_costs(1000)
    for rem in (0, min(costs) - 1, min(costs), costs[2], costs[1] + 5,
                costs[0], 10 ** 9):
        for floor in (None, 0, 1, 2, 3):
            got = int(TC.ladder_walk(costs, torch.tensor(rem), None if floor
                                     is None else torch.tensor(floor)))
            want = spec.choose_costs(costs, rem, float("inf"), floor or 0)
            assert got == (-1 if want is None else want), (rem, floor)


# ======================================================================= CLI
@pytest.mark.parametrize("argv", [[], ["--codec", "int8"],
                                  ["--controller", "entropy"],
                                  ["--scheduler", "budget-aware",
                                   "--byte-budget", "30000"]])
def test_cli_compiled_line_equals_eager(argv, capsys):
    base = ["--device", CPU, "--learner", "logistic", "--steps", "20",
            "--n", "300", "--rounds", "3", *argv]
    eager = cli.run(cli.parser().parse_args(base))
    out_eager = capsys.readouterr().out
    comp = cli.run(cli.parser().parse_args(base + ["--backend", "compiled"]))
    out_comp = capsys.readouterr().out
    assert comp.line == eager.line
    assert out_comp == out_eager


@pytest.mark.parametrize("argv", [["--learner", "tree"],
                                  ["--learner", "logistic", "--variant",
                                   "random"],
                                  ["--learner", "logistic", "--ckpt-dir",
                                   "x"]])
def test_cli_compiled_rules(argv):
    args = cli.parser().parse_args(["--device", CPU, "--backend", "compiled",
                                    *argv])
    with pytest.raises(SystemExit):
        cli.check_args(args)


# ================================================================ the card
@pytest.mark.gpu
def test_compiled_equals_eager_on_card(blob):
    """Compiled = eager on the card, bit for bit, int8 channel, and a
    two-session fleet's launches (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Xtr, ctr, _, _, k = blob
    dev = "cuda"
    runs = {}
    for backend in ("eager", "compiled"):
        proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=3),
                           transport=T.MeteredTransport(
                               codec=tcodecs.QuantCodec(8)),
                           backend=backend, device=dev)
        runs[backend] = (proto, proto.fit(
            KEY, T.endpoints_for([TLogistic(steps=40, device=dev)
                                  for _ in Xtr],
                                 [x.to(dev) for x in _t(Xtr)]),
            torch.from_numpy(ctr).to(dev)))
    (ep, ef), (cp, cf) = runs["eager"], runs["compiled"]
    assert torch.equal(cp._compiled_result.w, ep._session.state.w)
    assert cp.transport.log.entries == ep.transport.log.entries
    assert [c.alpha for c in cf.components] == [c.alpha for c in
                                                ef.components]
