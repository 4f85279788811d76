"""The port's scenario engine against the JAX package's, on the CPU.

Scenarios: the participation masks and the shard masks equal the
reference's exactly for every preset and a grid of knobs, and
``validate`` rejects what it rejects with its messages.  Protocols: ASCII
(blob3, depth-3 trees) under each preset and under async with a clock
skew; FedAvg (logistic and the MLP) and Assisted Learning under fp32,
fp16, int8, int4, DP, session and link budgets, and churn, on the
reference's arrays with its keys replayed.

The reference splits its session key once a hop it runs: per participant
for ASCII and AL, per roster slot of a live round for FedAvg, and not at
all in a round every agent churned out of; FedAvg's init folds
``FEDAVG_INIT_FOLD`` off the key.  The port draws by coordinates
(``repro_torch.comm.draws``), so :class:`ChurnReplay` maps a coordinate to
the reference's running count of splits from the participation mask.

Held exactly: ledgers (every entry: sender, receiver, kind, bits, rung),
skips, releases, participants, stop round and exhaustion.  Within
tolerances (ROADMAP Queue 3): FedAvg's logistic ``g`` atol 1e-5 + rtol
1e-5 (AdamW), the MLP's within 1e-5 of max|g| (its op-by-op fit against
the reference's jitted one, 80 steps over 4 rounds); AL's residuals
within 1e-5 of max|R|;
alphas rtol 1e-5.  Predictions are exact where no hop parted; an ASCII
hop that parts is explained as in tests/test_torch_comm_session.py.

The FedAvg cohort is tests/test_scenarios.py's (gaussian blobs, 60 rows,
3 agents of 2 features, 4 classes) drawn from seed 1: at seed 0 a class
holds exactly n/4 rows, so at the zero init its bias gradient is zero in
exact arithmetic, its sign is rounding noise, and AdamW's first
normalized step turns that noise into +-lr on both sides (Queue 3).

The port's own pins: its one-program FedAvg equals its eager FedAvg bit
for bit (churn and exhaustion included) and reads nothing back to the
host; pause and resume are bit-exact with FedAvg, AL and clock-skew
state; ``state_from_reference`` reads the reference's mid-run
checkpoints of each; the CLI takes the nine scenario and protocol flags
and ``--accountant subsampled-rdp`` with the reference's rejections.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import BudgetedTransport as JBudgeted
from repro.comm import BudgetSpec as JBudgetSpec
from repro.comm import codecs as jcodecs
from repro.comm.privacy import GaussianMechanism as JMech
from repro.control import make_accountant as jmake_accountant
from repro.core import engine as J
from repro.data.synthetic import gaussian_blobs
from repro.learners.logistic import LogisticRegression as JLogistic
from repro.learners.mlp import MLP as JMLP
from repro.learners.tree import DecisionTree as JTree
from repro.scenarios import PRESETS as JPRESETS
from repro.scenarios import AssistedLearningVariant as JAL
from repro.scenarios import FedAvgVariant as JFedAvg
from repro.scenarios import Scenario as JScenario
from repro.scenarios.protocols import FEDAVG_INIT_FOLD
from repro_torch.comm import BudgetedTransport as TBudgeted
from repro_torch.comm import BudgetSpec as TBudgetSpec
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.privacy import GaussianMechanism as TMech
from repro_torch.control import make_accountant as tmake_accountant
from repro_torch.convert import state_from_reference
from repro_torch.core import engine as T
from repro_torch.kernels import ops as tops
from repro_torch.launch import session as cli
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from repro_torch.learners.mlp import MLP as TMLP
from repro_torch.learners.tree import DecisionTree as TTree
from repro_torch.scenarios import PRESETS as TPRESETS
from repro_torch.scenarios import AssistedLearningVariant as TAL
from repro_torch.scenarios import FedAvgVariant as TFedAvg
from repro_torch.scenarios import Scenario as TScenario
from repro_torch.scenarios import compiled as SC
from repro_torch.scenarios import protocols as TP
from test_torch_comm_session import (_assert_on_a_boundary,
                                     _assert_split_decided_by_rounding,
                                     _record, _ReplayFit, _ReplayHop, blob)

CPU = "cpu"
K = 4
AGENTS = 3

# ==================================================================== helpers
@pytest.fixture(scope="module")
def cohort():
    X, classes = gaussian_blobs(jax.random.key(1), n=60,
                                num_features=AGENTS * 2, num_classes=K,
                                cluster_std=1.2)
    return ([np.array(X[:, 2 * m:2 * m + 2]) for m in range(AGENTS)],
            np.array(classes))


class ChurnReplay:
    """A draw source replaying the reference's keys for a session whose
    round t splits ``sizes[t]`` times (see the module note): the fit and
    hop at (t, j) take split ``offsets[t] + j``, an async barrier the
    round's last split, FedAvg's init ``fold_in(key, FEDAVG_INIT_FOLD)``,
    a serve block ``fold_in(serve_key(final_key, request), agent)``."""

    def __init__(self, key, sizes):
        self.key0 = key
        self.sizes = [int(s) for s in sizes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(
            int)
        self._key, self._subs, self._next = key, {}, 0
        self.final_key = None

    def _sub(self, h):
        while self._next <= h:
            self._key, sub = jax.random.split(self._key)
            self._subs[self._next] = sub
            self._next += 1
        return self._subs[h]

    def fit(self, key, t, j):
        return _ReplayFit(self._sub(self.offsets[t] + j))

    def hop(self, key, t, j):
        return _ReplayHop(self._sub(self.offsets[t] + j))

    def barrier(self, key, t):
        return _ReplayHop(self._sub(self.offsets[t] + self.sizes[t] - 1))

    def init(self, key):
        return _ReplayFit(jax.random.fold_in(self.key0, FEDAVG_INIT_FOLD))

    def serve(self, key, agent_index, request=None):
        return _ReplayHop(jax.random.fold_in(
            jcodecs.serve_key(self.final_key, request), agent_index))


def _mask(scenario, rounds, agents):
    return (np.ones((rounds, agents), bool) if scenario is None
            else scenario.participation(rounds, agents))


def _scenarios(**knobs):
    if not knobs:
        return None, None
    return JScenario(**knobs), TScenario(**knobs)


def _dp_pair(eps=2.0):
    """FedAvg deltas and AL residuals are signed: the clamp is off."""
    return (JMech(epsilon=eps, clip=1.0, nonneg=False),
            TMech(epsilon=eps, clip=1.0, nonneg=False))


def _channel(name, bits=None):
    """(reference transport, port transport) for a channel name."""
    if name == "fp32":
        return J.MeteredTransport(), T.MeteredTransport()
    if name in ("fp16", "int8", "int4", "topk"):
        return (J.MeteredTransport(codec=jcodecs.make_codec(name)),
                T.MeteredTransport(codec=tcodecs.make_codec(name)))
    if name == "dp":
        jm, tm = _dp_pair()
        return (J.MeteredTransport(privacy=jm,
                                   accountant=jmake_accountant("rdp")),
                T.MeteredTransport(privacy=tm,
                                   accountant=tmake_accountant("rdp")))
    if name == "int4+dp":
        jm, tm = _dp_pair(1.0)
        return (J.MeteredTransport(codec=jcodecs.make_codec("int4"),
                                   privacy=jm),
                T.MeteredTransport(codec=tcodecs.make_codec("int4"),
                                   privacy=tm))
    if name == "budget":
        return (JBudgeted(JBudgetSpec(session_bits=bits)),
                TBudgeted(TBudgetSpec(session_bits=bits)))
    if name == "link":
        return (JBudgeted(JBudgetSpec(link_bits=bits)),
                TBudgeted(TBudgetSpec(link_bits=bits)))
    raise KeyError(name)


def _entries(t):
    return getattr(t, "log", None) and t.log.entries


def _assert_channel_state(jt, tt):
    """The exact half of the comparison: ledger, skips, spend, releases."""
    assert _entries(tt) == _entries(jt)
    if jt.accountant is not None:
        assert tt.accountant.releases == jt.accountant.releases
        assert tt.accountant.report(tt.privacy) == \
            jt.accountant.report(jt.privacy)
    if hasattr(jt, "budget"):
        assert tt.skipped == jt.skipped
        assert tt.link_spent == jt.link_spent
        assert tt.exhausted == jt.exhausted


def _history_keys(history, drop=("train_acc", "resid_norm")):
    return [{k: v for k, v in rec.items() if k not in drop}
            for rec in history]


# ============================================================ the schedules
SCENARIO_GRID = [
    dict(name="a", dropout=0.3, seed=0),
    dict(name="b", straggle=0.4, seed=1),
    dict(name="c", subsample=0.5, seed=2),
    dict(name="d", subsample=0.34, straggle=0.2, dropout=0.1, seed=9),
    dict(name="e", subsample=1.0, straggle=0.9, seed=4),
]


@pytest.mark.parametrize("preset", sorted(JPRESETS))
@pytest.mark.parametrize("agents", [2, 4, 7])
def test_preset_masks_equal_reference(preset, agents):
    js, ts = JPRESETS[preset], TPRESETS[preset]
    assert ts == TScenario(**{f: getattr(js, f) for f in (
        "name", "subsample", "dropout", "straggle", "partition", "skew",
        "clock_skew", "seed")})
    np.testing.assert_array_equal(ts.participation(12, agents),
                                  js.participation(12, agents))
    assert (ts.trivial, ts.has_churn) == (js.trivial, js.has_churn)
    classes = np.random.default_rng(agents).integers(0, 5, size=90)
    jw = js.shard_weights(classes, agents)
    tw = ts.shard_weights(torch.from_numpy(classes), agents)
    if jw is None:
        assert tw is None
    else:
        assert tw.dtype == torch.float32 and tw.device.type == CPU
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("knobs", SCENARIO_GRID, ids=lambda k: k["name"])
@pytest.mark.parametrize("shape", [(1, 3), (10, 5), (25, 2)])
def test_knob_masks_equal_reference(knobs, shape):
    js, ts = _scenarios(**knobs)
    np.testing.assert_array_equal(ts.participation(*shape),
                                  js.participation(*shape))


@pytest.mark.parametrize("partition,skew", [("dirichlet", 0.1),
                                            ("dirichlet", 2.0),
                                            ("quantity", 0.0),
                                            ("quantity", 1.5)])
def test_shard_weights_equal_reference(partition, skew):
    js, ts = _scenarios(name="s", partition=partition, skew=skew, seed=3)
    classes = np.random.default_rng(1).integers(0, 4, size=70)
    np.testing.assert_array_equal(
        ts.shard_weights(classes, 5).numpy(),
        np.asarray(js.shard_weights(classes, 5)))


def test_scenario_knob_ranges_reject_as_reference():
    for knobs in (dict(subsample=0.0), dict(subsample=1.5),
                  dict(dropout=1.0), dict(straggle=-0.1),
                  dict(partition="zipf"), dict(clock_skew=(0, -1))):
        with pytest.raises(ValueError) as je:
            JScenario(**knobs)
        with pytest.raises(ValueError) as te:
            TScenario(**knobs)
        assert str(te.value) == str(je.value)


def test_validate_rejects_as_reference():
    j_async, t_async = J.AsyncStaleScheduler(), T.AsyncStaleScheduler()
    j_seq, t_seq = J.SequentialScheduler(), T.SequentialScheduler()
    cases = [
        (dict(subsample=0.1), 3, j_seq, t_seq, J.ASCIIVariant(),
         T.ASCIIVariant()),
        (dict(clock_skew=(0, 2)), 2, j_seq, t_seq, J.ASCIIVariant(),
         T.ASCIIVariant()),
        (dict(clock_skew=(0, 2)), 2, j_async, t_async, JFedAvg(),
         TFedAvg()),
        (dict(clock_skew=(0, 2)), 3, j_async, t_async, J.ASCIIVariant(),
         T.ASCIIVariant()),
    ]
    for knobs, m, jsch, tsch, jv, tv in cases:
        js, ts = _scenarios(name="v", **knobs)
        with pytest.raises(ValueError) as je:
            js.validate(m, jsch, jv)
        with pytest.raises(ValueError) as te:
            ts.validate(m, tsch, tv)
        assert str(te.value) == str(je.value)
    TScenario(clock_skew=(0, 2)).validate(2, t_async, T.ASCIIVariant())


# ======================================================== FedAvg and AL pairs
def _learners(kind):
    if kind == "logistic":
        return (lambda: JLogistic(steps=25),
                lambda: TLogistic(steps=25, device=CPU))
    return (lambda: JMLP(hidden=(8,), steps=20),
            lambda: TMLP(hidden=(8,), steps=20, device=CPU))


def _variant_pair(protocol):
    return (JFedAvg(), TFedAvg()) if protocol == "fedavg" else (JAL(), TAL())


def _sizes(protocol, mask):
    if protocol == "fedavg":
        return [mask.shape[1] if row.any() else 0 for row in mask]
    return [int(row.sum()) for row in mask]


def _pair(cohort, protocol, channel, *, learner="logistic", knobs=None,
          rounds=4, bits=None):
    """The reference's and the port's eager sessions on one channel and
    scenario, round by round; returns (jfit, tfit, jt, tt, mask, traces):
    ``traces`` the two sessions' ``g`` (FedAvg) or ``R`` (AL) after each
    round."""
    Xs, c = cohort
    jt, tt = _channel(channel, bits)
    jv, tv = _variant_pair(protocol)
    js, ts = _scenarios(**(knobs or {}))
    jl, tl = _learners(learner)
    key = jax.random.key(7)
    js = J.Protocol(J.SessionConfig(num_classes=K, max_rounds=rounds),
                    transport=jt, variant=jv, scenario=js).start(
        key, J.endpoints_for([jl() for _ in Xs],
                             [jnp.asarray(x) for x in Xs]), jnp.asarray(c))
    mask = _mask(ts, rounds, len(Xs))
    draws = ChurnReplay(key, _sizes(protocol, mask))
    ts = T.Protocol(T.SessionConfig(num_classes=K, max_rounds=rounds),
                    transport=tt, variant=tv, scenario=ts, device=CPU,
                    draws=draws).start(
        7, T.endpoints_for([tl() for _ in Xs],
                           [torch.from_numpy(x) for x in Xs]),
        torch.from_numpy(c))
    for sess in (js, ts):
        sess.trace = []                 # the state after each round
        while True:
            before = sess.state.round
            more = sess.step()
            if sess.state.round > before:
                sess.trace.append(np.array(sess.state.proto[
                    "g" if protocol == "fedavg" else "R"]))
            if not more:
                break
    return js.fitted(), ts.fitted(), jt, tt, mask, (js.trace, ts.trace)


def _fedavg_budget(d, n, agents, rounds_full=1):
    """A session cap that setup and ``rounds_full`` fp32 rounds use up,
    leaving less than a round: the next round degrades, then skips and
    exhausts."""
    setup = (agents - 1) * 2 * n * 32
    round_bits = (agents - 1) * 2 * d * 32      # uplinks + broadcasts
    return setup + rounds_full * round_bits + (d * 32 + d * 8 + 50)


FEDAVG_CHANNELS = ["fp32", "fp16", "int8", "int4", "dp", "int4+dp",
                   "budget", "link"]


def _fedavg_bits(channel, learner, cohort):
    d = 12 if learner == "logistic" else 60
    n = len(cohort[1])
    if channel == "budget":
        return _fedavg_budget(d, n, AGENTS)
    if channel == "link":
        return 2 * d * 32 + d * 16 + 40           # fp32 twice, then degrade
    return None


#: FedAvg's warm starts: a delta component whose gradient is near zero at
#: the warm start takes an AdamW first step of +-lr whose size is
#: normalized away, so the reductions' rounding (~1e-5 of the gradient,
#: not of its sign) reaches the params; a churned round and the MLP's 80
#: steps carry it to ~5e-5 of max|g| (ROADMAP Queue 3, "FedAvg warm
#: starts"; test_fedavg_rounds_part_only_by_warm_start_rounding).
WARM_START = 1e-4


def _solo_restart(history) -> int:
    """The first round in which a client warm-starts from the g its own
    fit made alone (its last live round had it as the only participant):
    the client starts at its own optimum, every gradient is small, and
    AdamW's lr-sized steps bounce around it, so the rounding of the
    reductions moves the result by up to ~1e-2 (ROADMAP Queue 3, "FedAvg
    warm starts").  len(history) when no round does."""
    last = None
    for i, rec in enumerate(history):
        parts = rec.get("participants")
        if not parts:
            continue
        if last is not None and len(last) == 1 and last[0] in parts:
            return i
        last = parts
    return len(history)


def _assert_fedavg_match(jfit, tfit, jt, tt, learner, scale=None,
                         traces=None):
    """Exact: ledger, spend, releases, participants, rounds.  ``g`` after
    each round (``traces``, else the final ``g``) and the round
    accuracies within the tolerance, up to a solo restart."""
    _assert_channel_state(jt, tt)
    assert _history_keys(tfit.history) == _history_keys(jfit.history)
    upto = _solo_restart(jfit.history)
    assert [r.get("train_acc") for r in tfit.history[:upto]] == \
        [r.get("train_acc") for r in jfit.history[:upto]]
    pairs = (list(zip(traces[0], traces[1]))[:upto] if traces is not None
             else [(np.asarray(jfit.g), tfit.g.numpy())])
    for jg, tg in pairs:
        if scale is None and learner == "logistic":
            tol = dict(atol=1e-5, rtol=1e-5)
        else:
            tol = dict(atol=(scale or 1e-5) * max(1.0, np.abs(jg).max()),
                       rtol=0)
        np.testing.assert_allclose(tg, jg, **tol)
    return upto


@pytest.mark.parametrize("learner", ["logistic", "mlp"])
@pytest.mark.parametrize("channel", FEDAVG_CHANNELS)
def test_fedavg_matches_reference(cohort, channel, learner):
    jfit, tfit, jt, tt, _, _ = _pair(
        cohort, "fedavg", channel, learner=learner,
        bits=_fedavg_bits(channel, learner, cohort))
    noised = learner == "mlp" and "dp" in channel
    assert _assert_fedavg_match(jfit, tfit, jt, tt, learner,
                                WARM_START if noised else None) == \
        len(jfit.history)
    if channel in ("budget", "link"):
        assert tt.skipped and len({e.get("rung") for e in tt.log.entries
                                   if "rung" in e}) >= 2
        assert tt.exhausted == (channel == "budget")


CHURN = [dict(name="mix", subsample=0.9, straggle=0.2, seed=5),
         dict(name="churn", straggle=0.4, dropout=0.1, seed=2),
         dict(name="noniid", partition="dirichlet", skew=0.3, seed=1)]


@pytest.mark.parametrize("knobs", CHURN, ids=lambda k: k["name"])
@pytest.mark.parametrize("channel", ["fp32", "int8", "budget"])
def test_fedavg_under_churn_matches_reference(cohort, knobs, channel):
    jfit, tfit, jt, tt, mask, traces = _pair(
        cohort, "fedavg", channel, knobs=knobs, rounds=6,
        bits=_fedavg_bits(channel, "logistic", cohort))
    _assert_fedavg_match(jfit, tfit, jt, tt, "logistic", WARM_START, traces)
    ran = [r for r in tfit.history]
    assert [r["participants"] for r in ran] == \
        [[int(j) for j in np.flatnonzero(mask[r["round"]])] for r in ran]


def test_fedavg_churn_has_an_empty_round_that_is_not_a_stop(cohort):
    knobs = dict(name="empty", straggle=0.6, seed=3)
    mask = TScenario(**knobs).participation(6, AGENTS)
    assert not mask.all(axis=1).all() and (~mask.any(axis=1)).any()
    jfit, tfit, jt, tt, _, traces = _pair(cohort, "fedavg", "int8",
                                          knobs=knobs, rounds=6)
    _assert_fedavg_match(jfit, tfit, jt, tt, "logistic", WARM_START, traces)
    assert len(tfit.history) == 6
    assert any(r["participants"] == [] and "train_acc" not in r
               for r in tfit.history)


AL_CHANNELS = ["fp32", "fp16", "int8", "int4", "dp", "int4+dp", "budget",
               "link"]


def _al_bits(channel, n):
    payload = n * K * 32
    if channel == "budget":
        return (AGENTS - 1) * 2 * n * 32 + 4 * payload + payload // 3
    if channel == "link":
        return payload + payload // 2
    return None


def _assert_al_match(jfit, tfit, jt, tt):
    _assert_channel_state(jt, tt)
    assert [(c.agent, c.round) for c in tfit.components] == \
        [(c.agent, c.round) for c in jfit.components]
    assert _history_keys(tfit.history) == _history_keys(jfit.history)
    for jc, tc in zip(jfit.components, tfit.components):
        np.testing.assert_allclose(tc.params.numpy(), np.asarray(jc.params),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        [r.get("resid_norm", 0.0) for r in tfit.history],
        [r.get("resid_norm", 0.0) for r in jfit.history], rtol=1e-5)


@pytest.mark.parametrize("channel", AL_CHANNELS)
def test_al_matches_reference(cohort, channel):
    jfit, tfit, jt, tt, _, _ = _pair(cohort, "al", channel,
                                     bits=_al_bits(channel,
                                                   len(cohort[1])))
    _assert_al_match(jfit, tfit, jt, tt)
    Xs = cohort[0]
    js = np.asarray(jfit.decision_scores([jnp.asarray(x) for x in Xs]))
    ts = tfit.decision_scores([torch.from_numpy(x) for x in Xs]).numpy()
    np.testing.assert_allclose(ts, js, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(js).max()))
    np.testing.assert_array_equal(
        tfit.predict([torch.from_numpy(x) for x in Xs]).numpy(),
        np.asarray(jfit.predict([jnp.asarray(x) for x in Xs])))
    if channel in ("budget", "link"):
        assert tt.skipped


@pytest.mark.parametrize("knobs", CHURN, ids=lambda k: k["name"])
def test_al_under_churn_matches_reference(cohort, knobs):
    jfit, tfit, jt, tt, _, _ = _pair(cohort, "al", "int8", knobs=knobs,
                                     rounds=5)
    _assert_al_match(jfit, tfit, jt, tt)


def test_al_residual_shrinks_and_stays_within_tolerance(cohort):
    """The residual's last value against the reference's, within 1e-5 of
    max|R|, and its norm falls round over round."""
    Xs, c = cohort
    jt, tt = _channel("fp32")
    key = jax.random.key(7)
    js = J.Protocol(J.SessionConfig(num_classes=K, max_rounds=3),
                    transport=jt, variant=JAL()).start(
        key, J.endpoints_for([JLogistic() for _ in Xs],
                             [jnp.asarray(x) for x in Xs]), jnp.asarray(c))
    js.run()
    ts = T.Protocol(T.SessionConfig(num_classes=K, max_rounds=3),
                    transport=tt, variant=TAL(), device=CPU,
                    draws=ChurnReplay(key, [AGENTS] * 3)).start(
        7, T.endpoints_for([TLogistic(device=CPU) for _ in Xs],
                           [torch.from_numpy(x) for x in Xs]),
        torch.from_numpy(c))
    ts.run()
    jR = np.asarray(js.state.proto["R"])
    np.testing.assert_allclose(ts.state.proto["R"].numpy(), jR, rtol=0,
                               atol=1e-5 * np.abs(jR).max())
    norms = [r["resid_norm"] for r in ts.state.history]
    assert all(b < a for a, b in zip(norms, norms[1:]))


def test_fedavg_rounds_part_only_by_warm_start_rounding(cohort):
    """Teacher-forced, round by round: the port's round from the
    reference's g stays within WARM_START of max|g|, but at a solo restart
    (a client resuming from its own optimum), where AdamW's lr-sized steps
    bounce around the optimum and the parting stays below lr."""
    Xs, c = cohort
    knobs = dict(name="churn", straggle=0.4, dropout=0.1, seed=2)
    js_, ts_ = _scenarios(**knobs)
    key = jax.random.key(7)
    rounds = 6
    mask = ts_.participation(rounds, AGENTS)
    js = J.Protocol(J.SessionConfig(num_classes=K, max_rounds=rounds),
                    transport=J.MeteredTransport(), variant=JFedAvg(),
                    scenario=js_).start(
        key, J.endpoints_for([JLogistic(steps=25) for _ in Xs],
                             [jnp.asarray(x) for x in Xs]), jnp.asarray(c))
    ts = T.Protocol(T.SessionConfig(num_classes=K, max_rounds=rounds),
                    transport=T.MeteredTransport(), variant=TFedAvg(),
                    scenario=ts_, device=CPU,
                    draws=ChurnReplay(key, _sizes("fedavg", mask))).start(
        7, T.endpoints_for([TLogistic(steps=25, device=CPU) for _ in Xs],
                           [torch.from_numpy(x) for x in Xs]),
        torch.from_numpy(c))
    solo = []
    for _ in range(rounds):
        js.step()
        ts.step()
        jg = np.asarray(js.state.proto["g"])
        gap = np.abs(ts.state.proto["g"].numpy() - jg).max()
        restart = _solo_restart(js.state.history) < len(js.state.history)
        if restart and not solo:
            solo.append(gap)
            assert gap < 0.1                    # below AdamW's lr
        elif not solo:
            assert gap <= WARM_START * max(1.0, np.abs(jg).max())
        ts.state.proto["g"] = torch.from_numpy(jg.copy())
    assert solo and solo[0] > WARM_START     # the case shows its parting
    assert ts.transport.log.entries == js.transport.log.entries


# ============================================================ ASCII scenarios
def _ascii_pair(blob, knobs, *, scheduler="seq", channel="fp32", rounds=4):
    Xtr, ctr, _, _, k = blob
    m = len(Xtr)
    stale = scheduler == "async"
    jsch, tsch = ((J.AsyncStaleScheduler(), T.AsyncStaleScheduler()) if stale
                  else (J.SequentialScheduler(), T.SequentialScheduler()))
    jt, tt = _channel(channel)
    js_, ts_ = _scenarios(**knobs)
    jhops, thops = _record(jt), _record(tt)
    key = jax.random.key(2)
    cfg = dict(num_classes=k, max_rounds=rounds)
    js = J.Protocol(J.SessionConfig(**cfg), scheduler=jsch, transport=jt,
                    scenario=js_).start(
        key, J.endpoints_for([JTree(depth=3, num_thresholds=8)
                              for _ in range(m)],
                             [jnp.asarray(x) for x in Xtr]),
        jnp.asarray(ctr))
    js.run()
    mask = _mask(ts_, rounds, m)
    barrier = stale and channel != "fp32"
    draws = ChurnReplay(key, [int(r.sum()) + (barrier and r.any())
                              for r in mask])
    ts = T.Protocol(T.SessionConfig(**cfg), scheduler=tsch, transport=tt,
                    scenario=ts_, device=CPU, draws=draws).start(
        2, T.endpoints_for([TTree(depth=3, num_thresholds=8, device=CPU)
                            for _ in range(m)],
                           [torch.from_numpy(x) for x in Xtr]),
        torch.from_numpy(ctr))
    ts.run()
    draws.final_key = js.state.key
    return js, ts, jhops, thops, draws


def _hop_coords(history, count):
    """(round, position) of each interchange hop, in order."""
    out = []
    for rec in history:
        order = rec.get("participants", None)
        for j in range(len(order if order is not None
                           else rec.get("alphas", []))):
            out.append((rec["round"], j))
    return out[:count]


def _first_parted_hop(jhops, thops, coords, ts, Xtr, ctr, k):
    """As tests/test_torch_comm_session.py's ``_first_divergent_hop``, for
    hops under churn and shards: the trees are held on each side's own
    fit weights (the shard mask renormalized, as each package does)."""
    for i, (jh, th) in enumerate(zip(jhops, thops)):
        t, j = coords[i]
        m = th["m"]
        if not np.array_equal(jh["r"], th["r"]):
            jw, tw = jh["w"], th["w"]
            if ts._shard_w is not None:
                mask = ts._shard_w[m].numpy()
                jw = jw * mask / np.maximum(np.sum(jw * mask,
                                                   dtype=np.float32), 1e-12)
                tw = ts.fit_weight(m, torch.from_numpy(th["w"])).numpy()
            _assert_split_decided_by_rounding(
                {**jh, "w": jw}, {**th, "w": tw}, Xtr[m], ctr, k)
            return i
        if jh["skipped"] or np.allclose(th["out"], jh["out"], rtol=1e-6,
                                        atol=1e-7):
            continue
        _assert_on_a_boundary(jh, ts.draws.hop(None, t, j))
        return i
    return None


@pytest.mark.parametrize("preset", ["churn", "noniid", "subsample"])
@pytest.mark.parametrize("channel", ["fp32", "int8"])
def test_ascii_under_presets_matches_reference(blob, preset, channel):
    knobs = {f: getattr(TPRESETS[preset], f) for f in (
        "name", "subsample", "dropout", "straggle", "partition", "skew",
        "seed")}
    js, ts, jhops, thops, _ = _ascii_pair(blob, knobs, channel=channel,
                                          rounds=5)
    Xtr, ctr, Xte, _, k = blob
    assert [(c.agent, c.round) for c in ts.state.components] == \
        [(c.agent, c.round) for c in js.state.components]
    assert _history_keys(ts.state.history, ("alphas", "accs")) == \
        _history_keys(js.state.history, ("alphas", "accs"))
    assert (ts.state.round, ts.state.stopped) == (js.state.round,
                                                  js.state.stopped)
    _assert_channel_state(js.transport, ts.transport)
    coords = _hop_coords(ts.state.history, len(thops))
    split = _first_parted_hop(jhops, thops, coords, ts, Xtr, ctr, k)
    upto = len(thops) if split is None else split
    np.testing.assert_allclose(
        [c.alpha for c in ts.state.components[:upto]],
        [c.alpha for c in js.state.components[:upto]], rtol=1e-5)
    if split is None:
        np.testing.assert_allclose(ts.state.w.numpy(),
                                   np.asarray(js.state.w), atol=1e-6)
        Xte_t = [torch.from_numpy(x) for x in Xte]
        np.testing.assert_array_equal(
            ts.predict_distributed(Xte_t).numpy(),
            np.asarray(js.predict_distributed([jnp.asarray(x)
                                               for x in Xte])))
    if preset != "noniid":
        assert any(len(r["participants"]) < len(Xtr)
                   for r in ts.state.history)


@pytest.mark.parametrize("channel", ["fp32", "int8"])
def test_async_clock_skew_matches_reference(blob, channel):
    knobs = dict(name="skew", clock_skew=(0, 2, 1, 0), straggle=0.2,
                 seed=4)
    js, ts, _, _, _ = _ascii_pair(blob, knobs, scheduler="async",
                                  channel=channel, rounds=5)
    assert [(c.agent, c.round) for c in ts.state.components] == \
        [(c.agent, c.round) for c in js.state.components]
    _assert_channel_state(js.transport, ts.transport)
    np.testing.assert_allclose([c.alpha for c in ts.state.components],
                               [c.alpha for c in js.state.components],
                               rtol=1e-5)
    np.testing.assert_allclose(ts.state.w.numpy(), np.asarray(js.state.w),
                               atol=1e-6)
    hist_t, hist_j = ts.state.proto["w_hist"], js.state.proto["w_hist"]
    assert len(hist_t) == len(hist_j) == 3
    for a, b in zip(hist_t, hist_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    Xte = [torch.from_numpy(x) for x in blob[2]]
    np.testing.assert_array_equal(
        ts.fitted().predict(Xte).numpy(),
        np.asarray(js.fitted().predict([jnp.asarray(x) for x in blob[2]])))


def test_ascii_zero_skew_keeps_a_history_as_reference(blob):
    """A clock skew of all zeros still keeps the (unused) history, as the
    reference's session state does, and reads the current score."""
    js, ts, _, _, _ = _ascii_pair(blob, dict(name="z", clock_skew=(0,) * 4),
                                  scheduler="async", rounds=2)
    assert len(ts.state.proto["w_hist"]) == len(js.state.proto["w_hist"])
    np.testing.assert_allclose(ts.state.w.numpy(), np.asarray(js.state.w),
                               atol=1e-6)


# ========================================== the port's one program = eager
def _port_fedavg(cohort, channel, backend, *, learner="logistic", knobs=None,
                 rounds=5, bits=None, seed=3):
    Xs, c = cohort
    tt = _channel(channel, bits)[1]
    ts_ = None if knobs is None else TScenario(**knobs)
    tl = _learners(learner)[1]
    proto = T.Protocol(T.SessionConfig(num_classes=K, max_rounds=rounds),
                       transport=tt, variant=TFedAvg(), scenario=ts_,
                       device=CPU, backend=backend)
    fit = proto.fit(seed, T.endpoints_for([tl() for _ in Xs],
                                          [torch.from_numpy(x) for x in Xs]),
                    torch.from_numpy(c))
    return fit, tt


COMPILED_CASES = [
    ("fp32", None, "logistic"), ("int8", None, "logistic"),
    ("int4", "mix", "logistic"), ("fp16", "churn", "logistic"),
    ("dp", "mix", "logistic"), ("int4+dp", None, "logistic"),
    ("topk", "churn", "logistic"), ("budget", None, "logistic"),
    ("budget", "mix", "logistic"), ("link", "churn", "logistic"),
    ("int8", "noniid", "mlp"), ("budget", None, "mlp"),
]


@pytest.mark.parametrize("channel,scenario,learner", COMPILED_CASES)
def test_compiled_fedavg_equals_port_eager(cohort, channel, scenario,
                                           learner):
    knobs = None if scenario is None else next(
        k for k in CHURN if k["name"] == scenario)
    bits = _fedavg_bits(channel, learner, cohort)
    ef, et = _port_fedavg(cohort, channel, "eager", learner=learner,
                          knobs=knobs, bits=bits)
    cf, ct = _port_fedavg(cohort, channel, "compiled", learner=learner,
                          knobs=knobs, bits=bits)
    assert torch.equal(cf.g, ef.g)
    assert cf.history == ef.history
    _assert_channel_state(et, ct)
    assert ct.total_bits == et.total_bits
    if channel == "budget":
        assert ct.exhausted and ct.skipped


def test_fedavg_program_reads_nothing_back_to_the_host(cohort, monkeypatch):
    Xs, c = cohort
    core = TLogistic(steps=3, device=CPU).core(K)
    plan = SC.FedAvgPlan(core=core, num_classes=K, num_agents=AGENTS,
                         max_rounds=3, privacy=TMech(epsilon=2.0,
                                                     nonneg=False),
                         budget=TBudgetSpec(session_bits=_fedavg_budget(
                             12, len(c), AGENTS)))
    classes = torch.from_numpy(c)
    draws = SC.draws_for(plan, 5, len(c), (2,), CPU)
    mask = torch.from_numpy(TScenario(**CHURN[0]).participation(3, AGENTS))
    fit_w = TP.fedavg_fit_weights(classes, AGENTS)
    fn = SC.make_fedavg_fn(plan, (2,))

    def refuse(*a, **kw):
        raise AssertionError("a host read inside the program")
    for name in ("item", "tolist", "numpy", "nonzero", "__bool__",
                 "__float__", "__int__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    res = fn(draws, tuple(torch.from_numpy(x) for x in Xs), classes, mask,
             fit_w)
    monkeypatch.undo()
    assert res.executed.any() and res.g_trace.shape == (3, 12)


def test_compiled_fedavg_quantize_launches_every_slot_and_rung(cohort):
    """The program evaluates every int rung of the ladder for every
    non-server slot of every round; eager quantizes what it ships."""
    calls = []
    inner = tops.quantize_dequant

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return inner(*a, **kw)
    bits = _fedavg_budget(12, len(cohort[1]), AGENTS)
    tops.quantize_dequant = counting
    try:
        _port_fedavg(cohort, "budget", "compiled", bits=bits, rounds=4)
        compiled_calls = len(calls)
        calls.clear()
        _, tt = _port_fedavg(cohort, "budget", "eager", bits=bits, rounds=4)
    finally:
        tops.quantize_dequant = inner
    assert compiled_calls == 4 * (AGENTS - 1) * 2      # int8 and int4 rungs
    shipped_int = sum(1 for e in tt.log.entries
                      if e["kind"] == "gradient" and e.get("rung", 0) >= 2)
    assert len(calls) == shipped_int


# ============================================================ pause, resume
def _resume_case(cohort, blob, case, tmp_path, stop):
    """The session paused after ``stop`` rounds and resumed from its
    checkpoint, and the uninterrupted one: (resumed, whole)."""
    if case == "ascii-skew":
        Xs, c, k = blob[0], blob[1], blob[4]
        scen = TScenario("s", clock_skew=(0, 2, 1, 0), straggle=0.2, seed=4)
        learners = [TTree(depth=3, num_thresholds=8, device=CPU)
                    for _ in Xs]
        sched, variant, transport = (T.AsyncStaleScheduler,
                                     T.ASCIIVariant, "int8")
    else:
        Xs, c = cohort
        k = K
        scen = TScenario(**CHURN[1]) if case == "fedavg" else \
            TScenario(**CHURN[2])
        learners = [TLogistic(steps=10, device=CPU) for _ in Xs]
        sched = T.SequentialScheduler
        variant = TFedAvg if case == "fedavg" else TAL
        transport = "int8" if case == "fedavg" else "budget"
    bits = _al_bits("budget", len(c)) * 2

    def protocol():
        return T.Protocol(T.SessionConfig(num_classes=k, max_rounds=6),
                          scheduler=sched(), variant=variant(),
                          scenario=scen, device=CPU,
                          transport=_channel(transport, bits)[1])
    eps = lambda: T.endpoints_for(learners, [torch.from_numpy(x)  # noqa
                                             for x in Xs])
    whole = protocol().start(9, eps(), torch.from_numpy(c))
    whole.run()
    part = protocol().start(9, eps(), torch.from_numpy(c))
    part.run(max_rounds=stop)
    part.checkpoint(str(tmp_path))
    resumed = protocol().resume(str(tmp_path), eps(), torch.from_numpy(c))
    resumed.run()
    return resumed, whole


def _flat(tree):
    return [x for _, x in TP._leaves(tree)]


@pytest.mark.parametrize("case", ["fedavg", "al", "ascii-skew"])
def test_pause_and_resume_are_bit_exact(cohort, blob, case, tmp_path):
    resumed, whole = _resume_case(cohort, blob, case, tmp_path, stop=2)
    assert resumed.state.history == whole.state.history
    assert torch.equal(resumed.state.w, whole.state.w)
    for a, b in zip(_flat(resumed.state.proto), _flat(whole.state.proto)):
        assert torch.equal(a, b)
    assert [(c.agent, c.round, c.alpha) for c in resumed.state.components] \
        == [(c.agent, c.round, c.alpha) for c in whole.state.components]
    if hasattr(whole.transport, "budget"):
        assert resumed.transport.exhausted == whole.transport.exhausted


def _reference_checkpoint(cohort, blob, case, tmp_path, stop=2):
    """The reference's session checkpointed after ``stop`` rounds, and the
    same session run uninterrupted; plus the port's resume pieces."""
    if case == "ascii-skew":
        Xs, c, k = blob[0], blob[1], blob[4]
        knobs = dict(name="s", clock_skew=(0, 2, 1, 0), straggle=0.2, seed=4)
        jl = lambda: JTree(depth=3, num_thresholds=8)  # noqa: E731
        tl = lambda: TTree(depth=3, num_thresholds=8, device=CPU)  # noqa
        sched = (J.AsyncStaleScheduler, T.AsyncStaleScheduler)
        variant = (J.ASCIIVariant, T.ASCIIVariant)
    else:
        Xs, c = cohort
        k = K
        # FedAvg's shards without churn: no solo restart to part at
        knobs = CHURN[2] if case == "fedavg" else CHURN[1]
        jl = lambda: JLogistic(steps=25)  # noqa: E731
        tl = lambda: TLogistic(steps=25, device=CPU)  # noqa: E731
        sched = (J.SequentialScheduler, T.SequentialScheduler)
        variant = _variant_pair(case)
        variant = (type(variant[0]), type(variant[1]))
    js_, ts_ = _scenarios(**knobs)
    key = jax.random.key(7)

    def jsession():
        return J.Protocol(J.SessionConfig(num_classes=k, max_rounds=5),
                          scheduler=sched[0](), variant=variant[0](),
                          scenario=js_).start(
            key, J.endpoints_for([jl() for _ in Xs],
                                 [jnp.asarray(x) for x in Xs]),
            jnp.asarray(c))
    whole = jsession()
    whole.run()
    part = jsession()
    part.run(max_rounds=stop)
    part.checkpoint(str(tmp_path))
    mask = ts_.participation(5, len(Xs))
    sizes = (_sizes("fedavg", mask) if case == "fedavg"
             else [int(r.sum()) for r in mask])
    port = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=5),
                      scheduler=sched[1](), variant=variant[1](),
                      scenario=ts_, device=CPU,
                      draws=ChurnReplay(key, sizes))
    eps = T.endpoints_for([tl() for _ in Xs],
                          [torch.from_numpy(x) for x in Xs])
    return part, whole, port, eps, torch.from_numpy(c)


@pytest.mark.parametrize("case", ["fedavg", "al", "ascii-skew"])
def test_state_from_reference_reads_variant_state(cohort, blob, case,
                                                  tmp_path):
    part, whole, port, eps, c = _reference_checkpoint(cohort, blob, case,
                                                      tmp_path)
    state = state_from_reference(str(tmp_path), device=CPU)
    jflat = [np.asarray(x) for _, x in TP._leaves(part.state.proto)]
    tflat = _flat(state.proto)
    assert len(tflat) == len(jflat) > 0
    for a, b in zip(tflat, jflat):
        np.testing.assert_array_equal(a.numpy(), b)
    assert state.round == part.state.round
    resumed = port.resume_state(state, eps, c)
    resumed.run()
    assert _history_keys(resumed.state.history, (
        "train_acc", "resid_norm", "alphas", "accs")) == _history_keys(
        whole.state.history, ("train_acc", "resid_norm", "alphas", "accs"))
    key = {"fedavg": "g", "al": "R"}.get(case)
    if key is not None:
        want = np.asarray(whole.state.proto[key])
        got = resumed.state.proto[key].numpy()
        tol = WARM_START if case == "fedavg" else 1e-5
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(1.0, np.abs(want).max()))
    else:
        np.testing.assert_allclose(resumed.state.w.numpy(),
                                   np.asarray(whole.state.w), atol=1e-6)


# ============================================================== rejections
def test_homogeneous_core_rejects_as_reference(cohort):
    Xs, c = cohort
    wide = [Xs[0], Xs[1], np.concatenate([Xs[2], Xs[2]], axis=1)]
    cases = [
        ([TTree(device=CPU), TLogistic(device=CPU), TLogistic(device=CPU)],
         Xs, "no functional LearnerCore"),
        ([TLogistic(steps=5, device=CPU), TLogistic(steps=6, device=CPU),
          TLogistic(steps=5, device=CPU)], Xs, "one shared model"),
        ([TLogistic(device=CPU) for _ in Xs], wide, "fixed feature shape"),
    ]
    for learners, blocks, what in cases:
        eps = T.endpoints_for(learners, [torch.from_numpy(x)
                                         for x in blocks])
        with pytest.raises(ValueError, match=what):
            TP._homogeneous_core(eps, K)
        with pytest.raises(ValueError, match=what):
            T.Protocol(T.SessionConfig(num_classes=K), variant=TFedAvg(),
                       device=CPU).start(0, eps, torch.from_numpy(c))


def test_engine_rejects_what_the_reference_rejects(cohort):
    from repro_torch.control import AdaptiveController
    Xs, c = cohort
    eps = T.endpoints_for([TLogistic(device=CPU) for _ in Xs],
                          [torch.from_numpy(x) for x in Xs])
    cfg = T.SessionConfig(num_classes=K)
    with pytest.raises(ValueError, match="ASCII merge rule"):
        T.Protocol(cfg, scheduler=T.AsyncStaleScheduler(), variant=TAL(),
                   device=CPU).start(0, eps, torch.from_numpy(c))
    with pytest.raises(ValueError, match="adaptive controllers"):
        T.Protocol(cfg, variant=TFedAvg(), device=CPU,
                   transport=T.MeteredTransport(
                       controller=AdaptiveController())).start(
            0, eps, torch.from_numpy(c))
    with pytest.raises(ValueError, match="no compiled lowering"):
        T.Protocol(cfg, variant=TAL(), device=CPU,
                   backend="compiled").fit(0, eps, torch.from_numpy(c))
    with pytest.raises(ValueError, match="does not lower ASCII scenario"):
        T.Protocol(cfg, scenario=TPRESETS["churn"], device=CPU,
                   backend="compiled").fit(0, eps, torch.from_numpy(c))
    s = T.Protocol(T.SessionConfig(num_classes=K, max_rounds=1),
                   variant=TFedAvg(), device=CPU).start(
        0, eps, torch.from_numpy(c))
    s.run()
    with pytest.raises(ValueError, match="score-block serving"):
        s.predict_distributed()


def test_ship_prices_the_encoded_payload_and_budget_skips(cohort):
    Xs, c = cohort
    eps = T.endpoints_for([TLogistic(device=CPU) for _ in Xs],
                          [torch.from_numpy(x) for x in Xs])
    x = torch.linspace(-1, 1, 30)
    t = T.MeteredTransport(codec=tcodecs.make_codec("int8"))
    t.bind(eps)
    hop = T.key_data(1)
    out = t.ship(eps[1], eps[0], x, T.GradientMsg,
                 draws=__import__("repro_torch.comm.draws",
                                  fromlist=["ChannelDraws"]
                                  ).ChannelDraws().hop(hop, 0, 1))
    assert out.shape == x.shape and not torch.equal(out, x)
    assert t.log.entries[-1]["bits"] == tcodecs.make_codec(
        "int8").wire_bits((30,))
    assert T.GradientMsg("a", "b", x).bits == 30 * 32
    assert T.ResidualMsg("a", "b", torch.zeros(5, 4)).bits == 20 * 32
    b = TBudgeted(TBudgetSpec(session_bits=30 * 16 + 10))
    b.bind(eps)
    assert b.ship(eps[1], eps[0], x, T.GradientMsg) is not None
    assert b.ship(eps[1], eps[0], x, T.GradientMsg) is None
    assert b.exhausted and b.skipped == [("agent1", "agent0")]


# ======================================================================= CLI
def _cli(argv, capsys):
    run = cli.run(cli.parser().parse_args(["--device", CPU, "--rounds", "3",
                                           "--steps", "10", *argv]))
    return run, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--protocol", "fedavg", "--learner", "logistic", "--scenario", "churn",
     "--codec", "int8"],
    ["--protocol", "fedavg", "--learner", "logistic", "--byte-budget",
     "3000", "--subsample", "0.5", "--dp-epsilon", "2", "--accountant",
     "subsampled-rdp"],
    ["--protocol", "fedavg", "--learner", "mlp", "--partition", "quantity",
     "--skew", "1.0", "--codec", "int4"],
])
def test_cli_fedavg_compiled_prints_the_eager_lines(argv, capsys):
    _, eager = _cli(argv, capsys)
    run, compiled = _cli([*argv, "--backend", "compiled"], capsys)
    assert compiled == eager and "fedavg" in eager and "params=" in eager
    assert run.session is None and run.fitted is not None


def test_cli_al_and_clock_skew_run(capsys):
    run, out = _cli(["--protocol", "al", "--scenario", "noniid",
                     "--dp-epsilon", "1", "--accountant", "rdp"], capsys)
    assert out.startswith("blob3,al,ascii,metered,") and "dp: " in out
    assert run.session.transport.privacy.nonneg is False
    run, out = _cli(["--variant", "async", "--clock-skew", "0,2,1,0",
                     "--straggle", "0.2"], capsys)
    assert run.session.scenario.clock_skew == (0, 2, 1, 0)
    assert len(run.session.state.proto["w_hist"]) == 3
    assert "serve: acc=" in out


def test_cli_subsampled_rdp_amplifies(capsys):
    from repro_torch.control.accounting import SubsampledRDPAccountant
    run, _ = _cli(["--protocol", "fedavg", "--learner", "logistic",
                   "--scenario", "subsample", "--dp-epsilon", "2",
                   "--accountant", "subsampled-rdp"], capsys)
    acc = run.transport.accountant
    assert isinstance(acc, SubsampledRDPAccountant) and acc.q == 0.5


@pytest.mark.parametrize("argv", [
    ["--protocol", "fedavg"],                                # tree learner
    ["--protocol", "al", "--backend", "compiled", "--learner", "logistic"],
    ["--protocol", "fedavg", "--learner", "logistic", "--variant", "simple"],
    ["--protocol", "al", "--variant", "async"],
    ["--protocol", "al", "--controller", "entropy"],
    ["--scenario", "churn", "--straggle", "0.2"],
    ["--clock-skew", "0,1,0,0"],
    ["--variant", "async", "--clock-skew", "0,x"],
    ["--variant", "async", "--clock-skew", "0,1"],          # roster of 4
    ["--subsample", "1.5"],
    ["--subsample", "0.05"],                                 # empty rounds
    ["--dp-epsilon", "1", "--accountant", "subsampled-rdp"],
    ["--scenario", "churn", "--backend", "compiled", "--learner",
     "logistic"],
])
def test_cli_rejects_as_reference(argv):
    with pytest.raises(SystemExit):
        cli.run(cli.parser().parse_args(["--device", CPU, *argv]))


def test_cli_resume_fills_the_new_keys_from_defaults(tmp_path, capsys):
    argv = ["--ckpt-dir", str(tmp_path)]
    _cli([*argv, "--stop-after", "1"], capsys)
    path = os.path.join(tmp_path, "cli_config.json")
    with open(path) as f:
        saved = json.load(f)
    for key in ("protocol", "scenario", "subsample", "dropout", "straggle",
                "partition", "skew", "clock_skew", "scenario_seed"):
        saved.pop(key)
    with open(path, "w") as f:
        json.dump(saved, f)
    run, out = _cli([*argv, "--resume"], capsys)
    assert "resumed" in out and not run.paused
    with pytest.raises(SystemExit):
        _cli([*argv, "--resume", "--protocol", "al"], capsys)
