"""The port's eager ASCII session against the JAX package's, end to end.

The blob3 n=300 data of tests/test_engine.py are made by the reference and
handed to both packages as numpy arrays; both run the same config.

Exactly equal: the components (agent, round), the stop round, the number
of history rounds, the predicted classes and the ledger bits.  Within a
tolerance: the alphas (rtol 1e-5: sums of the ignorance vector taken in
other orders) and the final ignorance vector (atol 1e-6, on entries of
order 1/n = 5e-3).

One divergence is known and checked for what it is.  The tree's split
search takes an argmin over Gini scores; where candidates tie in exact
arithmetic (a pure node, an empty child), the reference's float32 rounding
noise decides, and can even score a split below 0, which exact arithmetic
never does.  The port sums its histograms in float64, so on such a hop it
may fit another of the tied trees.  ``_first_noise_decided_hop`` replays the
reference hop by hop, fits both trees on the reference's own weights, and
reports the first hop whose rewards differ; the test then requires that
the reference's fit there chose a negative (noise-made) score, and holds
the alphas to the tolerance on every hop before it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as J
from repro.core import protocol as JP
from repro.core import scores as jsc
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.learners.base import Learner as JLearner
from repro.learners.logistic import LogisticRegression as JLogistic
from repro.learners.tree import DecisionTree as JTree
from repro_torch.convert import state_from_reference
from repro_torch.core import engine as T
from repro_torch.core import protocol as TP
from repro_torch.kernels import ignorance as ig
from repro_torch.launch import session as cli
from repro_torch.learners.base import Learner as TLearner
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from repro_torch.learners.tree import DecisionTree as TTree
from test_torch_learners import reference_chosen_scores

CPU = "cpu"


@pytest.fixture(scope="module")
def blob():
    ds = blob_fig3(jax.random.key(0), n=300)
    tr, te = train_test_split(0, 300)
    Xs = vertical_split(ds.X, ds.splits)
    return ([np.array(x[tr]) for x in Xs], np.array(ds.classes[tr]),
            [np.array(x[te]) for x in Xs], np.array(ds.classes[te]),
            ds.num_classes)


def _jax_session(Xtr, ctr, k, variant="ascii", rounds=3, transport=None,
                 **cfg):
    scheduler, upstream = J.variant_setup(variant, 3)
    proto = J.Protocol(J.SessionConfig(num_classes=k, max_rounds=rounds,
                                       upstream=upstream, **cfg),
                       scheduler=scheduler,
                       transport=transport or J.MeteredTransport())
    eps = J.endpoints_for([JTree(depth=3, num_thresholds=8) for _ in Xtr],
                          [jnp.asarray(x) for x in Xtr])
    return proto.start(jax.random.key(2), eps, jnp.asarray(ctr))


def _torch_endpoints(Xtr):
    return T.endpoints_for([TTree(depth=3, num_thresholds=8, device=CPU)
                            for _ in Xtr], [torch.from_numpy(x) for x in Xtr])


def _torch_session(Xtr, ctr, k, variant="ascii", rounds=3, transport=None,
                   **cfg):
    scheduler, upstream = T.variant_setup(variant, 3)
    proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=rounds,
                                       upstream=upstream, **cfg),
                       scheduler=scheduler,
                       transport=transport or T.MeteredTransport(), device=CPU)
    return proto.start(2, _torch_endpoints(Xtr), torch.from_numpy(ctr))


def _assert_sessions_match(js, ts, Xte):
    jc, tc = js.state.components, ts.state.components
    assert [(c.agent, c.round) for c in tc] == [(c.agent, c.round) for c in jc]
    assert (ts.state.round, ts.state.stopped) == (js.state.round,
                                                  js.state.stopped)
    assert len(ts.state.history) == len(js.state.history)
    np.testing.assert_allclose([c.alpha for c in tc], [c.alpha for c in jc],
                               rtol=1e-5)
    np.testing.assert_allclose(ts.state.w.numpy(), np.asarray(js.state.w),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        ts.fitted().predict([torch.from_numpy(x) for x in Xte]).numpy(),
        np.asarray(js.fitted().predict([jnp.asarray(x) for x in Xte])))
    if isinstance(js.transport, J.MeteredTransport):
        assert ts.transport.log.bits_by_kind() == js.transport.bits_by_kind()
        assert ts.transport.total_bits == js.transport.total_bits


def _first_noise_decided_hop(Xtr, ctr, k, variant, rounds=3):
    """Replay the reference session hop by hop (its own scores module and
    trees), fitting the port's tree on the same weights at every hop.
    Returns the index of the first hop where the two trees' rewards differ
    (None if none does), after asserting that the reference's fit there was
    decided by rounding noise."""
    scheduler, upstream = J.variant_setup(variant, 3)
    scheduler.reset()
    jl, tl = JTree(depth=3, num_thresholds=8), TTree(depth=3,
                                                     num_thresholds=8,
                                                     device=CPU)
    c = jnp.asarray(ctr)
    w = jsc.init_ignorance(len(ctr))
    hop = 0
    for t in range(rounds):
        order = scheduler.round_order(t, list(range(len(Xtr))))
        u = jnp.ones_like(w)
        for j, m in enumerate(order):
            X = jnp.asarray(Xtr[m])
            r = jl.reward(jl.fit(None, X, c, w, k), X, c)
            tp = tl.fit(None, torch.from_numpy(Xtr[m]), torch.from_numpy(ctr),
                        torch.from_numpy(np.array(w)), k)
            r_port = tl.reward(tp, torch.from_numpy(Xtr[m]),
                               torch.from_numpy(ctr))
            if not np.array_equal(np.asarray(r), r_port.numpy()):
                assert reference_chosen_scores(X, c, w, k=k).min() < 0
                return hop
            a, _ = jsc.model_weight(w, r, k, u=u if upstream and j else None)
            if float(a) <= 0:
                return None
            u = jsc.upstream_factor_update(u, a, r, k)
            w = jsc.ignorance_update(w, r, a)
            hop += 1
    return None


@pytest.mark.parametrize("variant", ["ascii", "simple", "random"])
def test_session_matches_reference(blob, variant):
    Xtr, ctr, Xte, _, k = blob
    js = _jax_session(Xtr, ctr, k, variant)
    js.run()
    ts = _torch_session(Xtr, ctr, k, variant)
    ts.run()
    split = _first_noise_decided_hop(Xtr, ctr, k, variant)
    if split is None:
        _assert_sessions_match(js, ts, Xte)
        return
    # a noise-decided split: the exact facts still hold; the float ones
    # hold up to that hop
    jc, tc = js.state.components, ts.state.components
    assert [(c.agent, c.round) for c in tc] == [(c.agent, c.round) for c in jc]
    assert (ts.state.round, ts.state.stopped, len(ts.state.history)) == \
        (js.state.round, js.state.stopped, len(js.state.history))
    assert ts.transport.log.bits_by_kind() == js.transport.bits_by_kind()
    np.testing.assert_allclose([c.alpha for c in tc[:split]],
                               [c.alpha for c in jc[:split]], rtol=1e-5)
    np.testing.assert_array_equal(
        ts.fitted().predict([torch.from_numpy(x) for x in Xte]).numpy(),
        np.asarray(js.fitted().predict([jnp.asarray(x) for x in Xte])))


class _JConst(JLearner):
    """Always predicts class 0: its weighted accuracy after a good head's
    hop is below 1/K, so its alpha is negative."""

    def fit(self, key, X, classes, w, num_classes):
        return {"c": jnp.zeros((), jnp.int32)}

    def predict(self, params, X):
        return jnp.zeros((X.shape[0],), jnp.int32) + params["c"]


class _TConst(TLearner):
    device = CPU

    def fit(self, key, X, classes, w, num_classes):
        return {"c": torch.zeros((), dtype=torch.int32)}

    def predict(self, params, X):
        return torch.zeros((X.shape[0],), dtype=torch.int32) + params["c"]


def test_negative_alpha_stop_matches_reference(blob):
    """A constant agent stops the session mid-round at the same hop
    (Algorithm 1 line 8: alpha <= 0)."""
    Xtr, ctr, Xte, _, k = blob
    cfg = dict(num_classes=k, max_rounds=3)
    jf = J.Protocol(J.SessionConfig(**cfg), transport=J.MeteredTransport())
    js = jf.start(jax.random.key(2), J.endpoints_for(
        [JTree(depth=3, num_thresholds=8), _JConst()],
        [jnp.asarray(x) for x in Xtr[:2]]), jnp.asarray(ctr))
    js.run()
    tf = T.Protocol(T.SessionConfig(**cfg), transport=T.MeteredTransport(),
                    device=CPU)
    ts = tf.start(2, T.endpoints_for(
        [TTree(depth=3, num_thresholds=8, device=CPU), _TConst()],
        [torch.from_numpy(x) for x in Xtr[:2]]), torch.from_numpy(ctr))
    ts.run()
    assert js.state.stopped and js.state.round == 1
    assert len(js.state.history[0]["alphas"]) == 2
    _assert_sessions_match(js, ts, Xte[:2])
    np.testing.assert_allclose(ts.state.history[0]["alphas"],
                               js.state.history[0]["alphas"], rtol=1e-5)


def test_exact_reweight_and_cv_stop_match_reference(blob):
    """The exact exponential-loss reweight (plain torch in both packages)
    and the paper's CV stop, through the back-compat ``fit``.  Logistic
    agents: the CV stop reads held-out accuracy, and a tree's held-out
    predictions depend on its noise-decided ties (see the module note)."""
    Xtr, ctr, Xte, cte, k = blob
    jcfg = JP.ASCIIConfig(num_classes=k, max_rounds=6, cv_fraction=0.3,
                          cv_patience=1, exact_reweight=True)
    tcfg = TP.ASCIIConfig(num_classes=k, max_rounds=6, cv_fraction=0.3,
                          cv_patience=1, exact_reweight=True)
    jf = JP.fit(jax.random.key(1), [jnp.asarray(x) for x in Xtr],
                jnp.asarray(ctr), [JLogistic(steps=60)] * 4, jcfg)
    tf = TP.fit(1, [torch.from_numpy(x) for x in Xtr], torch.from_numpy(ctr),
                [TLogistic(steps=60, device=CPU)] * 4, tcfg, device=CPU)
    assert [(c.agent, c.round) for c in tf.components] == \
        [(c.agent, c.round) for c in jf.components]
    np.testing.assert_allclose([c.alpha for c in tf.components],
                               [c.alpha for c in jf.components], rtol=1e-5)
    assert [h.get("val_acc") for h in tf.history] == \
        [h.get("val_acc") for h in jf.history]
    np.testing.assert_array_equal(
        tf.predict([torch.from_numpy(x) for x in Xte]).numpy(),
        np.asarray(jf.predict([jnp.asarray(x) for x in Xte])))


def test_baselines_match_reference(blob):
    """Single-agent AdaBoost (SAMME) and Ensemble-AdaBoost."""
    Xtr, ctr, Xte, _, k = blob
    jcfg, tcfg = JP.ASCIIConfig(num_classes=k, max_rounds=3), \
        TP.ASCIIConfig(num_classes=k, max_rounds=3)
    jl, tl = JTree(depth=3, num_thresholds=8), TTree(depth=3,
                                                     num_thresholds=8,
                                                     device=CPU)
    js = JP.fit_single_agent_adaboost(jax.random.key(0), jnp.asarray(Xtr[0]),
                                      jnp.asarray(ctr), jl, jcfg)
    ts = TP.fit_single_agent_adaboost(0, torch.from_numpy(Xtr[0]),
                                      torch.from_numpy(ctr), tl, tcfg,
                                      device=CPU)
    np.testing.assert_array_equal(
        ts.predict([torch.from_numpy(Xte[0])]).numpy(),
        np.asarray(js.predict([jnp.asarray(Xte[0])])))
    je = JP.fit_ensemble_adaboost(jax.random.key(0),
                                  [jnp.asarray(x) for x in Xtr],
                                  jnp.asarray(ctr), [jl] * 4, jcfg)
    te = TP.fit_ensemble_adaboost(0, [torch.from_numpy(x) for x in Xtr],
                                  torch.from_numpy(ctr), [tl] * 4, tcfg,
                                  device=CPU)
    np.testing.assert_array_equal(
        te.predict([torch.from_numpy(x) for x in Xte]).numpy(),
        np.asarray(je.predict([jnp.asarray(x) for x in Xte])))


def test_metered_is_passive_and_books_fig4_bits(blob):
    """Metered and in-process sessions are bit-identical, and the ledger
    reproduces the Fig. 4 formula: (labels + sample IDs) to M-1 agents,
    then (n + 1) floats per hop, plus one [n, K] block per remote agent at
    prediction."""
    Xtr, ctr, Xte, _, k = blob
    plain = _torch_session(Xtr, ctr, k, transport=T.InProcessTransport(),
                           stop_on_negative_alpha=False, rounds=2)
    plain.run()
    metered = _torch_session(Xtr, ctr, k, stop_on_negative_alpha=False,
                             rounds=2)
    metered.run()
    assert torch.equal(plain.state.w, metered.state.w)
    assert [(c.agent, c.round, c.alpha) for c in plain.state.components] == \
        [(c.agent, c.round, c.alpha) for c in metered.state.components]
    assert plain.state.history == metered.state.history
    n, m = len(ctr), len(Xtr)
    hops = len(metered.state.components)
    log = metered.transport.log
    assert log.total_bits == (m - 1) * 2 * n * 32 + hops * (n + 1) * 32
    kinds = log.bits_by_kind()
    assert kinds["ignorance"] == hops * n * 32
    assert kinds["model_weight"] == hops * 32
    Xte_t = [torch.from_numpy(x) for x in Xte]
    preds = metered.predict_distributed(Xte_t)
    assert log.bits_by_kind()["score_block"] == (m - 1) * len(Xte[0]) * k * 32
    assert torch.equal(preds, metered.fitted().predict(Xte_t))


def test_every_standard_hop_goes_through_the_kernel_wrapper(blob,
                                                            monkeypatch):
    """Each transport sends each standard hop through the kernel module's
    wrappers (plain version on the CPU); exact-reweight hops do not."""
    Xtr, ctr, _, _, k = blob
    calls = []
    real = ig.ignorance_update
    monkeypatch.setattr(ig, "ignorance_update",
                        lambda *a: calls.append(1) or real(*a))
    for transport in (T.InProcessTransport(), T.MeteredTransport(),
                      T.MeshRingTransport()):
        calls.clear()
        s = _torch_session(Xtr, ctr, k, transport=transport, rounds=2)
        s.run()
        assert len(calls) == len(s.state.components) > 0
    calls.clear()
    s = _torch_session(Xtr, ctr, k, rounds=2, exact_reweight=True)
    s.run()
    assert calls == [] and len(s.state.components) > 0


@pytest.mark.parametrize("variant", ["ascii", "random"])
def test_checkpoint_and_resume_bit_exact(blob, tmp_path, variant):
    Xtr, ctr, Xte, _, k = blob
    full = _torch_session(Xtr, ctr, k, variant, rounds=4)
    full.run()
    part = _torch_session(Xtr, ctr, k, variant, rounds=4)
    part.step()
    part.step()
    part.checkpoint(str(tmp_path))
    scheduler, upstream = T.variant_setup(variant, 3)
    resumed = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=4,
                                         upstream=upstream),
                         scheduler=scheduler, device=CPU).resume(
        str(tmp_path), _torch_endpoints(Xtr), torch.from_numpy(ctr))
    assert resumed.state.round == 2
    resumed.run()
    assert torch.equal(resumed.state.w, full.state.w)
    assert [(c.agent, c.round, c.alpha) for c in resumed.state.components] \
        == [(c.agent, c.round, c.alpha) for c in full.state.components]
    assert resumed.state.history == full.state.history
    np.testing.assert_array_equal(resumed.state.key, full.state.key)
    Xte_t = [torch.from_numpy(x) for x in Xte]
    assert torch.equal(resumed.fitted().predict(Xte_t),
                       full.fitted().predict(Xte_t))


def test_state_from_reference_resumes_and_predicts(blob, tmp_path):
    """A session the reference paused after two rounds is read by the port
    with numpy alone, resumed, and finished; it matches the reference's own
    resumed run, and a finished reference session predicts the same classes
    in the port."""
    Xtr, ctr, Xte, _, k = blob
    ref = _jax_session(Xtr, ctr, k, rounds=4)
    ref.step()
    ref.step()
    ref.checkpoint(str(tmp_path))
    ref_key = np.asarray(jax.random.key_data(ref.state.key))
    ref.run()
    state = state_from_reference(str(tmp_path), device=CPU)
    np.testing.assert_array_equal(state.key, ref_key)
    port = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=4),
                      transport=T.MeteredTransport(), device=CPU)
    resumed = port.resume_state(state, _torch_endpoints(Xtr),
                                torch.from_numpy(ctr))
    assert resumed.state.round == 2
    resumed.run()
    jc, tc = ref.state.components, resumed.state.components
    assert [(c.agent, c.round) for c in tc] == [(c.agent, c.round) for c in jc]
    np.testing.assert_allclose([c.alpha for c in tc], [c.alpha for c in jc],
                               rtol=1e-5)
    np.testing.assert_allclose(resumed.state.w.numpy(),
                               np.asarray(ref.state.w), atol=1e-6, rtol=0)
    Xte_t = [torch.from_numpy(x) for x in Xte]
    np.testing.assert_array_equal(
        resumed.fitted().predict(Xte_t).numpy(),
        np.asarray(ref.fitted().predict([jnp.asarray(x) for x in Xte])))
    # a finished reference session predicts the same in the port
    ref.checkpoint(str(tmp_path / "done"))
    done = state_from_reference(str(tmp_path / "done"), device=CPU)
    fitted = T.FittedASCII(done.components,
                           [TTree(depth=3, num_thresholds=8, device=CPU)] * 4,
                           k)
    np.testing.assert_array_equal(
        fitted.predict(Xte_t).numpy(),
        np.asarray(ref.fitted().predict([jnp.asarray(x) for x in Xte])))


def test_cli_runs_pauses_and_resumes(tmp_path, capsys):
    args = ["--device", CPU, "--n", "300", "--rounds", "4"]
    full = cli.run(cli.parser().parse_args(args))
    out = capsys.readouterr().out
    assert full.line.startswith("blob3,ascii,metered,rounds=4,components=")
    assert ",acc=" in full.line and ",bits=" in full.line
    assert full.line in out and "serve: acc=" in out
    ckpt = ["--ckpt-dir", str(tmp_path)]
    paused = cli.run(cli.parser().parse_args(args + ckpt + ["--stop-after",
                                                           "2"]))
    assert paused.paused and paused.session.state.round == 2
    resumed = cli.run(cli.parser().parse_args(args + ckpt + ["--resume"]))
    assert torch.equal(resumed.session.state.w, full.session.state.w)
    with pytest.raises(SystemExit):
        cli.run(cli.parser().parse_args(args + ckpt + ["--resume",
                                                       "--seed", "1"]))


def test_entry_points_raise_without_card(blob):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    Xtr, ctr, _, _, k = blob
    with pytest.raises(RuntimeError):
        T.Protocol(T.SessionConfig(num_classes=k))
    with pytest.raises(RuntimeError):
        T.SessionState.restore("unused")
    with pytest.raises(RuntimeError):
        state_from_reference("unused")
    with pytest.raises(RuntimeError):
        cli.run(cli.parser().parse_args([]))


def test_later_slice_arguments_raise(blob):
    """Every later slice of the port is in: the mesh ring (its hops run
    as without a mesh; ``ring_step`` needs one, and runs over a world in
    tests/test_torch_collectives.py).  Telemetry (tests/test_torch_telemetry.py), the wire
    channel (tests/test_torch_comm_session.py), the control plane with the
    async variant (tests/test_torch_control.py), the compiled backend's
    sequential and async-stale lowerings (tests/test_torch_compiled.py,
    tests/test_torch_compiled_async.py) and the scenarios with the
    protocol variants and their hops (tests/test_torch_scenarios.py) are
    ported: their arguments construct, and the compiled async run fits."""
    from repro_torch.comm import BudgetedTransport, BudgetSpec
    from repro_torch.control import AdaptiveController, ServeController
    from repro_torch.learners.logistic import LogisticRegression
    from repro_torch.scenarios import PRESETS, FedAvgVariant
    Xtr, ctr, _, _, k = blob
    cfg = T.SessionConfig(num_classes=k)
    from repro_torch.telemetry import Telemetry
    T.Protocol(cfg, device=CPU, telemetry=Telemetry())
    T.Protocol(cfg, device=CPU, scenario=PRESETS["churn"],
               variant=FedAvgVariant())
    T.Protocol(cfg, device=CPU, backend="compiled")
    fitted = T.Protocol(cfg, scheduler=T.AsyncStaleScheduler(), device=CPU,
                        backend="compiled").fit(
        0, T.endpoints_for([LogisticRegression(steps=2, device=CPU)
                            for _ in Xtr],
                           [torch.from_numpy(x) for x in Xtr]),
        torch.from_numpy(ctr))
    assert fitted.history
    for kwargs in ({"controller": AdaptiveController()},
                   {"serve_controller": ServeController()}):
        T.MeteredTransport(**kwargs)
        BudgetedTransport(BudgetSpec(), **kwargs)
    eps = T.endpoints_for([LogisticRegression(steps=2, device=CPU)
                           for _ in Xtr], [torch.from_numpy(x) for x in Xtr])
    for transport in (T.MeteredTransport(), BudgetedTransport(BudgetSpec())):
        transport.bind(eps)
        out = transport.ship(eps[1], eps[0], torch.zeros(3), T.GradientMsg)
        assert out.shape == (3,)
    with pytest.raises(SystemExit):
        cli.run(cli.parser().parse_args(["--device", CPU, "--dp-epsilon",
                                         "1", "--accountant",
                                         "subsampled-rdp"]))
    assert T.variant_setup("async")[0].stale
    from repro_torch.sharding.context import AbstractMesh
    mesh = AbstractMesh((2, 1), ("agent", "data"))
    runs = [_torch_session(Xtr, ctr, k, transport=T.MeshRingTransport(
        mesh=m)) for m in (mesh, None)]
    for s in runs:
        s.run()
    assert [(c.agent, c.round, c.alpha) for c in runs[0].state.components] \
        == [(c.agent, c.round, c.alpha) for c in runs[1].state.components]
    assert torch.equal(runs[0].state.w, runs[1].state.w)
    assert runs[0].state.round == runs[1].state.round
    with pytest.raises(ValueError, match="needs a mesh"):
        T.MeshRingTransport().ring_step(torch.ones(2, 4), torch.ones(2, 4),
                                        torch.ones(2))
