"""The port's random learners and the classifier against the JAX package's.

The reference draws from the per-fit subkey its session hands a learner;
the port draws from a ``FitDraws``.  ``_ReplayFit`` (tests/
test_torch_comm_session.py) hands the port the reference's own draws from
the same subkey: the MLP's init normals and minibatch rows, the forest's
Poisson counts and feature permutations.  The neural backbone's init is
carried across with ``convert.neural_params_from_numpy`` instead.

Tolerances, each stated where it is held:
  * MLP: the init equal bits; the params after 20 steps (full batch and
    minibatch) within atol 1e-5 + rtol 1e-5 (the reference runs the fit as
    one XLA program, the port op by op; AdamW's normalized steps carry the
    sums' last-ulp differences);
  * forest: the bootstrap counts and columns equal; each tree equal, or
    parted at a split that float32 noise decided (the tree rule of
    tests/test_torch_session.py); predictions equal where no such tree
    votes otherwise;
  * classifier and neural backbone (2 layers at narrow width): logits
    within 1e-5 (apply) and 1e-4 (after 3 AdamW steps) of max|logits|;
  * sessions (forest, MLP, the heterogeneous tree + logistic + MLP with
    the CV stop): components, stop round, validation accuracies and every
    ledger entry equal, alphas rtol 1e-5, w atol 1e-6, predictions equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.core import engine as J
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.learners.forest import RandomForest as JForest
from repro.learners.logistic import LogisticRegression as JLogistic
from repro.learners.mlp import MLP as JMLP
from repro.learners.neural import NeuralBackbone as JNeural
from repro.learners.tree import DecisionTree as JTree
from repro.models import classifier as jclassifier
from repro_torch.comm.draws import ChannelDraws, FitDraws, fit_draws
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.convert import neural_params_from_numpy
from repro_torch.core import engine as T
from repro_torch.learners.forest import RandomForest as TForest
from repro_torch.learners.forest import num_features
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from repro_torch.learners.mlp import MLP as TMLP
from repro_torch.learners.neural import NeuralBackbone as TNeural
from repro_torch.learners.tree import DecisionTree as TTree
from repro_torch.models import classifier as tclassifier
from repro_torch.models import transformer as ttransformer
from test_torch_comm_session import ReplayDraws, _assert_tied_split, _ReplayFit

CPU = "cpu"


def _data(n=200, p=6, k=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p)).astype(np.float32)
    c = rng.integers(0, k, n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    return X, c, (w / w.sum()).astype(np.float32), k


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ====================================================================== MLP
@pytest.mark.parametrize("hidden", [(16, 8), (32,), (64, 32)])
def test_mlp_init_equals_reference_bits(hidden):
    X, c, w, k = _data()
    key = jax.random.key(3)
    want = JMLP(hidden=hidden).core(k).init(key, X.shape[1:])
    got = TMLP(hidden=hidden, device=CPU).core(k).init(_ReplayFit(key),
                                                       X.shape[1:])
    assert len(got) == len(want) == len(hidden) + 1
    for j, t in zip(want, got):
        for name in ("w", "b"):
            assert t[name].dtype == torch.float32
            np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]))


@pytest.mark.parametrize("batch_size", [None, 32])
def test_mlp_fit_tracks_reference(batch_size):
    """20 AdamW steps (full batch, or minibatches of 32 rows drawn by the
    reference's keys): every param within atol 1e-5 + rtol 1e-5, the
    predicted classes equal."""
    X, c, w, k = _data()
    key = jax.random.key(3)
    jl = JMLP(hidden=(16, 8), steps=20, batch_size=batch_size)
    tl = TMLP(hidden=(16, 8), steps=20, batch_size=batch_size, device=CPU)
    jp = jl.fit(key, *map(jnp.asarray, (X, c, w)), k)
    tp = tl.fit(_ReplayFit(key), *_t(X, c, w), k)
    for j, t in zip(jp, tp):
        for name in ("w", "b"):
            np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tl.predict(tp, torch.from_numpy(X)).numpy(),
                                  np.asarray(jl.predict(jp, jnp.asarray(X))))


def test_mlp_minibatch_rows_are_the_reference_draws():
    """Minibatch step i takes the rows of the reference's randint under
    fold_in(split(key)[0], i); the default draws are a pure function of
    the fit's coordinates and the step."""
    key = jax.random.key(5)
    replay = _ReplayFit(key)
    for i in (0, 1, 7):
        want = np.asarray(jax.random.randint(jax.random.fold_in(
            jax.random.split(key)[0], i), (32,), 0, 200))
        np.testing.assert_array_equal(replay.randint((32,), 200, i).numpy(),
                                      want)
    a = ChannelDraws().fit(np.array([0, 5], np.uint32), 2, 1)
    b = ChannelDraws().fit(np.array([0, 5], np.uint32), 2, 1)
    assert torch.equal(a.randint((32,), 200, 3), b.randint((32,), 200, 3))
    assert not torch.equal(a.randint((32,), 200, 3),
                           a.randint((32,), 200, 4))


def test_mlp_core_is_the_learner():
    X, c, w, k = _data()
    tl = TMLP(hidden=(16, 8), steps=5, device=CPU)
    core = tl.core(k)
    assert tl.functional and core.num_classes == k
    draws = ChannelDraws().fit(np.array([0, 1], np.uint32), 0, 0)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(c).long(),
                                         k).float()
    a = core.fit(core.init(draws, X.shape[1:]), draws, *_t(X), onehot,
                 torch.from_numpy(w))
    b = tl.fit(draws, *_t(X, c, w), k)
    for la, lb in zip(a, b):
        assert all(torch.equal(la[n], lb[n]) for n in ("w", "b"))
    assert torch.equal(core.predict(a, torch.from_numpy(X)),
                       tl.predict(b, torch.from_numpy(X)))


# =================================================================== forest
def test_forest_matches_reference_up_to_noise_decided_splits():
    ds = blob_fig3(jax.random.key(0), n=600)
    X, c, k = np.array(ds.X[:, :5]), np.array(ds.classes), ds.num_classes
    w = np.random.default_rng(1).random(len(c)).astype(np.float32)
    w /= w.sum()
    key = jax.random.key(5)
    jf = JForest(num_trees=8, depth=4)
    tf = TForest(num_trees=8, depth=4, device=CPU)
    jp = jf.fit(key, *map(jnp.asarray, (X, c, w)), k)
    replay = _ReplayFit(key, trees=8)
    tp = tf.fit(replay, *_t(X, c, w), k)
    (jtrees, jcols), (ttrees, tcols) = jp["params"], tp["params"]
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    assert tcols.shape == (8, num_features(0.7, 5)) and tp["num_classes"] == k
    parted = []
    for t in range(8):
        jt = {n: np.asarray(v[t]) for n, v in jtrees.items()}
        tt = {n: v[t] for n, v in ttrees.items()}
        if all(np.array_equal(jt[n], tt[n].numpy()) for n in jt):
            continue
        parted.append(t)
        cols = tcols[t].numpy()
        counts = replay.poisson((len(c),), t).numpy().astype(np.float32)
        _assert_tied_split(X[:, cols], c, w * counts, jt, tt, k, depth=4,
                           q=16)
    jpred = np.asarray(jf.predict(jp, jnp.asarray(X)))
    tpred = tf.predict(tp, torch.from_numpy(X)).numpy()
    if not parted:
        np.testing.assert_array_equal(tpred, jpred)
        return
    # a row may differ only where a parted tree votes otherwise
    votes = {t: (JTree(depth=4).predict(
        {n: v[t] for n, v in jtrees.items()},
        jnp.asarray(X[:, np.asarray(jcols[t])])),
        TTree(depth=4, device=CPU).predict(
            {n: v[t] for n, v in ttrees.items()},
            torch.from_numpy(X[:, tcols[t].numpy()]))) for t in parted}
    differ = np.flatnonzero(tpred != jpred)
    for i in differ:
        assert any(int(a[i]) != int(b[i]) for a, b in votes.values()), i


def test_forest_counts_and_features():
    """Banker's rounding of the feature count, as the reference's Python
    ``round``; the bootstrap's counts are integers from the draws."""
    assert [num_features(0.5, p) for p in (1, 3, 5, 7)] == [1, 2, 2, 4]
    assert num_features(0.7, 10) == 7 and num_features(0.01, 10) == 1
    draws = FitDraws((1, 2, 3))
    counts = draws.poisson((5000,), 2)
    assert counts.dtype == torch.int32 and counts.min() >= 0
    assert abs(float(counts.float().mean()) - 1.0) < 0.05
    assert torch.equal(counts, draws.poisson((5000,), 2))
    perm = draws.permutation(9, 4)
    assert sorted(perm.tolist()) == list(range(9))


def test_fit_draws_accepts_seeds_and_refuses_none():
    a, b = fit_draws(7), fit_draws(np.array([0, 7], np.uint32))
    assert torch.equal(a.normal((4,), 1), b.normal((4,), 1))
    assert not torch.equal(a.normal((4,), 1), a.normal((4,), 2))
    assert fit_draws(a) is a
    with pytest.raises(ValueError):
        fit_draws(None)
    # init, minibatch, bootstrap and feature draws come from separate
    # streams: the same index gives unrelated numbers
    g = {s: a.generator(s, 0).initial_seed() for s in (3, 4, 5, 6)}
    assert len(set(g.values())) == 4


# ======================================================== classifier, neural
def _narrow(arch="qwen3-0.6b"):
    return JARCHS[arch].reduced(), TARCHS[arch].reduced()


def test_classifier_apply_matches_reference():
    jcfg, tcfg = _narrow()
    params = jclassifier.init_params(jax.random.key(1), jcfg, 4)
    ported = neural_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                      device=CPU)
    assert ported["cls_head"]["w"].shape == (tcfg.d_model, 4)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (3, 9))
    want = np.asarray(jclassifier.apply(params, {"tokens": jnp.asarray(toks)},
                                        jcfg))
    got = tclassifier.apply(ported, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.dtype == torch.float32 and got.shape == (3, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_hidden_states_is_the_forward_without_its_head():
    _, tcfg = _narrow()
    params = ttransformer.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, tcfg.vocab_size, (2, 5),
                         generator=torch.Generator().manual_seed(1))
    logits, _, _ = ttransformer.forward(params, {"tokens": toks}, tcfg)
    h = ttransformer.hidden_states(
        params, ttransformer.embed_inputs(params, {"tokens": toks}, tcfg),
        tcfg)
    assert torch.equal(h @ params["embed"]["embedding"].T, logits)


@pytest.mark.parametrize("steps", [0, 3])
def test_neural_core_fit_tracks_reference(steps):
    """From the reference's init carried across: the logits after
    ``steps`` full-batch AdamW steps within 1e-4 of max|logits|."""
    jcfg, tcfg = _narrow()
    X, c, w, k = _data(n=64, p=5)
    key = jax.random.key(1)
    jcore = JNeural(cfg=jcfg, steps=steps).core(k)
    init = jcore.init(key, X.shape[1:])
    jp = jcore.fit(init, key, jnp.asarray(X),
                   jax.nn.one_hot(jnp.asarray(c), k), jnp.asarray(w))
    tcore = TNeural(cfg=tcfg, steps=steps, device=CPU).core(k)
    tp = tcore.fit(neural_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, init), device=CPU), None,
        torch.from_numpy(X),
        torch.nn.functional.one_hot(torch.from_numpy(c).long(), k).float(),
        torch.from_numpy(w))
    want = np.asarray(jcore.logits(jp, jnp.asarray(X)))
    got = tcore.logits(tp, torch.from_numpy(X)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_neural_backbone_fits_from_its_draws_and_refuses_flash():
    _, tcfg = _narrow()
    X, c, w, k = _data(n=48, p=5)
    nb = TNeural(cfg=tcfg, steps=2, device=CPU)
    draws = ChannelDraws().fit(np.array([0, 3], np.uint32), 1, 0)
    a = nb.fit(draws, *_t(X, c, w), k)
    b = nb.fit(draws, *_t(X, c, w), k)
    assert torch.equal(a["proj"], b["proj"])
    assert a["proj"].shape == (5, tcfg.d_model)
    pred = nb.predict(a, torch.from_numpy(X))
    assert pred.shape == (48,) and int(pred.max()) < k
    with pytest.raises(ValueError):
        TNeural(cfg=tcfg.with_overrides(use_flash=True), steps=1,
                device=CPU).fit(draws, *_t(X, c, w), k)
    with pytest.raises(NotImplementedError):     # decoder-only configs
        TNeural(cfg=TARCHS["whisper-tiny"].reduced(), steps=1,
                device=CPU).fit(draws, *_t(X, c, w), k)


# ================================================================= sessions
def _blob(n, splits=None, seed=0):
    ds = blob_fig3(jax.random.key(seed), n=n)
    tr, te = train_test_split(0, n)
    Xs = vertical_split(ds.X, splits or ds.splits)
    return ([np.array(x[tr]) for x in Xs], np.array(ds.classes[tr]),
            [np.array(x[te]) for x in Xs], np.array(ds.classes[te]),
            ds.num_classes)


SESSIONS = {
    "forest": lambda: (_blob(300), dict(max_rounds=3), None, 8,
                       lambda: [JForest(num_trees=8, depth=4)
                                for _ in range(4)],
                       lambda: [TForest(num_trees=8, depth=4, device=CPU)
                                for _ in range(4)]),
    "mlp": lambda: (_blob(300), dict(max_rounds=3), None, None,
                    lambda: [JMLP(hidden=(32, 16), steps=60)
                             for _ in range(4)],
                    lambda: [TMLP(hidden=(32, 16), steps=60, device=CPU)
                             for _ in range(4)]),
    # examples/heterogeneous_agents.py: blocks (2, 3, 3), CV stop
    "heterogeneous": lambda: (
        _blob(900, (2, 3, 3), seed=3),
        dict(max_rounds=8, cv_patience=2), 0.2, None,
        lambda: [JTree(depth=4), JLogistic(steps=200),
                 JMLP(hidden=(64, 32), steps=200)],
        lambda: [TTree(depth=4, device=CPU), TLogistic(steps=200, device=CPU),
                 TMLP(hidden=(64, 32), steps=200, device=CPU)]),
}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_matches_reference(name):
    (Xtr, ctr, Xte, _, k), cfg, holdout, trees, jls, tls = SESSIONS[name]()
    key = jax.random.key(2)
    jX, jc = [jnp.asarray(x) for x in Xtr], jnp.asarray(ctr)
    tX, tc = _t(*Xtr), torch.from_numpy(ctr)
    jval = tval = None
    if holdout:
        jX, jc, jXv, jcv = J.holdout_split(jX, jc, holdout)
        tX, tc, tXv, tcv = T.holdout_split(tX, tc, holdout)
        jval, tval = (jXv, jcv), (tXv, tcv)
    js = J.Protocol(J.SessionConfig(num_classes=k, **cfg),
                    transport=J.MeteredTransport()).start(
        key, J.endpoints_for(jls(), jX), jc, validation=jval)
    js.run()
    ts = T.Protocol(T.SessionConfig(num_classes=k, **cfg),
                    transport=T.MeteredTransport(), device=CPU,
                    draws=ReplayDraws(key, len(Xtr), trees=trees)).start(
        2, T.endpoints_for(tls(), tX), tc, validation=tval)
    ts.run()
    jcs, tcs = js.state.components, ts.state.components
    assert [(x.agent, x.round) for x in tcs] == [(x.agent, x.round)
                                                for x in jcs]
    assert (ts.state.round, ts.state.stopped) == (js.state.round,
                                                  js.state.stopped)
    assert [h.get("val_acc") for h in ts.state.history] == \
        [h.get("val_acc") for h in js.state.history]
    assert ts.transport.log.entries == js.transport.log.entries
    np.testing.assert_allclose([x.alpha for x in tcs],
                               [x.alpha for x in jcs], rtol=1e-5)
    np.testing.assert_allclose(ts.state.w.numpy(), np.asarray(js.state.w),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        ts.fitted().predict(_t(*Xte)).numpy(),
        np.asarray(js.fitted().predict([jnp.asarray(x) for x in Xte])))
    if holdout:
        assert ts.state.stopped and ts.state.round < cfg["max_rounds"]


@pytest.mark.parametrize("name", ["forest", "mlp"])
def test_pause_and_resume_bit_exact(tmp_path, name):
    """The default draws are indexed by the fit's coordinates: a session
    paused after a round and resumed draws what the uninterrupted one drew,
    and ends with its bits."""
    (Xtr, ctr, Xte, _, k), cfg, _, _, _, tls = SESSIONS[name]()

    def proto():
        return T.Protocol(T.SessionConfig(num_classes=k, **cfg),
                          transport=T.MeteredTransport(), device=CPU)

    full = proto().start(4, T.endpoints_for(tls(), _t(*Xtr)),
                         torch.from_numpy(ctr))
    full.run()
    part = proto().start(4, T.endpoints_for(tls(), _t(*Xtr)),
                         torch.from_numpy(ctr))
    part.step()
    part.checkpoint(str(tmp_path))
    resumed = proto().resume(str(tmp_path), T.endpoints_for(tls(), _t(*Xtr)),
                             torch.from_numpy(ctr))
    assert resumed.state.round == 1
    resumed.run()
    assert torch.equal(resumed.state.w, full.state.w)
    assert [(x.agent, x.round, x.alpha) for x in resumed.state.components] \
        == [(x.agent, x.round, x.alpha) for x in full.state.components]
    assert torch.equal(resumed.fitted().predict(_t(*Xte)),
                       full.fitted().predict(_t(*Xte)))


# ================================================================ the card
@pytest.mark.gpu
def test_random_learners_on_card_track_the_cpu():
    """The MLP fitted on the card and on the CPU from the same draws:
    logits within 1e-4 of max|logits| (cuBLAS and the CPU's BLAS sum in
    other orders), classes equal where the top-2 gap exceeds that; a
    forest session on the card the CPU's bits (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    X, c, w, k = _data(n=2000, p=20, k=5)
    draws = ChannelDraws().fit(np.array([0, 9], np.uint32), 0, 0)
    out = {}
    for dev in ("cuda", CPU):
        tl = TMLP(hidden=(64, 32), steps=50, device=dev)
        params = tl.fit(draws, *_t(X, c, w), k)
        out[dev] = tl.core(k).logits(params, torch.from_numpy(X).to(dev)
                                     ).detach().cpu()
    tol = 1e-4 * float(out[CPU].abs().max())
    assert float((out["cuda"] - out[CPU]).abs().max()) <= tol
    top2 = torch.topk(out[CPU], 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    assert torch.equal(out["cuda"].argmax(-1)[clear],
                       out[CPU].argmax(-1)[clear])
    (Xtr, ctr, _, _, k), cfg, _, _, _, _ = SESSIONS["forest"]()
    states = {}
    for dev in ("cuda", CPU):
        s = T.Protocol(T.SessionConfig(num_classes=k, **cfg),
                       transport=T.MeteredTransport(), device=dev).start(
            0, T.endpoints_for([TForest(num_trees=8, depth=4, device=dev)
                                for _ in Xtr],
                               [torch.from_numpy(x).to(dev) for x in Xtr]),
            torch.from_numpy(ctr).to(dev))
        s.run()
        states[dev] = s
    assert torch.equal(states["cuda"].state.w.cpu(), states[CPU].state.w)
    assert states["cuda"].transport.log.entries == \
        states[CPU].transport.log.entries
