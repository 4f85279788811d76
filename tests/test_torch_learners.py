"""The port's learners against the JAX package's, fitted on the same
weighted data (numpy, from a seed).

Predicted classes must be equal.  Logistic-regression params agree within
atol 1e-5 plus rtol 1e-5: the two autodiff libraries' gradients differ by
about one ulp (matrix products summed in other orders), and AdamW's
normalized step amplifies that over 150 steps: with atol 1e-5 alone, the
bias of seed 1 (|b| ~ 2.9) lands 1.6e-5 away, 5.5e-6 relative.
The bias corrections are float32 in both, as the reference computes them.

Tree params are compared node by node: the leaf classes and training
predictions always, the split feature and threshold (atol 1e-5: two quantile
implementations) wherever the reference's choice was not decided by
rounding noise.  Where candidates tie
in exact arithmetic (a pure node, an empty child), the reference's float32
histogram sums make the tie's winner a matter of rounding, and can score it
below 0, which exact arithmetic never does; the port sums in float64 (see
repro_torch/learners/tree.py) and may pick another of the tied splits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.learners.logistic import LogisticRegression as JLogistic
from repro.learners import tree as jtree
from repro.learners.tree import DecisionTree as JTree
from repro.optim import optimizers as jopt
from repro_torch.convert import params_from_numpy
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from repro_torch.learners.tree import DecisionTree as TTree
from repro_torch.optim import optimizers as topt


def _data(seed, n=240, p=5, k=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, p)) * 2.5
    c = rng.integers(0, k, n)
    X = (centers[c] + rng.normal(size=(n, p))).astype(np.float32)
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    return X, c.astype(np.int32), w


def reference_chosen_scores(X, classes, w, depth=3, q=8, k=10):
    """The Gini score of the split the reference's tree picks at every
    node of every level (repro/learners/tree.py's search, replayed)."""
    n, p = X.shape
    thr = jnp.quantile(X, (jnp.arange(q) + 0.5) / q, axis=0).T
    coh = jax.nn.one_hot(classes, k)
    mask = (X[:, :, None] <= thr[None]).astype(w.dtype)
    node_of = jnp.zeros((n,), jnp.int32)
    chosen = []
    for level in range(depth):
        noh = jax.nn.one_hot(node_of, 2 ** level)
        tot = jnp.einsum("i,im,ik->mk", w, noh, coh)
        left = jnp.einsum("i,im,ipq,ik->mpqk", w, noh, mask, coh)
        score = (jtree._weighted_gini(left) + jtree._weighted_gini(
            tot[:, None, None, :] - left)).reshape(2 ** level, p * q)
        best = jnp.argmin(score, axis=-1)
        chosen.append(np.asarray(score[jnp.arange(2 ** level), best]))
        bt = thr[best // q, best % q]
        right = X[jnp.arange(n), (best // q)[node_of]] > bt[node_of]
        node_of = 2 * node_of + right.astype(jnp.int32)
    return np.concatenate(chosen)


def _fit_both(jl, tl, X, c, w, k):
    jp = jl.fit(jax.random.key(0), jnp.asarray(X), jnp.asarray(c),
                jnp.asarray(w), k)
    tp = tl.fit(None, torch.from_numpy(X), torch.from_numpy(c).long(),
                torch.from_numpy(w), k)
    return jp, tp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logistic_matches_reference(seed):
    X, c, w = _data(seed)
    jl, tl = JLogistic(steps=150), TLogistic(steps=150, device="cpu")
    jp, tp = _fit_both(jl, tl, X, c, w, 3)
    for name in ("w", "b"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        tl.predict(tp, torch.from_numpy(X)).numpy(),
        np.asarray(jl.predict(jp, jnp.asarray(X))))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("depth", [1, 3])
def test_tree_matches_reference(seed, depth):
    X, c, w = _data(seed, k=4)
    jl = JTree(depth=depth, num_thresholds=8)
    tl = TTree(depth=depth, num_thresholds=8, device="cpu")
    jp, tp = _fit_both(jl, tl, X, c, w, 4)
    decided = reference_chosen_scores(jnp.asarray(X), jnp.asarray(c),
                                      jnp.asarray(w), depth=depth, k=4) >= 0
    assert decided[0]
    np.testing.assert_array_equal(tp["feat"].numpy()[decided],
                                  np.asarray(jp["feat"])[decided])
    np.testing.assert_allclose(tp["thr"].numpy()[decided],
                               np.asarray(jp["thr"])[decided], atol=1e-5)
    np.testing.assert_array_equal(tp["leaf"].numpy(), np.asarray(jp["leaf"]))
    assert {k: v.dtype for k, v in tp.items()} == TTree.param_dtypes
    pred = tl.predict(tp, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(pred, np.asarray(jl.predict(jp,
                                                              jnp.asarray(X))))
    r = tl.reward(tp, torch.from_numpy(X), torch.from_numpy(c).long())
    assert r.dtype == torch.float32 and set(r.unique().tolist()) <= {0.0, 1.0}


def test_reference_params_predict_in_the_port():
    """params_from_numpy carries a reference fit into the port, which then
    predicts the reference's classes."""
    X, c, w = _data(5, k=3)
    for jl, tl in ((JTree(depth=3, num_thresholds=8),
                    TTree(depth=3, num_thresholds=8, device="cpu")),
                   (JLogistic(steps=50), TLogistic(steps=50, device="cpu"))):
        jp = jl.fit(jax.random.key(0), jnp.asarray(X), jnp.asarray(c),
                    jnp.asarray(w), 3)
        tp = params_from_numpy(tl, {k: np.array(v) for k, v in jp.items()})
        np.testing.assert_array_equal(
            tl.predict(tp, torch.from_numpy(X)).numpy(),
            np.asarray(jl.predict(jp, jnp.asarray(X))))
    with pytest.raises(ValueError):
        params_from_numpy(tl, {"w": np.zeros((5, 3), np.float32)})


def test_adamw_and_sgd_steps_match_reference():
    """Twenty optimizer steps on fixed gradients, float32 bias corrections."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(20)]
    for jo, to in ((jopt.adamw(0.1, weight_decay=0.01, grad_clip_norm=1.0),
                    topt.adamw(0.1, weight_decay=0.01, grad_clip_norm=1.0)),
                   (jopt.sgd(0.05, momentum=0.9, nesterov=True),
                    topt.sgd(0.05, momentum=0.9, nesterov=True))):
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        js, ts = jo.init(jp), to.init(tp)
        for i, g in enumerate(grads):
            jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                               jp, jnp.asarray(i))
            tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                               ts, tp, i)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-6)


def test_learners_raise_without_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError):
        TTree()
    with pytest.raises(RuntimeError):
        TLogistic()
