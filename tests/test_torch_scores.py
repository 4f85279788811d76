"""Parity of the port's score math and label encoding (paper eqs. 1, 9-13)
with the JAX package: the same numpy inputs through ``repro.core`` and
``repro_torch.core``, plus the identities of tests/test_core_scores.py
asserted on the port itself.

Tolerances: float32 elementwise math through two libraries' exp/log
differs by at most a few ulps, so outputs agree within rtol 1e-6 (atol
1e-7 for entries near 0); reductions (the model weight's sums) are taken in
other orders, hence rtol 1e-5 there, as the reference's own tests use.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro.core import scores as jsc
from repro_torch.core import encoding as tenc
from repro_torch.core import scores as tsc


def _wr(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    r = (rng.random(n) > 0.4).astype(np.float32)
    return w, r


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ encoding
@pytest.mark.parametrize("k", [2, 3, 5, 10])
def test_encoding_matches_reference(k):
    c = np.arange(23) % k
    ref = np.asarray(jenc.encode_labels(jnp.asarray(c), k))
    got = tenc.encode_labels(_t(c), k).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tenc.decode_labels(_t(got)).numpy(), c)
    np.testing.assert_allclose(got.sum(-1), 0.0, atol=1e-6)


@pytest.mark.parametrize("k", [2, 4, 10])
def test_margin_identities(k):
    """y^T g / K = 1/(K-1) if same class, -1/(K-1)^2 otherwise."""
    y = tenc.encode_labels(torch.tensor([0]), k)
    same = tenc.margin(y, tenc.encode_labels(torch.tensor([0]), k), k)
    diff = tenc.margin(y, tenc.encode_labels(torch.tensor([1]), k), k)
    np.testing.assert_allclose(same.numpy(), 1.0 / (k - 1), rtol=1e-5)
    np.testing.assert_allclose(diff.numpy(), -1.0 / (k - 1) ** 2, rtol=1e-5)
    np.testing.assert_allclose(
        tenc.exp_loss(y, y, k).numpy(),
        np.asarray(jenc.exp_loss(jnp.asarray(y.numpy()),
                                 jnp.asarray(y.numpy()), k)), rtol=1e-6)


# -------------------------------------------------------------- model weight
@pytest.mark.parametrize("k", [2, 3, 10])
@pytest.mark.parametrize("with_u", [False, True])
@pytest.mark.parametrize("exact_scale", [False, True])
def test_model_weight_matches_reference(k, with_u, exact_scale):
    w, r = _wr(97, k)
    u = (np.random.default_rng(7).random(97) + 0.5).astype(np.float32)
    ju, tu = (jnp.asarray(u), _t(u)) if with_u else (None, None)
    ja, jr = jsc.model_weight(jnp.asarray(w), jnp.asarray(r), k, u=ju,
                              exact_scale=exact_scale)
    ta, tr = tsc.model_weight(_t(w), _t(r), k, u=tu, exact_scale=exact_scale)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    np.testing.assert_allclose(float(tr), float(jr), rtol=1e-5)


def test_eq9_head_agent_and_alpha_cap():
    r = torch.tensor([1., 1., 1., 0.])
    w = torch.full((4,), 0.25)
    a, rbar = tsc.model_weight(w, r, num_classes=3)
    np.testing.assert_allclose(float(rbar), 0.75, rtol=1e-6)
    np.testing.assert_allclose(float(a), np.log(3.) + np.log(2.), rtol=1e-5)
    a_all, _ = tsc.model_weight(w, torch.ones(4), 3, alpha_cap=20.0)
    assert float(a_all) == 20.0


def test_alpha_zero_at_random_guessing():
    """Stop criterion: rbar = 1/K <=> alpha = 0."""
    k, n = 5, 100
    r = torch.cat([torch.ones(n // k), torch.zeros(n - n // k)])
    a, _ = tsc.model_weight(torch.full((n,), 1.0 / n), r, num_classes=k)
    np.testing.assert_allclose(float(a), 0.0, atol=1e-5)


def test_assistant_alpha_uses_upstream_factor():
    w, r = _wr(64, 3)
    u = np.random.default_rng(4).random(64).astype(np.float32) + 0.1
    ja, _ = jsc.assistant_alpha(jnp.asarray(w), jnp.asarray(r),
                                jnp.asarray(u), 4)
    ta, _ = tsc.model_weight(_t(w), _t(r), 4, u=_t(u))
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


# ---------------------------------------------------------- ignorance update
@pytest.mark.parametrize("n", [4, 257, 1024, 3000])
@pytest.mark.parametrize("alpha", [0.0, 0.3, 2.5])
def test_ignorance_updates_match_reference(n, alpha):
    w, r = _wr(n, n)
    a = np.float32(alpha)
    ref = np.asarray(jsc.ignorance_update(jnp.asarray(w), jnp.asarray(r),
                                          jnp.asarray(a)))
    got = tsc.ignorance_update(_t(w), _t(r), torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sum(), 1.0, atol=1e-5)
    for k in (2, 6):
        ref_x = np.asarray(jsc.ignorance_update_exact(
            jnp.asarray(w), jnp.asarray(r), jnp.asarray(a), k))
        got_x = tsc.ignorance_update_exact(_t(w), _t(r), torch.tensor(a),
                                           k).numpy()
        np.testing.assert_allclose(got_x, ref_x, rtol=1e-6, atol=1e-7)


def test_exact_reweight_is_rescaled_surrogate():
    """After normalization the exact reweight equals the surrogate at
    alpha' = alpha * K/(K-1)^2."""
    w, r = _wr(64, 5)
    k, a = 4, torch.tensor(1.3)
    np.testing.assert_allclose(
        tsc.ignorance_update_exact(_t(w), _t(r), a, k).numpy(),
        tsc.ignorance_update(_t(w), _t(r), a * k / (k - 1) ** 2).numpy(),
        rtol=1e-5, atol=1e-7)


def test_misclassified_gain_weight():
    w2 = tsc.ignorance_update(torch.full((4,), 0.25),
                              torch.tensor([1., 0., 1., 0.]), torch.tensor(1.0))
    np.testing.assert_allclose(float(w2[1] / w2[0]), np.e, rtol=1e-5)


@pytest.mark.parametrize("k", [2, 5, 9])
def test_upstream_factor_matches_reference(k):
    u = np.ones(6, np.float32)
    r = np.array([1, 0, 1, 1, 0, 0], np.float32)
    ref = np.asarray(jsc.upstream_factor_update(jnp.asarray(u),
                                                jnp.asarray(0.7), jnp.asarray(r), k))
    got = tsc.upstream_factor_update(_t(u), torch.tensor(0.7), _t(r), k).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got[0], np.exp(-0.7 / (k - 1)), rtol=1e-5)
    np.testing.assert_allclose(got[1], np.exp(0.7 / (k - 1) ** 2), rtol=1e-5)


def test_init_ignorance():
    w = tsc.init_ignorance(8, device="cpu")
    np.testing.assert_array_equal(w.numpy(), np.asarray(jsc.init_ignorance(8)))
    assert w.dtype == torch.float32 and w.device.type == "cpu"
