"""The port's Mixture-of-Experts (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe``, at granite's and qwen3-moe's
``reduced()`` widths in float32 on the same weights and tokens.

Held: the router's probabilities within 1e-6, its indices exactly (ties
to the lower expert, as ``lax.top_k``) and the Switch aux loss rtol 1e-6;
each expert FFN (dense and grouped) within 1e-5 of max|reference| and the
grouped = the dense within the same (other summation orders: the grouped
combine adds a token's k copies one after another as the reference's
scatter does); two grouped runs the same bits; a train step's loss, aux
and gradients (the loss with ``router_aux_coef * aux``) within 1e-5
(gradients: of each leaf's max|reference|), two momentum-SGD steps of
``make_train_step`` within atol 1e-5 + rtol 1e-5 (SGD: AdamW's
normalized step turns an ulp of a near-zero gradient into a step of the
learning rate, ROADMAP Queue 3); and a ``NeuralCore.fit`` over an MoE
backbone within 1e-4 of max|logits| (both sides on the dense experts,
which the port's backbone runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.learners.neural import NeuralBackbone as JNeural
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.optim import optimizers as jopt
from repro_torch.convert import (model_params_from_numpy,
                                 neural_params_from_numpy)
from repro_torch.learners.neural import NeuralBackbone as TNeural
from repro_torch.models import api as tapi
from repro_torch.models import moe as tmoe
from repro_torch.optim import optimizers as topt
from torch_zoo_common import assert_close, batch_of, cfgs, jbatch, tbatch

MOE = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]


def _layer(arch, seed=0, t=48):
    jcfg, tcfg = cfgs(arch)
    params = jmoe.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (t, jcfg.d_model)).astype(np.float32)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return jcfg, tcfg, params, tparams, x


@pytest.mark.parametrize("arch", MOE)
def test_router_matches_reference(arch):
    jcfg, tcfg, params, tparams, x = _layer(arch)
    jp, ji, ja = jmoe.router_topk(params, jnp.asarray(x), jcfg)
    tp, ti, ta = tmoe.router_topk(tparams, torch.from_numpy(x), tcfg)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_router_ties_pick_the_lower_expert():
    """Experts 1 and 3 (and 0 and 2) share a router column, so their
    probabilities are equal bits: the indices are lax.top_k's."""
    jcfg, tcfg, params, tparams, x = _layer(MOE[0])
    r = np.array(params["router"])
    r[:, 3], r[:, 2] = r[:, 1], r[:, 0]
    params = {**params, "router": jnp.asarray(r)}
    tparams = {**tparams, "router": torch.from_numpy(r)}
    for k in (1, 2, 3):
        jc, tc = (c.with_overrides(top_k=k) for c in (jcfg, tcfg))
        _, ji, _ = jmoe.router_topk(params, jnp.asarray(x), jc)
        _, ti, _ = tmoe.router_topk(tparams, torch.from_numpy(x), tc)
        assert np.array_equal(ti.numpy(), np.asarray(ji)), k


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("impl", ["dense", "gmm"])
def test_moe_apply_matches_reference(arch, impl):
    jcfg, tcfg, params, tparams, x = _layer(arch, seed=1)
    x3 = x.reshape(3, 16, -1)
    jy, ja = jmoe.moe_apply(params, jnp.asarray(x3), jcfg, impl)
    ty, ta = tmoe.moe_apply(tparams, torch.from_numpy(x3), tcfg, impl)
    assert_close(ty, jy, impl, tol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_gmm_equals_dense_and_repeats_its_bits(arch):
    _, tcfg, _, tparams, x = _layer(arch, seed=2, t=96)
    xt = torch.from_numpy(x)[None]
    dense, _ = tmoe.moe_apply(tparams, xt, tcfg, "dense")
    gmm, _ = tmoe.moe_apply(tparams, xt, tcfg, "gmm")
    assert_close(gmm, dense.numpy(), "gmm vs dense", tol=1e-5)
    again, _ = tmoe.moe_apply(tparams, xt, tcfg, "gmm")
    assert torch.equal(gmm, again)


def test_expert_parallelism_raises():
    """moe_impl='ep_a2a' without a mesh is the grouped path, bit for bit,
    as the reference falls back (its mesh path: test_torch_ep_a2a.py);
    the model and the train step take it; an unknown impl still raises."""
    _, tcfg, _, tparams, x = _layer(MOE[0])
    xt = torch.from_numpy(x)[None]
    ep_y, ep_aux = tmoe.moe_apply(tparams, xt, tcfg, "ep_a2a")
    gmm_y, gmm_aux = tmoe.moe_apply(tparams, xt, tcfg, "gmm")
    assert torch.equal(ep_y, gmm_y) and torch.equal(ep_aux, gmm_aux)
    ep = tcfg.with_overrides(moe_impl="ep_a2a")
    params = tapi.init_params(ep, torch.Generator().manual_seed(0))
    step = tapi.make_train_step(ep, topt.sgd(0.1))
    tokens = torch.randint(0, ep.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    _, _, m = step(params, topt.sgd(0.1).init(params), {"tokens": tokens}, 0)
    gmm = tcfg.with_overrides(moe_impl="gmm")
    want = tapi.loss_and_grads(params, {"tokens": tokens}, gmm)
    assert float(m["loss"]) == float(want[0].detach()) and float(want[2]) > 0
    with pytest.raises(ValueError, match="unknown moe_impl"):
        tapi.init_params(tcfg.with_overrides(moe_impl="grouped"))


def _train_case(arch, seed=0, **kw):
    jcfg, tcfg = cfgs(arch, **kw)
    params = japi.init_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    batch = batch_of(jcfg, rng, b=2, s=16)
    batch["sample_weight"] = rng.uniform(0.2, 2.0, 2).astype(np.float32)
    return jcfg, tcfg, params, batch


def _ref_loss(jcfg):
    def loss_fn(p, b):
        logits, _, aux = japi.forward(p, b, jcfg)
        loss = japi.weighted_next_token_loss(logits, b, jcfg)
        if jcfg.is_moe:
            loss = loss + jcfg.router_aux_coef * aux
        return loss, aux
    return loss_fn


def assert_grads_close(got: dict, want, path=""):
    if isinstance(want, dict):
        for k in want:
            assert_grads_close(got[k], want[k], f"{path}/{k}")
        return
    assert_close(got, want, "grad " + path, tol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_train_step_matches_reference(arch):
    """The loss (with router_aux_coef * aux), aux and gradients of one
    step, then two momentum-SGD steps of make_train_step."""
    jcfg, tcfg, params, batch = _train_case(arch)
    (jl, ja), jg = jax.jit(jax.value_and_grad(_ref_loss(jcfg), has_aux=True))(
        params, jbatch(batch))
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    tl, tg, ta = tapi.loss_and_grads(tp, tbatch(batch), tcfg)[:3]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    assert float(ja) > 0
    assert_grads_close(tg, jg)
    jo, to = jopt.sgd(0.1, momentum=0.9), topt.sgd(0.1, momentum=0.9)
    jstep = jax.jit(japi.make_train_step(jcfg, jo))
    tstep = tapi.make_train_step(tcfg, to)
    js, ts = jo.init(params), to.init(tp)
    jp = params
    for i in range(2):
        jp, js, jm = jstep(jp, js, jbatch(batch), jnp.asarray(i, jnp.int32))
        tp, ts, tm = tstep(tp, ts, tbatch(batch), i)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["aux_loss"]),
                                   float(jm["aux_loss"]), rtol=1e-5)
    for (k, g), w in zip(_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def _leaves(tree, path=""):
    """(path, leaf) in the reference's leaf order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    return [(path, tree)]


def neural_fit_matches_reference(arch, steps=3, **kw):
    """From the reference's init carried across: the logits after
    ``steps`` full-batch AdamW steps within 1e-4 of max|logits|.  An MoE
    config runs the dense experts on both sides, as the port's backbone
    does (the grouped = the dense is held above)."""
    jcfg, tcfg = cfgs(arch, moe_impl="dense", **kw)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(48, 5)).astype(np.float32)
    c = rng.integers(0, 3, 48).astype(np.int32)
    w = rng.random(48).astype(np.float32)
    w /= w.sum()
    key = jax.random.key(1)
    jcore = JNeural(cfg=jcfg, steps=steps).core(3)
    init = jcore.init(key, X.shape[1:])
    jp = jcore.fit(init, key, jnp.asarray(X), jax.nn.one_hot(c, 3),
                   jnp.asarray(w))
    tcore = TNeural(cfg=tcfg, steps=steps, device="cpu").core(3)
    tp = tcore.fit(neural_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, init), device="cpu"), None,
        torch.from_numpy(X),
        torch.nn.functional.one_hot(torch.from_numpy(c).long(), 3).float(),
        torch.from_numpy(w))
    want = np.asarray(jcore.logits(jp, jnp.asarray(X)))
    got = tcore.logits(tp, torch.from_numpy(X)).detach()
    assert_close(got, want, f"{arch} fit")


def test_neural_core_fit_over_moe_backbone():
    neural_fit_matches_reference("granite-moe-1b-a400m")
