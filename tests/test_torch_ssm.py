"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm``, at mamba2's and jamba's ``reduced()``
widths in float32 on the same weights and inputs.

Held, each within 1e-5 of max|reference| unless said (float32, other
summation orders): ``ssd_chunked`` at chunk sizes 4, 8, 16 and 32 (with
and without an initial state), and against a naive recurrence of
h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t (1e-4: the
chunked form sums in another order over 32 steps); the causal conv over a
sequence and its one-token step; the block's forward and decode (outputs
and the state); the state handoff: a prefill of S then k decode steps
gives the logits of a prefill of S + k (1e-4 of max|logits|); a mamba2
train step's loss and gradients; and a ``NeuralCore.fit`` over SSM and
hybrid (jamba's widths, a two-layer pattern) backbones (1e-4 of
max|logits|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import ssm as tssm
from test_torch_moe import (_ref_loss, _train_case, assert_grads_close,
                            neural_fit_matches_reference)
from torch_zoo_common import assert_close, cfgs, jbatch, tbatch

TOL = 1e-5


def _scan_inputs(seed=0, b=2, s=32, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.5, (b, s, h)).astype(np.float32)
    a_log = np.log(np.arange(1, h + 1, dtype=np.float32))
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, a_log, B, C, h0


def _naive(x, dt, a_log, B, C, h0):
    b, s, h, p = x.shape
    a = -np.exp(a_log.astype(np.float64))
    H = h0.astype(np.float64)
    ys = []
    for t in range(s):
        dec = np.exp(dt[:, t] * a)                                 # [b, h]
        upd = np.einsum("bn,bhp,bh->bhnp", B[:, t], x[:, t], dt[:, t])
        H = H * dec[:, :, None, None] + upd
        ys.append(np.einsum("bn,bhnp->bhp", C[:, t], H))
    return np.stack(ys, 1), H


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference_and_the_recurrence(chunk, with_h0):
    x, dt, a_log, B, C, h0 = _scan_inputs()
    h0 = h0 if with_h0 else np.zeros_like(h0)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, B, C)),
                              chunk, jnp.asarray(h0) if with_h0 else None)
    ty, th = tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, B, C)),
                              chunk, torch.from_numpy(h0) if with_h0
                              else None)
    assert ty.dtype == th.dtype == torch.float32
    assert_close(ty, jy, "y", tol=TOL)
    assert_close(th, jh, "H", tol=TOL)
    ny, nh = _naive(x, dt, a_log, B, C, h0)
    assert_close(ty, ny, "y vs recurrence", tol=1e-4)
    assert_close(th, nh, "H vs recurrence", tol=1e-4)


def test_ssd_chunked_needs_whole_chunks():
    x, dt, a_log, B, C, _ = _scan_inputs()
    with pytest.raises(AssertionError):
        tssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, B, C)), 5)


def _block(arch, seed=0):
    jcfg, tcfg = cfgs(arch)
    params = jssm.ssm_init(jax.random.key(seed), jcfg, jnp.float32)
    tparams = {k: (torch.from_numpy(np.array(v["scale"]))
                   if isinstance(v, dict) else torch.from_numpy(np.array(v)))
               for k, v in params.items()}
    tparams["norm"] = {"scale": tparams["norm"]}
    return jcfg, tcfg, params, tparams


def test_conv_full_and_step_match_reference():
    jcfg, _, params, tparams = _block("mamba2-130m")
    conv = jcfg.ssm_conv
    x = np.random.default_rng(1).standard_normal(
        (2, 12, jcfg.d_inner)).astype(np.float32)
    w = params["conv_x"]
    b = jnp.asarray(np.random.default_rng(2).standard_normal(
        jcfg.d_inner).astype(np.float32))
    want = jssm._conv_full(w, b, jnp.asarray(x), conv)
    got = tssm._conv_full(tparams["conv_x"], torch.from_numpy(np.array(b)),
                          torch.from_numpy(x), conv)
    assert_close(got, want, "conv", tol=TOL)
    state = x[:, :conv - 1]
    jo, js = jssm._conv_step(w, b, jnp.asarray(state), jnp.asarray(x[:, 3:4]))
    to, ts = tssm._conv_step(tparams["conv_x"], torch.from_numpy(np.array(b)),
                             torch.from_numpy(state),
                             torch.from_numpy(x[:, 3:4]))
    assert_close(to, jo, "conv step", tol=TOL)
    assert np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_block_forward_and_decode_match_reference(arch):
    jcfg, tcfg, params, tparams = _block(arch)
    x = np.random.default_rng(3).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    jy, jstate = jssm.ssm_forward(params, jnp.asarray(x), jcfg)
    ty, tstate = tssm.ssm_forward(tparams, torch.from_numpy(x), tcfg)
    assert_close(ty, jy, "forward", tol=TOL)
    for f in tssm.SSMState._fields:
        assert_close(getattr(tstate, f), getattr(jstate, f), f, tol=TOL)
    x1 = x[:, :1] * 0.5
    jy1, js1 = jssm.ssm_decode(params, jnp.asarray(x1), jstate, jcfg)
    ty1, ts1 = tssm.ssm_decode(
        tparams, torch.from_numpy(x1),
        tssm.SSMState(*(torch.from_numpy(np.array(a)) for a in jstate)),
        tcfg)
    assert_close(ty1, jy1, "decode", tol=TOL)
    for f in tssm.SSMState._fields:
        assert_close(getattr(ts1, f), getattr(js1, f), "decode " + f,
                     tol=TOL)


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_state_handoff_prefill_then_decode_equals_longer_prefill(arch):
    """Prefill S = 32, then 32 decode steps fed the next tokens: every
    step's logits = those of one prefill of 64 at that position."""
    _, tcfg = cfgs(arch)
    params = tapi.init_params(tcfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, tcfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        full, _, _ = tapi.forward(params, {"tokens": tokens}, tcfg)
        _, caches, _ = tapi.forward(params, {"tokens": tokens[:, :32]}, tcfg)
        caches = tapi.pad_prefill_cache(caches, tcfg, 64)
        for i in range(32, 64):
            logits, caches = tapi.decode_step(params, caches,
                                              tokens[:, i:i + 1], i, tcfg)
            assert_close(logits[:, 0], full[:, i].numpy(), f"pos {i}")


def test_mamba2_train_step_matches_reference():
    jcfg, tcfg, params, batch = _train_case("mamba2-130m")
    (jl, _), jg = jax.jit(jax.value_and_grad(_ref_loss(jcfg), has_aux=True))(
        params, jbatch(batch))
    tp = model_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    tl, tg, ta = tapi.loss_and_grads(tp, tbatch(batch), tcfg)[:3]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(ta) == 0.0
    assert_grads_close(tg, jg)


def test_neural_core_fit_over_ssm_backbone():
    neural_fit_matches_reference("mamba2-130m")


def test_neural_core_fit_over_hybrid_backbone():
    """Jamba's widths with its pattern cut to one SSM and one attention
    sub-layer, MoE on the second (the reduced unit of eight takes the
    reference ~25 s to compile here)."""
    neural_fit_matches_reference("jamba-v0.1-52b", num_layers=2,
                                 layer_pattern=("ssm", "attn"))
