"""The port's weighted cross-entropy (``repro_torch.kernels.weighted_ce``,
``ops.weighted_ce``) against the JAX package's.

At shapes the Pallas kernels tile evenly ((T, V) in {(128, 512), (256,
1024)}) the reference is ``repro.kernels.ops.weighted_ce`` and
``jax.grad`` of it, run in interpret mode as ``tests/test_kernels.py``
runs them.  At ragged shapes (the Pallas forward asserts T % 128 == 0 and
V % 512 == 0) it is the oracle, ``repro.kernels.ref.weighted_ce`` /
``weighted_ce_grad``.  Inputs are made with numpy from a seed; bfloat16
logits are rounded from the same float32 values on both sides.  Here on
the CPU the port runs the plain versions; the ``gpu`` test holds the CUDA
kernels against them on the card.

Tolerance: loss and lse rtol 1e-6 / atol 1e-6 (float32 math on both
sides, summed in other orders); float32 dlogits atol 1e-6 + rtol 1e-6;
bfloat16 dlogits within one bf16 rounding, 2^-8 of max|dlogits|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import weighted_ce as jwce
from repro_torch.kernels import ops as tops
from repro_torch.kernels import weighted_ce as twce

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(t, v, seed=0, scale=3.0, zero_every=7):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, v)) * scale).astype(np.float32)
    labels = rng.integers(0, v, t).astype(np.int32)
    w = rng.uniform(0.0, 2.0, t).astype(np.float32)
    w[::zero_every] = 0.0
    g = rng.uniform(0.5, 1.5, t).astype(np.float32)
    return x, labels, w, g


def _as(x: np.ndarray, dtype: str):
    """The same logits for both packages: (jax array, torch tensor)."""
    if dtype == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close_grad(got: torch.Tensor, want, dtype: str):
    want = np.asarray(want, dtype=np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, **TOL)
    else:
        err = np.abs(_np(got) - want).max()
        assert err <= 2.0 ** -8 * np.abs(want).max(), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,v", [(128, 512), (256, 1024)])
def test_plain_matches_pallas_kernels(t, v, dtype):
    x, labels, w, g = _inputs(t, v)
    jx, tx = _as(x, dtype)
    jloss, jlse = jwce.weighted_ce_fwd(jx, jnp.asarray(labels), jnp.asarray(w),
                                       interpret=True)
    loss, lse = twce.weighted_ce_fwd(tx, torch.from_numpy(labels),
                                     torch.from_numpy(w))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    jd = jwce.weighted_ce_bwd(jx, jnp.asarray(labels), jnp.asarray(w), jlse,
                              jnp.asarray(g), interpret=True)
    d = twce.weighted_ce_bwd(tx, torch.from_numpy(labels), torch.from_numpy(w),
                             lse, torch.from_numpy(g))
    assert d.dtype == tx.dtype and tuple(d.shape) == (t, v)
    _close_grad(d, np.asarray(jd.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,v", [(128, 512), (256, 1024)])
def test_autograd_function_matches_custom_vjp(t, v, dtype):
    """ops.weighted_ce forward and its backward (through autograd, with an
    upstream g) against the reference's custom_vjp and jax.grad."""
    x, labels, w, g = _inputs(t, v, seed=1)
    jx, tx = _as(x, dtype)
    jl, jw, jg = jnp.asarray(labels), jnp.asarray(w), jnp.asarray(g)
    jloss = jops.weighted_ce(jx, jl, jw)
    jgrad = jax.grad(lambda a: jnp.sum(jops.weighted_ce(a, jl, jw) * jg))(jx)
    tx = tx.requires_grad_(True)
    loss = tops.weighted_ce(tx, torch.from_numpy(labels), torch.from_numpy(w))
    (grad,) = torch.autograd.grad(loss, tx, torch.from_numpy(g))
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               **TOL)
    assert grad.dtype == tx.dtype
    _close_grad(grad, np.asarray(jgrad.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,v", [(2040, 1000), (7, 3), (1, 151936)])
def test_ragged_shapes_match_oracle(t, v, dtype):
    """Shapes the Pallas kernels cannot take (their forward asserts even
    tiles, their backward leaves remainder rows unwritten): the port takes
    any T and V; held to ref.weighted_ce / weighted_ce_grad."""
    x, labels, w, g = _inputs(t, v, seed=2)
    jx, tx = _as(x, dtype)
    jl, jw = jnp.asarray(labels), jnp.asarray(w)
    jloss, jlse = jref.weighted_ce(jx, jl, jw)
    loss, lse = twce.weighted_ce_fwd(tx, torch.from_numpy(labels),
                                     torch.from_numpy(w))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    jd = jref.weighted_ce_grad(jx, jl, jw, jlse, jnp.asarray(g))
    d = twce.weighted_ce_bwd(tx, torch.from_numpy(labels), torch.from_numpy(w),
                             lse, torch.from_numpy(g))
    _close_grad(d, np.asarray(jd.astype(jnp.float32)), dtype)


def test_zero_weight_zero_loss_and_grad():
    """Mirrors tests/test_kernels.py's zero-weight case."""
    x, labels, _, _ = _inputs(128, 512, seed=3)
    tx = torch.from_numpy(x).requires_grad_(True)
    w = torch.zeros(128)
    loss = tops.weighted_ce(tx, torch.from_numpy(labels), w)
    assert float(loss.detach().abs().max()) == 0.0
    (grad,) = torch.autograd.grad(loss.sum(), tx)
    assert float(grad.abs().max()) == 0.0


def test_gradcheck_float64():
    """The autograd.Function's backward is the derivative of its forward
    (float64 on the CPU path; labels and weights get no gradient)."""
    x, labels, w, _ = _inputs(6, 5, seed=4, scale=1.0, zero_every=4)
    tx = torch.from_numpy(x).double().requires_grad_(True)
    tl, tw = torch.from_numpy(labels), torch.from_numpy(w).double()
    assert torch.autograd.gradcheck(
        lambda a: tops.weighted_ce(a, tl, tw), (tx,), eps=1e-6, atol=1e-7)


def test_strided_rows_and_int64_labels():
    """A row-strided view and int64 labels give what a contiguous copy and
    int32 labels give; the plain path counts no launches."""
    x, labels, w, g = _inputs(33, 40, seed=5)
    base = torch.from_numpy(x)
    view = torch.cat([base, base[:, :3]], dim=1)[:, :40]
    assert view.stride() == (43, 1)
    fwd0, bwd0 = twce.weighted_ce_fwd.launches, twce.weighted_ce_bwd.launches
    a = twce.weighted_ce_fwd(view, torch.from_numpy(labels).long(),
                             torch.from_numpy(w))
    b = twce.weighted_ce_fwd(base, torch.from_numpy(labels),
                             torch.from_numpy(w))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    da = twce.weighted_ce_bwd(view, torch.from_numpy(labels).long(),
                              torch.from_numpy(w), a[1], torch.from_numpy(g))
    db = twce.weighted_ce_bwd(base, torch.from_numpy(labels),
                              torch.from_numpy(w), b[1], torch.from_numpy(g))
    assert torch.equal(da, db)
    assert (twce.weighted_ce_fwd.launches, twce.weighted_ce_bwd.launches) \
        == (fwd0, bwd0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    lab, w = torch.zeros(4, dtype=torch.int32), torch.ones(4)
    with pytest.raises(ValueError, match="T, V"):
        twce.weighted_ce_fwd(x[0], lab, w)
    with pytest.raises(ValueError, match=r"labels must be \[4\]"):
        twce.weighted_ce_fwd(x, lab[:3], w)
    with pytest.raises(TypeError, match="int32 or int64"):
        twce.weighted_ce_fwd(x, lab.float(), w)
    with pytest.raises(ValueError, match=r"g must be \[4\]"):
        twce.weighted_ce_bwd(x, lab, w, torch.zeros(4), torch.zeros(3))
    with pytest.raises(ValueError, match="no weighted_ce_fwd kernel"):
        twce.weighted_ce_fwd(x.to("meta"), lab.to("meta"), w.to("meta"))


# ------------------------------------------------------------- on card
@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    """The CUDA kernels against their plain versions on the card: the
    training path's row layouts (B * S rows, last position weight 0),
    ragged and tiny shapes, row-strided views whose rows start off a
    16-byte boundary; two runs give the same bits (skips without a card).

    Tolerance: loss and lse rtol 1e-5 (expf against the CPU-style exp,
    other summation order).  dlogits on the same lse, element by element:
    |d - pd| <= rtol |pd| + 1e-3 |w g| / V, rtol 2^-7 in bf16 (both round
    the same float32 value: one bf16 ulp at most) and 1e-5 in float32;
    and each row sums to w g (sum p - 1) = 0 within rtol |w g| (in bf16
    the entries' magnitudes sum to <= 2 |w g| and each rounds by <= 2^-8
    of itself)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [(2048, 32000, torch.float32, 0, 0),
             (512, 151936, torch.bfloat16, 0, 0),
             (2040, 1000, torch.float32, 0, 0),
             (2040, 1000, torch.bfloat16, 0, 0),
             (7, 3, torch.float32, 0, 0), (7, 3, torch.bfloat16, 0, 0),
             (1, 151936, torch.float32, 0, 0),
             (64, 1001, torch.bfloat16, 3, 2), (64, 1001, torch.float32, 1, 0),
             (5, 9, torch.bfloat16, 1, 5)]
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd0, bwd0 = twce.weighted_ce_fwd.launches, twce.weighted_ce_bwd.launches
    for t, v, dtype, offset, extra in cases:
        base = torch.randn(t, v + offset + extra, generator=gen, device=dev)
        x = (base * 3).to(dtype)[:, offset:offset + v]
        lab = torch.randint(0, v, (t,), generator=gen, device=dev)
        w = torch.rand(t, generator=gen, device=dev)
        w[::5] = 0
        g = torch.rand(t, generator=gen, device=dev) + 0.5
        loss, lse = twce.weighted_ce_fwd(x, lab, w)
        ploss, plse = twce.weighted_ce_fwd_plain(x, lab, w)
        torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-6)
        d = twce.weighted_ce_bwd(x, lab, w, lse, g)
        pd = twce.weighted_ce_bwd_plain(x, lab, w, lse, g)
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        wg = (w * g).abs()[:, None]
        bound = rtol * pd.float().abs() + 1e-3 * wg / v
        assert bool(((d.float() - pd.float()).abs() <= bound).all())
        rows = d.double().sum(dim=1).abs()
        assert bool((rows <= rtol * wg[:, 0].double()).all())
        again = twce.weighted_ce_fwd(x, lab, w)
        assert torch.equal(again[0], loss) and torch.equal(again[1], lse)
        assert torch.equal(twce.weighted_ce_bwd(x, lab, w, lse, g), d)
    n = len(cases)
    assert twce.weighted_ce_fwd.launches - fwd0 == 2 * n
    assert twce.weighted_ce_bwd.launches - bwd0 == 2 * n
