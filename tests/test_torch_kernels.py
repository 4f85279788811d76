"""The port's ignorance-update kernel module against the JAX package.

On the CPU the wrappers run their plain PyTorch version (the CUDA kernel
builds and runs only on a card; the ``gpu`` tests below hold it against the
plain version there).  Inputs are made with numpy from a seed and passed to
both packages.

Tolerances: w_new is one float32 multiply of an exp per element, so two
libraries' exp differ by an ulp or two: rtol 1e-6.  The per-tile partial
sums and the normalizer are reductions taken in another order than the
reference's: rtol 1e-6 still holds for sums of positive terms of one tile,
and for the normalized vector.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scores as jsc
from repro.kernels.ignorance import ignorance_update_unnormalized as pallas_unnorm
from repro_torch.kernels import ignorance as ig
from repro_torch.kernels import ops


def _wra(n, seed, alpha=1.7):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    r = (rng.random(n) > 0.4).astype(np.float32)
    return w, r, np.float32(alpha)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_plain_matches_pallas_interpret(n):
    w, r, a = _wra(n, n)
    ref_w, ref_p = pallas_unnorm(jnp.asarray(w), jnp.asarray(r),
                                 jnp.asarray(a), interpret=True)
    got_w, got_p = ig.ignorance_update_unnormalized(_t(w), _t(r), torch.tensor(a))
    assert got_p.shape == (ig.num_tiles(n),)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), rtol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-6)


@pytest.mark.parametrize("n", [1000, 5000])
def test_normalized_matches_reference_at_ragged_n(n):
    """The port's kernel takes any n (ragged last tile masked); the
    normalized update equals the reference's host formula."""
    w, r, a = _wra(n, n + 1)
    ref = np.asarray(jsc.ignorance_update(jnp.asarray(w), jnp.asarray(r),
                                          jnp.asarray(a)))
    got = ops.ignorance_update(_t(w), _t(r), torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    w_new, partials = ig.ignorance_update_unnormalized(_t(w), _t(r),
                                                       torch.tensor(a))
    np.testing.assert_allclose(partials.sum().item(), w_new.sum().item(),
                               rtol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 1025, 2 * 1024 * 1024 + 5])
def test_plain_total_sums_every_partial(n):
    """Pass 2's total (lane t sums partials t, t+1024, ..., then a tree over
    the lanes) counts every partial once, at any tile count: n = 2^21 + 5
    gives 2049 partials, so the lanes hold up to 3 terms."""
    rng = np.random.default_rng(n)
    partials = rng.random(ig.num_tiles(n)).astype(np.float32)
    total = ig._total_plain(_t(partials)).item()
    np.testing.assert_allclose(total, partials.astype(np.float64).sum(),
                               rtol=1e-6)


def test_wrappers_validate_inputs():
    w, r, a = _wra(16, 0)
    tw, tr, ta = _t(w), _t(r), torch.tensor(a)
    with pytest.raises(TypeError):
        ig.ignorance_update_unnormalized(tw.double(), tr, ta)
    with pytest.raises(ValueError):
        ig.ignorance_update_unnormalized(tw, tr[:8], ta)
    with pytest.raises(ValueError):
        ig.ignorance_update_unnormalized(tw, tr, torch.tensor([a]))
    with pytest.raises(ValueError):
        ig.ignorance_update_unnormalized(tw[::2], tr[::2], ta)
    with pytest.raises(ValueError):
        ig.ignorance_update_unnormalized(torch.zeros(0), torch.zeros(0), ta)
    with pytest.raises(ValueError):
        ig.ignorance_update(tw, tr[:8], ta)
    with pytest.raises(ValueError):
        ig.ignorance_update_unnormalized(tw.to("meta"), tr.to("meta"),
                                         ta.to("meta"))


def test_cpu_path_launches_nothing():
    """CPU tensors take the plain version; the launch counters count only
    kernel launches."""
    before = (ig.ignorance_update_unnormalized.launches,
              ig.ignorance_update.launches)
    w, r, a = _wra(300, 1)
    ops.ignorance_update(_t(w), _t(r), torch.tensor(a))
    ig.ignorance_update_unnormalized(_t(w), _t(r), torch.tensor(a))
    assert (ig.ignorance_update_unnormalized.launches,
            ig.ignorance_update.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 210, 1000, 1024, 10500, 42000])
def test_kernel_matches_plain_on_card(n):
    """The CUDA kernel against its plain version on the card (skips
    without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, r, a = _wra(n, n)
    dev = torch.device("cuda")
    args = (_t(w).to(dev), _t(r).to(dev), torch.tensor(a, device=dev))
    k_w, k_p = ig.ignorance_update_unnormalized(*args)
    p_w, p_p = ig.ignorance_update_unnormalized_plain(*args)
    torch.testing.assert_close(k_w, p_w, rtol=1e-6, atol=0)
    torch.testing.assert_close(k_p, p_p, rtol=1e-6, atol=0)
    got = ops.ignorance_update(*args)
    torch.testing.assert_close(got, ig.ignorance_update_plain(*args),
                               rtol=1e-6, atol=0)
    # fixed reduction order: a second run gives the same bits
    assert torch.equal(ops.ignorance_update(*args), got)
