"""The ASCII hop's two kernels as one launch each: the ignorance update
(``kernels/ignorance.py``, ``csrc/ignorance.cu``) and the quantize-dequant
(``kernels/quantize.py``, ``csrc/quantize.cu``).

On the CPU the wrappers run their plain versions; the tests here hold those
against the JAX package, the launch plans (cluster size, CTAs, tiles or
elements a CTA) against the kernels' index maps, and the wrappers' card
path, down to a stand-in library that records the C calls, against the
plans.  The ``gpu`` test holds the kernels against their plain versions on
a card, bit for bit, at the main path's sizes and at each boundary of the
plans.

Tolerances: against the JAX package rtol 1e-6, as in
``tests/test_torch_kernels.py`` (an exp an element and sums in another
order); the port's wrapper against its own plain version: exact.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scores as jsc
from repro.kernels import ops as jops
from repro.kernels.ignorance import ignorance_update_unnormalized as pallas_unnorm
from repro.kernels.ignorance import tiles_evenly
from repro_torch.kernels import ignorance as ig
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as tq

MAIN_N = (420, 10500, 42000)            # the hops of blob3, MIMIC, Fashion
MAIN_TILES = (1020, 1023, 1024, 9000, 10500, 42000, 180000)


def _wra(n, seed, alpha=1.7):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    r = (rng.random(n) > 0.4).astype(np.float32)
    return w, r, np.float32(alpha)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pallas_update(w, r, a):
    """The reference's kernel path in interpret mode: ``ops`` where n
    tiles the kernel's grid, else the kernel over one tile of n and the
    same normalizer."""
    w, r, a = jnp.asarray(w), jnp.asarray(r), jnp.asarray(a)
    if tiles_evenly(w.shape[0]):
        return np.asarray(jops.ignorance_update(w, r, a, interpret=True))
    w_new, psums = pallas_unnorm(w, r, a, bn=w.shape[0], interpret=True)
    return np.asarray(w_new / jnp.maximum(jnp.sum(psums), 1e-12))


def _boundaries():
    """Lengths on both sides of each boundary of the ignorance plan: the
    cluster limits (one tile a CTA up to 8 or 16 tiles), 2, 3, 4 and 5
    tiles a CTA (the kernel's instantiations hold 1, 2, 4 and 8) under
    either limit, and LARGE_N (64 tiles)."""
    edges = [8, 16, 24, 32, 48, 64]
    out = []
    for tiles in edges:
        out += [tiles * ig.BN, tiles * ig.BN + 1]
    return out


# ------------------------------------------------------- ignorance update
@pytest.mark.parametrize("n", [1, 420, 1000, 1024, 10500, 42000])
def test_fused_update_matches_plain_and_reference(n):
    w, r, a = _wra(n, n)
    got = ig.ignorance_update(_t(w), _t(r), torch.tensor(a))
    assert torch.equal(got, ig.ignorance_update_plain(_t(w), _t(r),
                                                      torch.tensor(a)))
    assert torch.equal(ops.ignorance_update(_t(w), _t(r), torch.tensor(a)),
                       got)
    host = np.asarray(jsc.ignorance_update(jnp.asarray(w), jnp.asarray(r),
                                           jnp.asarray(a)))
    np.testing.assert_allclose(got.numpy(), host, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), _pallas_update(w, r, a),
                               rtol=1e-6)


def _owned_tiles(p, n):
    """The tiles each CTA takes under ``p``, as the kernel maps them: CTA b
    the tiles [b * tiles_per_cta, (b + 1) * tiles_per_cta), its warp j the
    sum of the j-th."""
    tiles, per_cta = ig.num_tiles(n), p.tiles_per_cta
    return [list(range(b * per_cta, min((b + 1) * per_cta, tiles)))
            for b in range(p.ctas)]


@pytest.mark.parametrize("limit", [ig.PORTABLE_CLUSTER, ig.MAX_CLUSTER])
def test_ignorance_plan_covers_every_tile_once(limit):
    ns = sorted({*range(1, 40 * ig.BN, 977), *_boundaries(), *MAIN_N,
                 ig.LARGE_N, ig.LARGE_N + 1, 2 ** 20, 2 ** 20 + 3})
    for n in ns:
        p = ig.plan(n, limit)
        tiles = ig.num_tiles(n)
        owned = _owned_tiles(p, n)
        flat = [t for cta in owned for t in cta]
        assert sorted(flat) == list(range(tiles)), (n, p)
        assert all(cta for cta in owned), (n, p)           # no CTA empty
        assert 1 <= p.tiles_per_cta <= ig.MAX_TILES_PER_CTA
        if n <= ig.LARGE_N:
            assert p.route == "cluster" and p.ctas == p.cluster
            assert 1 <= p.cluster <= min(limit, 16)
            assert tiles <= ig.BN   # the total: one partial a lane
        else:
            assert p.route == "large" and p.cluster == 1
    for n in MAIN_N:
        assert ig.plan(n, limit).route == "cluster"


def test_ignorance_plan_uses_the_cluster():
    """The cluster grows to the limit before a CTA takes a second tile,
    and the tiles spread evenly over the fewest CTAs that hold them."""
    assert ig.plan(8 * ig.BN) == ig.Plan("cluster", 8, 8, 1)
    assert ig.plan(8 * ig.BN + 1) == ig.Plan("cluster", 5, 5, 2)
    assert ig.plan(16 * ig.BN, 16) == ig.Plan("cluster", 16, 16, 1)
    assert ig.plan(42000) == ig.Plan("cluster", 7, 7, 6)
    assert ig.plan(42000, 16) == ig.Plan("cluster", 14, 14, 3)
    assert ig.plan(ig.LARGE_N) == ig.Plan("cluster", 8, 8, 8)
    assert ig.plan(ig.LARGE_N, 16) == ig.Plan("cluster", 16, 16, 4)
    assert ig.plan(ig.LARGE_N + 1) == ig.Plan("large", 1, 65, 1)
    with pytest.raises(ValueError):
        ig.plan(0)
    with pytest.raises(ValueError):
        ig.plan(100, 12)


# -------------------------------------------------------- quantize-dequant
def _covered(tile, p):
    """How often the kernel touches each element of a tile under ``p``:
    CTA c the share [c * per_cta, min((c + 1) * per_cta, tile)), thread
    t its elements t + 512 k for k < ceil(per_cta / 512)."""
    hits = np.zeros(tile, np.int64)
    k = -(-p.per_cta // tq.THREADS)
    for c in range(p.cluster):
        lo = c * p.per_cta
        count = min(p.per_cta, tile - lo)
        assert count > 0                        # no CTA empty
        off = np.arange(k * tq.THREADS)
        hits[lo + off[off < count]] += 1
    return hits


@pytest.mark.parametrize("limit", [tq.PORTABLE_CLUSTER, tq.MAX_CLUSTER])
def test_quantize_plan_covers_every_element_once(limit):
    tiles = sorted({*range(1, 3 * tq.CTA_TILE, 97), *MAIN_TILES,
                    2 * tq.CTA_TILE, 8 * tq.CTA_TILE, 8 * tq.CTA_TILE + 1,
                    16 * tq.CTA_TILE, 16 * tq.CTA_TILE + 1, 2 ** 17 + 5,
                    tq.LARGE_TILE, tq.LARGE_TILE + 1, 2 ** 20 + 3})
    for tile in tiles:
        p = tq.plan(tile, limit)
        if tile > tq.LARGE_TILE:
            assert p.route == "large"
            continue
        assert 1 <= p.cluster <= min(limit, 16)
        assert p.per_cta <= tq.THREADS * tq.MAX_PER_THREAD
        assert (_covered(tile, p) == 1).all(), (tile, p)
        if tile <= tq.CTA_TILE:
            assert p == tq.Plan("cta", 1, tile)
        else:
            assert p.route == "cluster" and p.cluster >= 2
            assert p.per_cta % 32 == 0
    for tile in MAIN_TILES:
        assert tq.plan(tile, limit).route in ("cta", "cluster")


@pytest.mark.parametrize("shape", [(1,), (1025,), (8193,), (42000,),
                                   (4500, 2), (18000, 10), (1024, 3),
                                   (2040, 10)])
def test_quantize_wrappers_match_plain_at_plan_boundaries(shape):
    """The CPU path is the plain version, tile by tile, at the shapes that
    cross the plan's routes."""
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    x = _t((rng.random(shape) - 0.3).astype(np.float32))
    u = _t(rng.random(shape).astype(np.float32))
    if len(shape) == 1:
        got = tq.quantize_dequant_tiles(x, u, 127.0)
        want = tq.quantize_dequant_plain(x, u, 127.0)
    else:
        got = tq.quantize_dequant_block(x, u, 7.0)
        want = tq.quantize_dequant_block_plain(x, u, 7.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------ the card path, stood in
class _FakeLib:
    """Records the C calls a wrapper makes and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture(params=[8, 16])
def fake_card(monkeypatch, request):
    """The wrappers' card path on CPU tensors, down to a stand-in library,
    on a card whose clusters hold 8 or 16 CTAs."""
    lib = _FakeLib()
    for mod in (ig, tq):
        monkeypatch.setattr(mod, "on_card", lambda x, what: True)
        monkeypatch.setattr(mod, "_lib", lambda: lib)
        monkeypatch.setattr(mod, "current",
                            lambda device: contextlib.nullcontext())
        monkeypatch.setattr(mod, "raw_stream", lambda device: 7)
        monkeypatch.setattr(mod, "cluster_limit",
                            lambda index: request.param)
    lib.limit = request.param
    return lib


@pytest.mark.parametrize("n", [*MAIN_N, 8193, ig.LARGE_N])
def test_ignorance_update_is_one_cluster_call(fake_card, n):
    w, r, a = (_t(x) for x in _wra(n, 3))
    before = ig.ignorance_update.launches
    out = ops.ignorance_update(w, r, a)
    (name, args), = fake_card.calls
    p = ig.plan(n, fake_card.limit)
    assert name == "ignorance_update"
    assert args[:3] == (w.data_ptr(), r.data_ptr(), a.data_ptr())
    assert args[3] == out.data_ptr() and out.shape == (n,)
    assert args[4:] == (n, p.cluster, p.tiles_per_cta, 7)
    assert ig.ignorance_update.launches == before + 1


def test_ignorance_update_large_n_route(fake_card):
    n = ig.LARGE_N + 1
    w, r, a = (_t(x) for x in _wra(n, 4))
    ig.ignorance_update(w, r, a)
    (name, args), = fake_card.calls
    assert name == "ignorance_update_large"
    assert args[5:] == (n, 7) and args[4] not in args[:4]   # its partials


def test_ignorance_unnormalized_is_one_call(fake_card):
    w, r, a = (_t(x) for x in _wra(5000, 5))
    before = ig.ignorance_update_unnormalized.launches
    out, partials = ig.ignorance_update_unnormalized(w, r, a)
    (name, args), = fake_card.calls
    assert name == "ignorance_update_unnormalized"
    assert args[3:] == (out.data_ptr(), partials.data_ptr(), 5000, 7)
    assert partials.shape == (ig.num_tiles(5000),)
    assert ig.ignorance_update_unnormalized.launches == before + 1


@pytest.mark.parametrize("shape,tile", [((42000,), 42000), ((10500,), 10500),
                                        ((2 ** 20,), 1024),
                                        ((18000, 10), 180000),
                                        ((4500, 2), 9000),
                                        ((2040, 10), 1020)])
def test_quantize_is_one_call_with_its_plan(fake_card, shape, tile):
    x, u = torch.zeros(shape), torch.zeros(shape)
    block = len(shape) == 2
    fn = ops.quantize_dequant_block if block else ops.quantize_dequant
    counter = tq.quantize_dequant_block if block else tq.quantize_dequant_tiles
    before = counter.launches
    xhat, q, scales = fn(x, u, 7)
    (name, args), = fake_card.calls
    p = tq.plan(tile, fake_card.limit)
    n = x.numel()
    assert name == "quantize_dequant"
    assert args[:5] == (x.data_ptr(), u.data_ptr(), xhat.data_ptr(),
                        q.data_ptr(), scales.data_ptr())
    assert args[5:] == (n, tile, p.cluster, p.per_cta, 7.0, tq.inv_qmax(7),
                        7)
    assert xhat.shape == shape and q.dtype == torch.int8
    assert scales.shape == (n // tile,)
    assert counter.launches == before + 1


def test_quantize_large_tile_route(fake_card):
    n = 2 ** 20 + 3
    ops.quantize_dequant(torch.zeros(n), torch.zeros(n), 127)
    (name, args), = fake_card.calls
    assert name == "quantize_dequant_large"
    assert args[6:8] == (n, n)   # its chunk maxima are args[5]


def test_card_path_still_checks_inputs(fake_card):
    w, r, a = (_t(x) for x in _wra(64, 6))
    with pytest.raises(ValueError):
        ig.ignorance_update(w, r[:32], a)
    with pytest.raises(TypeError):
        ig.ignorance_update(w.double(), r.double(), a)
    with pytest.raises(ValueError):
        ops.quantize_dequant(w, w, 300)
    assert fake_card.calls == []


# ---------------------------------------------------------------- the card
@pytest.mark.gpu
def test_hop_kernels_equal_plain_on_card():
    """The fused ignorance update and its unnormalized mode, and the
    quantize-dequant, against their plain versions on the card, bit for
    bit, at the main path's sizes and both sides of each boundary of the
    plans; two runs the same bits (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for n in (1, 1000, 1024, *MAIN_N, *_boundaries(), ig.LARGE_N + 1,
              2 ** 20):
        w, r, a = (_t(x).to(dev) for x in _wra(n, n))
        got = ops.ignorance_update(w, r, a)
        assert torch.equal(got, ig.ignorance_update_plain(w, r, a)), n
        assert torch.equal(ops.ignorance_update(w, r, a), got), n
        k_w, k_p = ig.ignorance_update_unnormalized(w, r, a)
        p_w, p_p = ig.ignorance_update_unnormalized_plain(w, r, a)
        assert torch.equal(k_w, p_w) and torch.equal(k_p, p_p), n
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in ((1025,), (8 * 1024 + 1,), (16 * 1024 + 1,), (42000,),
                  (tq.LARGE_TILE,), (tq.LARGE_TILE + 1,), (4500, 2),
                  (18000, 10), (2040, 10)):
        x = torch.rand(shape, generator=gen, device=dev) - 0.3
        u = torch.rand(shape, generator=gen, device=dev)
        block = len(shape) == 2
        fn = ops.quantize_dequant_block if block else ops.quantize_dequant
        plain = (tq.quantize_dequant_block_plain if block
                 else tq.quantize_dequant_plain)
        got = fn(x, u, 7.0)
        assert all(torch.equal(g, p) for g, p in zip(got, plain(x, u, 7.0)))
        assert all(torch.equal(g, a) for g, a in zip(fn(x, u, 7.0), got))
