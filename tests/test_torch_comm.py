"""The port's wire channel (``repro_torch.comm``, ``kernels/quantize.py``,
``control/accounting.py``) against the JAX package, module by module.

Inputs are made with numpy from a seed and handed to both packages.  On the
CPU the port's kernel wrappers run their plain versions (the CUDA kernels
run only on a card: ``tests/test_torch_comm_session.py`` holds them against
the plain versions there).  The reference side runs the Pallas kernels in
interpret mode through ``repro.kernels.ops``, and ``repro.kernels.ref``.

The reference's channel calls its quantize kernel inside ``jit`` with qmax
a constant, where XLA turns ``absmax / qmax`` into ``absmax * (1/qmax)``;
called eagerly with qmax as an operand the kernel divides.  The port
follows the channel, so the reference side here is jitted with a constant
qmax, as its codecs run it.

Exact: int8 wire values, scales, packed int4 bytes, top-k indices and
residuals, fp16 round trips, ``wire_bits``, budget rungs, RDP epsilons.
Dequantized values are compared by value (``-0.0`` can occur).  The
Gaussian mechanism, given the reference's normal draws: rtol 1e-6 and atol
1e-7, because its L2 clip norm is a sum taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import budget as jbudget
from repro.comm import codecs as jcodecs
from repro.comm import privacy as jprivacy
from repro.control import accounting as jacct
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.comm import budget as tbudget
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm import draws as tdraws
from repro_torch.comm import privacy as tprivacy
from repro_torch.control import accounting as tacct
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(n, seed):
    """An ignorance-like vector: positive mass with a few heavy entries."""
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(n)).astype(np.float32)
    w[rng.integers(0, n, size=max(1, n // 50))] *= 20
    return (w / w.sum()).astype(np.float32)


def _draws(shape, seed, rounding):
    if rounding == "half":
        return np.full(shape, 0.5, np.float32)
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.fixture(scope="module")
def jit_qd():
    """The reference's kernels as its channel runs them: jitted, with a
    constant qmax (one compiled program per qmax and shape)."""
    cache = {}

    def get(fn, qmax):
        if (fn, qmax) not in cache:
            cache[fn, qmax] = jax.jit(
                lambda x, u: fn(x, u, qmax, interpret=True))
        return cache[fn, qmax]
    return get


def _assert_same_quantization(got, want):
    xhat, q, scales = got
    np.testing.assert_array_equal(q.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want[2]))
    assert torch.equal(xhat, _t(want[0]))      # by value: -0.0 == 0.0


@pytest.mark.parametrize("qmax", [127.0, 7.0])
@pytest.mark.parametrize("n", [1, 420, 1000, 1024, 10500, 42000, 2 ** 14,
                               2 ** 14 + 3])
def test_quantize_dequant_matches_reference(jit_qd, n, qmax):
    """Global tiles (420, 1000, 10500, 42000, 2^14 + 3), 1024-element tiles
    (1024, 2^14) and n = 1; stochastic and round-half-up draws."""
    x = _weights(n, n)
    for rounding in ("uniform", "half"):
        u = _draws(n, n + 1, rounding)
        want = jit_qd(jops.quantize_dequant, qmax)(jnp.asarray(x),
                                                   jnp.asarray(u))
        got = tops.quantize_dequant(_t(x), _t(u), qmax)
        _assert_same_quantization(got, want)
        assert got[2].shape == (n // tq.tile_for(n),)


def _reciprocal_differs(qmax, count, seed):
    """``count`` float32 absmax values where absmax / qmax and
    absmax * float32(1/qmax) round to different floats."""
    rng = np.random.default_rng(seed)
    a = rng.random(200000).astype(np.float32) + np.float32(0.01)
    inv = np.float32(1) / np.float32(qmax)
    found = a[(a / np.float32(qmax)) != (a * inv)]
    assert found.size >= count
    return found[:count]


@pytest.mark.parametrize("qmax", [127.0, 7.0])
@pytest.mark.parametrize("n", [420, 2048, 10500])
def test_scale_is_the_reciprocal_product(jit_qd, n, qmax):
    """Fact 1: the scale is absmax * float32(1/qmax), as the reference's
    channel computes it, and not the correctly rounded absmax / qmax.  The
    vectors are built so that the two rules differ in every tile; a port
    that "simplifies" the scale to a quotient fails here."""
    tile = tq.tile_for(n)
    peaks = _reciprocal_differs(qmax, n // tile, n)
    rng = np.random.default_rng(n)
    x = (rng.random(n).astype(np.float32) * 0.5).reshape(-1, tile)
    x *= peaks[:, None]
    x[:, 7] = -peaks                         # absmax of each tile, negative
    x = x.reshape(-1).astype(np.float32)
    u = rng.random(n, dtype=np.float32)
    got = tops.quantize_dequant(_t(x), _t(u), qmax)
    inv = np.float32(1) / np.float32(qmax)
    np.testing.assert_array_equal(got[2].numpy(), peaks * inv)
    assert not np.any(got[2].numpy() == peaks / np.float32(qmax))
    _assert_same_quantization(
        got, jit_qd(jops.quantize_dequant, qmax)(jnp.asarray(x),
                                                 jnp.asarray(u)))
    # and x / scale is a true division: q is floor(x / scale + u)
    scale = np.repeat(peaks * inv, tile)
    q = np.clip(np.floor(x / scale + u), -qmax, qmax)
    np.testing.assert_array_equal(got[1].numpy(), q.astype(np.int8))


@pytest.mark.parametrize("qmax", [127.0, 7.0])
@pytest.mark.parametrize("shape", [(450, 2), (1800, 10), (1024, 3),
                                   (2048, 10), (2040, 10), (3069, 3),
                                   (1536, 2), (1, 10)])
def test_quantize_dequant_block_matches_reference(jit_qd, shape, qmax):
    """Global row tiles ([450, 2], [1800, 10], [1024, 3], [2048, 10]) and
    ragged ones: 1020-element tiles for k = 10 ([2040, 10]), 1023 for k = 3
    ([3069, 3]), 1024 for k = 2 ([1536, 2])."""
    n, k = shape
    rng = np.random.default_rng(n * k)
    x = (rng.standard_normal(shape) * rng.random((n, 1))).astype(np.float32)
    for rounding in ("uniform", "half"):
        u = _draws(shape, n + k, rounding)
        want = jit_qd(jops.quantize_dequant_block, qmax)(jnp.asarray(x),
                                                         jnp.asarray(u))
        got = tops.quantize_dequant_block(_t(x), _t(u), qmax)
        _assert_same_quantization(got, want)
        assert got[2].shape == (n // tq.rows_for(n, k),)
    if shape == (2040, 10):
        assert tq.rows_for(n, k) * k == 1020
    if shape == (3069, 3):
        assert tq.rows_for(n, k) * k == 1023


@pytest.mark.parametrize("m", [1, 2, 21001, 42000, 2 ** 14 + 1])
def test_pack_and_unpack_int4_match_reference(m):
    """Bytes exact against the Pallas pack (interpret mode) and the host
    reference, odd counts included; unpacking returns every value."""
    rng = np.random.default_rng(m)
    q = rng.integers(-8, 8, size=m).astype(np.int8)
    want = np.asarray(jax.jit(lambda v: jops.pack_int4(v, interpret=True))(
        jnp.asarray(q)))
    np.testing.assert_array_equal(want, np.asarray(jref.pack_int4(
        jnp.asarray(q))))
    got = tops.pack_int4(_t(q))
    assert got.dtype == torch.int8 and got.shape == ((m + 1) // 2,)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tops.unpack_int4(got, m)
    np.testing.assert_array_equal(back.numpy(), q)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jops.unpack_int4(jnp.asarray(want), m,
                                                  interpret=True)))


def test_unpack_int4_checks_its_length():
    packed = tops.pack_int4(torch.zeros(5, dtype=torch.int8))
    with pytest.raises(ValueError):
        tops.unpack_int4(packed, 7)
    with pytest.raises(ValueError):
        tops.unpack_int4(packed[:2], 5)


def test_quantize_wrappers_validate_inputs():
    x = torch.rand(16)
    with pytest.raises(TypeError):
        tops.quantize_dequant(x.double(), x.double(), 127)
    with pytest.raises(ValueError):
        tops.quantize_dequant(x, x[:8], 127)
    with pytest.raises(ValueError):
        tops.quantize_dequant(x[::2], x[::2], 127)
    with pytest.raises(ValueError):
        tops.quantize_dequant(x, x, 200)
    with pytest.raises(ValueError):
        tops.quantize_dequant_block(x, x, 127)
    with pytest.raises(TypeError):
        tops.pack_int4(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.quantize_dequant(x.to("meta"), x.to("meta"), 127)


def test_cpu_path_launches_nothing():
    """CPU tensors take the plain versions; the launch counters count only
    kernel launches."""
    fns = (tq.quantize_dequant_tiles, tq.quantize_dequant_block,
           tq.pack_int4, tq.unpack_int4)
    before = [f.launches for f in fns]
    x = torch.rand(300)
    tcodecs.QuantCodec(bits=4, stochastic=False).roundtrip(x)
    wire, _ = tcodecs.QuantCodec(bits=4, stochastic=False).encode(x)
    tcodecs.QuantCodec(bits=4).decode(wire)
    tcodecs.QuantCodec(stochastic=False).roundtrip(x.view(100, 3))
    assert [f.launches for f in fns] == before


# ================================================================= codecs
class FixedDraws:
    """Draws handed in as tensors (the reference's, in these tests)."""

    def __init__(self, u=None, z=None):
        self.u, self.z = u, z

    def uniform(self, shape, device):
        assert tuple(self.u.shape) == tuple(shape)
        return self.u.to(device)

    def normal(self, shape, device):
        assert tuple(self.z.shape) == tuple(shape)
        return self.z.to(device)


def _codec_pairs():
    return [("fp32", {}), ("fp16", {}), ("int8", {}), ("int4", {}),
            ("int8", {"stochastic": False}), ("int4", {"bn": 256}),
            ("topk", {}), ("topk", {"fraction": 0.1})]


@pytest.mark.parametrize("shape", [1, 7, 420, 1024, 10500, (4500, 2),
                                   (18000, 10), (2040, 10), (3, 1)])
def test_wire_bits_formulas_match_reference(shape):
    for name, kw in _codec_pairs():
        assert tcodecs.make_codec(name, **kw).wire_bits(shape) == \
            jcodecs.make_codec(name, **kw).wire_bits(shape), (name, kw)
    q = tcodecs.QuantCodec(bits=4)
    m = tcodecs.numel(shape)
    tiles = q._tiles(shape)
    assert q.wire_bits(shape) == 8 * ((m + 1) // 2) + 32 * tiles
    assert tcodecs.quant_bits_per_element(127) == 8 == \
        jcodecs.quant_bits_per_element(127)
    assert tcodecs.quant_bits_per_element(7) == 4


def test_codec_registry_rejects_unknown_names():
    assert sorted(tcodecs.CODECS) == sorted(jcodecs.CODECS)
    with pytest.raises(ValueError):
        tcodecs.make_codec("int2")


@pytest.mark.parametrize("shape", [(10500,), (450, 2)])
def test_fp16_roundtrip_is_exact(shape):
    """Round to nearest even, subnormals and overflow included."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(
        -9, 6, size=shape)).astype(np.float32)
    want = np.asarray(jcodecs.Fp16Codec().roundtrip(jnp.asarray(x))[0])
    got = tcodecs.Fp16Codec().roundtrip(_t(x))[0]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(10500,), (1024,), (4500, 2), (2040, 10),
                                   (3069, 3), (10501,)])
def test_quant_codec_wire_matches_reference(bits, shape):
    """The int codecs' wire, given the reference's uniforms: q (or the
    packed int4 bytes) and scales exact; decode(encode(x)) equals the fused
    roundtrip, and the reference's jitted channel."""
    rng = np.random.default_rng(bits)
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    key = jax.random.key(11)
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    jc, tc = jcodecs.QuantCodec(bits=bits), tcodecs.QuantCodec(bits=bits)
    want = jax.jit(lambda v, k: jc.encode(v, k)[0])(jnp.asarray(x), key)
    draws = FixedDraws(u=_t(u))
    got, _ = tc.encode(_t(x), draws)
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            assert a == tuple(b)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    decoded = tc.decode(got)
    assert torch.equal(decoded, tc.roundtrip(_t(x), draws)[0])
    ref_channel = np.asarray(jax.jit(
        lambda v, k: jc.roundtrip(v, k)[0])(jnp.asarray(x), key))
    assert torch.equal(decoded, _t(ref_channel))


def _tied(n, seed):
    """A post-hop ignorance vector: a handful of distinct values, so most
    magnitudes tie."""
    rng = np.random.default_rng(seed)
    levels = np.array([1.0, 2.7, 7.4, 20.1], np.float32)
    w = levels[rng.integers(0, 4, size=n)]
    return (w / w.sum()).astype(np.float32)


@pytest.mark.parametrize("shape", [(10500,), (420,), (450, 2)])
def test_topk_ties_ship_the_reference_indices(shape):
    """Fact 2: ties in magnitude go to the lower index, as lax.top_k
    breaks them; two hops with the error-feedback residual carried, the
    indices, values and residuals exact."""
    n = int(np.prod(shape))
    x1 = _tied(n, 1).reshape(shape)
    x2 = _tied(n, 2).reshape(shape)
    jc, tc = jcodecs.TopKCodec(), tcodecs.TopKCodec()
    j_state, t_state = None, None
    for x in (x1, x2):
        (jv, ji, jshape), j_state = jc.encode(jnp.asarray(x), None, j_state)
        (tv, ti, tshape), t_state = tc.encode(_t(x), None, t_state)
        assert tshape == jshape
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(t_state.numpy(), np.asarray(j_state))
        np.testing.assert_array_equal(
            tc.decode((tv, ti, tshape)).numpy(),
            np.asarray(jc.decode((jv, ji, jshape))))
    # torch.topk would ship other indices on such a vector
    y = torch.from_numpy(x1.reshape(-1))
    k = tc.k_for(n)
    if n == 10500:
        assert not torch.equal(torch.topk(y.abs(), k).indices.sort().values,
                               ti.sort().values)


# ================================================================ privacy
@pytest.mark.parametrize("n", [420, 10500])
def test_gaussian_mechanism_matches_reference_given_its_draws(n):
    """Clip, add sigma * z, clamp at 0, with the reference's z: rtol 1e-6,
    atol 1e-7 (the clip norm is a sum taken in another order)."""
    x = _weights(n, n) * 40.0              # L2 norm above the clip radius
    key = jax.random.key(n)
    z = np.asarray(jax.random.normal(key, (n,), jnp.float32))
    for eps, nonneg in ((1.0, True), (0.3, False)):
        jm = jprivacy.GaussianMechanism(epsilon=eps, nonneg=nonneg)
        tm = tprivacy.GaussianMechanism(epsilon=eps, nonneg=nonneg)
        assert tm.sigma == jm.sigma
        want = np.asarray(jm.apply(jnp.asarray(x), key))
        got = tm.apply(_t(x), _t(z))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        if nonneg:
            assert float(got.min()) >= 0.0


def test_channel_applies_noise_then_codec():
    """channel_apply: DP on the outgoing vector first, then the codec,
    each with its own draws."""
    n = 420
    x = _t(_weights(n, 0))
    z, u = torch.randn(n), torch.rand(n)
    draws = FixedDraws(u=u, z=z)
    mech = tprivacy.GaussianMechanism(epsilon=2.0)
    codec = tcodecs.QuantCodec(bits=8)
    got, state = tcodecs.channel_apply(codec, mech, x, draws, None)
    want = tq.quantize_dequant_plain(mech.apply(x, z), u, 127.0)[0]
    assert state is None and torch.equal(got, want)
    with pytest.raises(ValueError):
        tcodecs.channel_apply(None, mech, x, None, None)


def test_privacy_accountant_and_validation():
    acct = tprivacy.PrivacyAccountant()
    mech = tprivacy.GaussianMechanism(epsilon=0.5, delta=1e-6)
    for name in ("a", "b", "a"):
        acct.record(name)
    assert acct.spent("a", mech) == (1.0, 2e-6)
    jacc = jprivacy.PrivacyAccountant(releases=dict(acct.releases))
    assert acct.report(mech) == jacc.report(
        jprivacy.GaussianMechanism(epsilon=0.5, delta=1e-6))
    for bad in ({"epsilon": 0}, {"delta": 1.0}, {"clip": -1.0}):
        with pytest.raises(ValueError):
            tprivacy.GaussianMechanism(**bad)


# ================================================================= budget
def test_budget_choose_matches_reference():
    jspec = jbudget.BudgetSpec(session_bits=10 ** 6, link_bits=5 * 10 ** 5)
    tspec = tbudget.BudgetSpec(session_bits=10 ** 6, link_bits=5 * 10 ** 5)
    assert tbudget.MODEL_WEIGHT_BITS == jbudget.MODEL_WEIGHT_BITS
    for n in (210, 420, 10500, 42000):
        assert tspec.hop_costs(n) == jspec.hop_costs(n)
        assert tspec.serve_costs((n, 10)) == jspec.serve_costs((n, 10))
        costs = tspec.hop_costs(n)
        probes = sorted({c + d for c in costs for d in (-1, 0, 1)} | {0})
        for rem_s in probes + [float("inf")]:
            for rem_l in (rem_s, float("inf"), costs[-1]):
                for floor in (0, 2):
                    assert tspec.choose(n, rem_s, rem_l, floor) == \
                        jspec.choose(n, rem_s, rem_l, floor)


def test_budget_spec_validation():
    with pytest.raises(ValueError):
        tbudget.BudgetSpec(ladder=())
    with pytest.raises(ValueError):
        tbudget.BudgetSpec(ladder=(tcodecs.TopKCodec(),))
    with pytest.raises(ValueError):
        tbudget.BudgetSpec(session_bits=0)


# ============================================================= accounting
def test_rdp_accountants_match_reference_exactly():
    for eps, delta in ((1.0, 1e-5), (0.3, 1e-6), (8.0, 1e-5)):
        jm = jprivacy.GaussianMechanism(epsilon=eps, delta=delta)
        tm = tprivacy.GaussianMechanism(epsilon=eps, delta=delta)
        for k in (0, 1, 2, 6, 40, 1000):
            assert tacct.rdp_epsilon(k, tm) == jacct.rdp_epsilon(k, jm)
            for q in (0.05, 0.5, 1.0):
                assert tacct.subsampled_rdp_epsilon(k, tm, q) == \
                    jacct.subsampled_rdp_epsilon(k, jm, q)
        releases = {"agent0": 6, "agent1": 7, "barrier": 1}
        for name in ("basic", "rdp", "subsampled-rdp"):
            q = 0.25 if name == "subsampled-rdp" else None
            ta = tacct.make_accountant(name, q=q)
            ja = jacct.make_accountant(name, q=q)
            assert type(ta).__name__ == type(ja).__name__
            ta.releases.update(releases)
            ja.releases.update(releases)
            assert ta.report(tm) == ja.report(jm)
            assert ta.spent("agent1", tm) == ja.spent("agent1", jm)
    for alpha in (2, 3, 64, 512):
        assert tacct.sgm_rdp(alpha, 0.1, 1.3) == jacct.sgm_rdp(alpha, 0.1, 1.3)
    with pytest.raises(ValueError):
        tacct.make_accountant("moments")


# ================================================================== draws
def test_default_draws_are_a_function_of_their_coordinates():
    """Same coordinates, same numbers; another round, position, agent,
    request or key gives others; uniforms and normals are separate
    streams; the numbers do not depend on how often a source was asked."""
    src = tdraws.ChannelDraws()
    key = np.array([0, 2], np.uint32)
    a = src.hop(key, 3, 1)
    u1 = a.uniform((5,), "cpu")
    assert torch.equal(src.hop(key, 3, 1).uniform((5,), "cpu"), u1)
    assert torch.equal(a.uniform((5,), "cpu"), u1)
    assert float(u1.min()) >= 0.0 and float(u1.max()) < 1.0
    others = [src.hop(key, 3, 0), src.hop(key, 2, 1),
              src.hop(np.array([0, 3], np.uint32), 3, 1),
              src.serve(key, 1), src.serve(key, 1, request=0),
              src.serve(key, 2)]
    for o in others:
        assert not torch.equal(o.uniform((5,), "cpu"), u1)
    assert not torch.equal(a.normal((5,), "cpu"), u1)
    assert a.normal((5,), "cpu").dtype == torch.float32
    assert tdraws.mix_seed(1, 2) != tdraws.mix_seed(2, 1)
