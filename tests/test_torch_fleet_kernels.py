"""The hop's kernels over a fleet of sessions: the batched ignorance update
(``kernels/ignorance.py::ignorance_update_batched``, one launch of
``csrc/ignorance.cu`` for F rows) and the vmap rules of the hop's custom
ops (``kernels/ops.py``), which ``core.compiled.fleet_run`` reaches through
``torch.func.vmap``.

Exact throughout: each row of a batched call, plain version or vmap rule,
must give the bits of the single call on that row alone (the same tiles,
summed or scaled in the same order).  The card path is held to the C
calls a stand-in library records (the pattern of
tests/test_torch_hop_kernels.py); the ``gpu`` test holds the batched
launch to its plain version and to F single launches on the card.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ignorance as ig
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as tq

# the main path's hops (blob, MIMIC, Fashion), both sides of the cluster
# plan's boundaries, a ragged tile and the large-n route
NS = [1, 420, 1024, 1025, 8193, 10500, 42000, ig.LARGE_N + 1]


def _batch(rows, n, seed, zero_rows=False):
    rng = np.random.default_rng(seed)
    w = rng.random((rows, n), dtype=np.float32) + 0.01
    w /= w.sum(axis=1, keepdims=True)
    r = (rng.random((rows, n)) > 0.4).astype(np.float32)
    a = (rng.random(rows) * 4 - 1).astype(np.float32)
    if zero_rows:
        r[0] = 1.0          # a row with no misses: exp(0) everywhere
        a[-1] = 0.0
    return torch.from_numpy(w), torch.from_numpy(r), torch.from_numpy(a)


@pytest.mark.parametrize("n", NS)
def test_batched_plain_rows_equal_single_plain(n):
    rows = 3 if n > 50000 else 5
    w, r, a = _batch(rows, n, n, zero_rows=True)
    got = ig.ignorance_update_batched(w, r, a)
    assert got.shape == (rows, n)
    for f in range(rows):
        want = ig.ignorance_update_plain(w[f], r[f], a[f])
        assert torch.equal(got[f], want), f


def test_batched_plain_is_the_plain_function():
    w, r, a = _batch(4, 3000, 1)
    assert torch.equal(ig.ignorance_update_batched(w, r, a),
                       ig.ignorance_update_batched_plain(w, r, a))


@pytest.mark.parametrize("bad", ["shape", "alpha", "dtype", "stride"])
def test_batched_checks_its_inputs(bad):
    w, r, a = _batch(3, 100, 2)
    if bad == "shape":
        args = (w, r[:, :50], a)
    elif bad == "alpha":
        args = (w, r, a[:2])
    elif bad == "dtype":
        args = (w.double(), r, a)
    else:
        args = (w.t().contiguous().t(), r, a)
    with pytest.raises((ValueError, TypeError)):
        ig.ignorance_update_batched(*args)


# ------------------------------------------------------------ the vmap rules
@pytest.mark.parametrize("n", [1, 420, 2048, 10500])
@pytest.mark.parametrize("shared_w", [False, True])
def test_ignorance_vmap_rule_gives_each_session_its_own_call(n, shared_w):
    w, r, a = _batch(4, n, n + 7)
    in_dims = (None if shared_w else 0, 0, 0)
    got = torch.func.vmap(ops.ignorance_update, in_dims=in_dims)(
        w[0] if shared_w else w, r, a)
    for f in range(4):
        want = ops.ignorance_update(w[0] if shared_w else w[f], r[f], a[f])
        assert torch.equal(got[f], want), f


@pytest.mark.parametrize("n", [1, 420, 1023, 2048, 10500, 42000])
@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_quantize_vmap_rule_gives_each_session_its_own_call(n, qmax):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    u = torch.from_numpy(rng.random((3, n), dtype=np.float32))
    got = torch.func.vmap(lambda x, u: ops.quantize_dequant(x, u, qmax))(x, u)
    for f in range(3):
        want = ops.quantize_dequant(x[f], u[f], qmax)
        for g, w_ in zip(got, want):
            assert torch.equal(g[f], w_), f


@pytest.mark.parametrize("n", [1, 7, 420, 1023, 2048, 10501])
def test_int4_vmap_rules_give_each_session_its_bytes(n):
    """Odd n included: a flat wire would put one session's last nibble and
    the next one's first into one byte."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
    u = torch.from_numpy(rng.random((3, n), dtype=np.float32))
    tile = tq.tile_for(n)
    packed, scales = torch.func.vmap(
        lambda x, u: ops.quantize_pack_int4(x, u, 7.0, tile))(x, u)
    xhat = torch.func.vmap(
        lambda p, s: ops.unpack_dequant_int4(p, s, n, tile))(packed, scales)
    assert packed.shape == (3, (n + 1) // 2)
    for f in range(3):
        p1, s1 = ops.quantize_pack_int4(x[f], u[f], 7.0, tile)
        assert torch.equal(packed[f], p1) and torch.equal(scales[f], s1), f
        assert torch.equal(xhat[f], ops.unpack_dequant_int4(p1, s1, n, tile))
        # and the wire decodes to the quantize-dequant's xhat
        assert torch.equal(xhat[f], ops.quantize_dequant(x[f], u[f], 7.0)[0])


def test_int4_vmap_rule_on_odd_tiles_of_a_block():
    """[3069, 3] blocks: nine odd tiles of 1023 a payload, an odd count."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3069, 3)).astype(np.float32))
    u = torch.from_numpy(rng.random((2, 3069, 3), dtype=np.float32))
    tile = tq.rows_for(3069, 3) * 3
    packed, scales = torch.func.vmap(
        lambda x, u: ops.quantize_pack_int4(x, u, 7.0, tile))(x, u)
    for f in range(2):
        p1, s1 = ops.quantize_pack_int4(x[f], u[f], 7.0, tile)
        assert torch.equal(packed[f], p1) and torch.equal(scales[f], s1)


def test_eager_calls_bypass_the_dispatcher():
    """Outside a transform the wrappers call the kernels directly (same
    bits, no dispatcher host time); inside one they reach the ops."""
    assert not ops._transformed()
    seen = []
    torch.func.vmap(lambda x: seen.append(ops._transformed()) or x)(
        torch.zeros(2, 3))
    assert seen == [True]


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


@pytest.mark.parametrize("rows,n", [(32, 10500), (8, 42000), (2, 420),
                                    (5, ig.LARGE_N)])
def test_batched_update_is_one_cluster_call(fake_card, rows, n):
    w, r, a = _batch(rows, n, 5)
    before = ig.ignorance_update_batched.launches
    out = ig.ignorance_update_batched(w, r, a)
    (name, args), = fake_card.calls
    p = ig.plan(n, fake_card.limit)
    assert name == "ignorance_update_batched"
    assert args[:4] == (w.data_ptr(), r.data_ptr(), a.data_ptr(),
                        out.data_ptr())
    assert args[4:] == (n, rows, p.cluster, p.tiles_per_cta, 7)
    assert out.shape == (rows, n)
    assert ig.ignorance_update_batched.launches == before + 1


def test_batched_update_splits_rows_above_the_grid(fake_card):
    """Above MAX_ROWS rows, one launch a block of MAX_ROWS rows."""
    rows = ig.MAX_ROWS + 3
    w, r, a = (torch.zeros(rows, 4), torch.zeros(rows, 4),
               torch.zeros(rows))
    before = ig.ignorance_update_batched.launches
    out = ig.ignorance_update_batched(w, r, a)
    assert [c[0] for c in fake_card.calls] == ["ignorance_update_batched"] * 2
    (_, first), (_, second) = fake_card.calls
    assert first[5] == ig.MAX_ROWS and second[5] == 3
    assert second[0] == w[ig.MAX_ROWS].data_ptr()
    assert second[3] == out[ig.MAX_ROWS].data_ptr()
    assert ig.ignorance_update_batched.launches == before + 2


def test_batched_update_large_n_route(fake_card):
    n = ig.LARGE_N + 1
    w, r, a = _batch(3, n, 6)
    ig.ignorance_update_batched(w, r, a)
    (name, args), = fake_card.calls
    assert name == "ignorance_update_large_batched"
    assert args[5:] == (n, 3, 7) and args[4] not in args[:4]


def test_vmap_rule_makes_one_batched_launch(fake_card):
    """A fleet's hop is one launch of the batched kernel, counted once."""
    w, r, a = _batch(6, 10500, 7)
    single = ig.ignorance_update.launches
    before = ig.ignorance_update_batched.launches
    torch.func.vmap(ops.ignorance_update)(w, r, a)
    assert [c[0] for c in fake_card.calls] == ["ignorance_update_batched"]
    assert ig.ignorance_update_batched.launches == before + 1
    assert ig.ignorance_update.launches == single


def test_quantize_vmap_rule_is_one_call_in_the_rows_tiles(fake_card):
    x, u = torch.zeros(4, 10500), torch.zeros(4, 10500)
    before = tq.quantize_dequant_tiles.launches
    torch.func.vmap(lambda x, u: ops.quantize_dequant(x, u, 127.0))(x, u)
    (name, args), = fake_card.calls
    assert name == "quantize_dequant"
    assert args[5:7] == (4 * 10500, 10500)   # the payload, each row a tile
    assert tq.quantize_dequant_tiles.launches == before + 1


@pytest.mark.parametrize("n", [7, 10501])
def test_int4_odd_rows_decode_is_one_strided_call(fake_card, n):
    """An odd n decodes F rows in one launch that reads each row's wire at
    its stride (the flat wire would cross rows mid-byte)."""
    rows, tile = 3, tq.tile_for(n)
    packed = torch.zeros((rows, (n + 1) // 2), dtype=torch.int8)
    scales = torch.ones((rows, n // tile))
    before = tq.unpack_dequant_int4.launches
    out = torch.func.vmap(
        lambda p, s: ops.unpack_dequant_int4(p, s, n, tile))(packed, scales)
    (name, args), = fake_card.calls
    assert name == "unpack_dequant_int4_rows"
    assert args[:2] == (packed.data_ptr(), scales.data_ptr())
    assert args[3:] == (rows, n, tile, 7)
    assert out.shape == (rows, n)
    assert tq.unpack_dequant_int4.launches == before + 1


# ---------------------------------------------------------------- the card
@pytest.mark.gpu
def test_batched_update_equals_plain_and_single_launches_on_card():
    """The batched launch against its plain version and against F single
    launches, bit for bit, at the fleets' sizes and above 2^16 (skips
    without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for rows, n in ((32, 15000), (8, 42000), (32, 10500), (3, 2 ** 17 + 5),
                    (4, 1), (ig.MAX_ROWS + 2, 3)):
        w, r, a = (t.to(dev) for t in _batch(rows, n, rows * n))
        got = ig.ignorance_update_batched(w, r, a)
        assert torch.equal(got, ig.ignorance_update_batched_plain(w, r, a))
        for f in range(min(rows, 40)):
            assert torch.equal(got[f], ops.ignorance_update(w[f], r[f],
                                                            a[f])), (n, f)
        assert torch.equal(ig.ignorance_update_batched(w, r, a), got)


@pytest.mark.gpu
def test_int4_rows_decode_equals_plain_on_card():
    """The fleet's int4 decode on the card against its plain version and
    each row's own decode, odd n (the strided launch) and even, bit for
    bit (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for rows, n in ((32, 10501), (8, 7), (3, 1), (4, 42000)):
        rng = np.random.default_rng(n)
        x = torch.from_numpy(rng.standard_normal((rows, n)).astype(
            np.float32)).to(dev)
        u = torch.from_numpy(rng.random((rows, n), dtype=np.float32)).to(dev)
        tile = tq.tile_for(n)
        packed, scales = tq.quantize_pack_int4_rows(x, u, 7.0, tile)
        got = tq.unpack_dequant_int4_rows(packed, scales, n, tile)
        assert torch.equal(got, tq.unpack_dequant_int4_rows_plain(
            packed, scales, n, tile)), (rows, n)
        for f in range(rows):
            assert torch.equal(got[f], tq.unpack_dequant_int4(
                packed[f].contiguous(), scales[f].contiguous(), n, tile))
