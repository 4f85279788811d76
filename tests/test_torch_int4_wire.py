"""The int4 wire as one launch each way: the int4 codec's encode (the
quantize with the pack as its epilogue, ``quantize_pack_int4``) and decode
(the unpack with the dequantize, ``unpack_dequant_int4``), in
``kernels/quantize.py`` and ``csrc/quantize.cu``.

On the CPU the wrappers run their plain versions.  The tests here hold
those against the JAX package, bytes and scales exact and the decode bit
for bit; the kernels' index maps (which thread of the encode stores a
byte, which thread of the decode takes which word of the wire) against the
elements they must cover;
and the wrappers' card path, down to a stand-in library that records the C
calls, against the plans.  The ``gpu`` test holds the kernels against their
plain versions on a card, bit for bit.

The reference side runs as its codec runs it: ``ref.quantize_dequant``
jitted with a constant qmax (XLA turns the division by qmax into the
reciprocal's product, as the port computes it) and the Pallas pack in
interpret mode.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.comm import codecs as tcodecs
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as tq

VECTORS = (1, 2, 7, 1023, 1024, 10500, 42000)
BLOCKS = ((4500, 2), (18000, 10), (2040, 10), (1024, 3), (3069, 3))
SHAPES = [(n,) for n in VECTORS] + list(BLOCKS)


def _tile(shape) -> int:
    if len(shape) == 2:
        return tq.rows_for(*shape) * shape[1]
    return tq.tile_for(shape[0])


def _xu(shape, seed):
    """Signed values with a few large ones, and draws in [0, 1)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    u = rng.random(shape, dtype=np.float32)
    return x, u


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x):
    """float32 values as their bit patterns, so -0.0 differs from 0.0."""
    return np.asarray(x, np.float32).view(np.int32)


class _Draws:
    """Uniforms handed in as a tensor."""

    def __init__(self, u):
        self.u = u

    def uniform(self, shape, device):
        assert tuple(self.u.shape) == tuple(shape)
        return self.u.to(device)


def _reference_wire(x, u):
    """The reference's int4 wire: its quantize jitted with qmax 7 a
    constant, then its Pallas pack in interpret mode."""
    fn = jref.quantize_dequant_block if x.ndim == 2 else jref.quantize_dequant
    _, q, scales = jax.jit(lambda a, b: fn(a, b, 7.0))(jnp.asarray(x),
                                                       jnp.asarray(u))
    return np.asarray(jops.pack_int4(q, interpret=True)), np.asarray(scales)


# ------------------------------------------------------ reference parity
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_encode_matches_reference(shape):
    """Packed bytes and scales exact, through the wrapper, ``ops`` and the
    plain version, at odd n and at the odd 1023-element row tiles."""
    x, u = _xu(shape, sum(shape))
    want_packed, want_scales = _reference_wire(x, u)
    tile = _tile(shape)
    for fn in (tq.quantize_pack_int4, ops.quantize_pack_int4,
               tq.quantize_pack_int4_plain):
        packed, scales = fn(_t(x), _t(u), 7.0, tile)
        assert packed.dtype == torch.int8 and scales.dtype == torch.float32
        np.testing.assert_array_equal(packed.numpy(), want_packed)
        np.testing.assert_array_equal(scales.numpy(), want_scales)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_codec_wire_and_decode_match_reference(shape):
    """``QuantCodec(bits=4)``: the wire equals the reference codec's given
    its uniforms, and the decode equals the reference's decode and the
    port's roundtrip bit for bit."""
    x = _xu(shape, 3)[0]
    key = jax.random.key(5)
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32))
    jc, tc = jcodecs.QuantCodec(bits=4), tcodecs.QuantCodec(bits=4)
    jwire = jax.jit(lambda v, k: jc.encode(v, k)[0])(jnp.asarray(x), key)
    wire, _ = tc.encode(_t(x), _Draws(_t(u)))
    np.testing.assert_array_equal(wire[0].numpy(), np.asarray(jwire[0]))
    np.testing.assert_array_equal(wire[1].numpy(), np.asarray(jwire[1]))
    assert wire[2] == tuple(jwire[2]) == shape
    decoded = tc.decode(wire)
    assert decoded.shape == shape and decoded.dtype == torch.float32
    want = np.asarray(jc.decode(jwire))
    np.testing.assert_array_equal(_bits(decoded.numpy()), _bits(want))
    fused, _ = tc.roundtrip(_t(x), _Draws(_t(u)))
    np.testing.assert_array_equal(_bits(decoded.numpy()),
                                  _bits(fused.numpy()))
    n = int(np.prod(shape))
    flat = tq.unpack_dequant_int4_plain(wire[0], wire[1], n, _tile(shape))
    np.testing.assert_array_equal(_bits(flat.numpy()),
                                  _bits(want.reshape(-1)))


@pytest.mark.parametrize("stochastic", [True, False])
def test_codec_round_half_up_and_stochastic_decode_equal_roundtrip(
        stochastic):
    """Both roundings: decode(encode(x)) = roundtrip(x), an element never
    more than one step from its input."""
    x, u = _xu((3069, 3), 9)
    codec = tcodecs.QuantCodec(bits=4, stochastic=stochastic)
    draws = _Draws(_t(u)) if stochastic else None
    wire, _ = codec.encode(_t(x), draws)
    decoded = codec.decode(wire)
    assert torch.equal(decoded, codec.roundtrip(_t(x), draws)[0])
    steps = wire[1].repeat_interleave(_tile((3069, 3))).reshape(3069, 3)
    assert bool(((decoded - _t(x)).abs() <= steps).all())


# ------------------------------------------------ the kernels' index maps
def _packed_bytes(n, tile, p):
    """Under plan ``p``, the wire byte each thread of the fused encode
    stores, as ``quantize_fused`` maps them: thread t of a share the pairs
    of elements 2 (t + 512 j) and 2 (t + 512 j) + 1, j < ceil(kK / 2), a
    byte for each pair whose first element is in the share; the pair must
    be elements 2b and 2b + 1 of the payload, the second in the share or
    past the payload's end (the pad)."""
    stored = []
    ctas = 1 if p.route == "cta" else p.cluster
    kk = -(-p.per_cta // tq.THREADS)
    kk = 1 << (kk - 1).bit_length()          # the instantiation: 1, 2, 4 ..
    pairs = -(-kk // 2)
    for t in range(n // tile):
        for rank in range(ctas):
            lo = rank * p.per_cta
            count = min(p.per_cta, tile - lo)
            base = t * tile + lo
            for thread in range(tq.THREADS):
                for j in range(pairs):
                    off = 2 * (thread + tq.THREADS * j)
                    if off < count:
                        i = base + off
                        assert i % 2 == 0, (n, tile, p, i)
                        assert off + 1 < count or i + 1 == n, (n, tile, p)
                        stored.append(i // 2)
    return stored


@pytest.mark.parametrize("limit", [tq.PORTABLE_CLUSTER, tq.MAX_CLUSTER])
def test_fused_pack_epilogue_stores_every_byte_once(limit):
    """Every wire byte stored once, by the thread that holds both of its
    elements, for every plan the fused encode takes (even tiles, or a
    payload's only tile)."""
    cases = [(n, n) for n in (1, 2, 7, 1023, 1024, 1025, 3072, 8193, 16385,
                              42000, 10501)]
    cases += [(4 * 1024, 1024), (9 * 1020, 1020), (3 * 9000, 9000),
              (2 * 2050, 2050)]
    for n, tile in cases:
        p = tq.plan(tile, limit)
        assert p.route != "large"
        stored = _packed_bytes(n, tile, p)
        assert sorted(stored) == list(range((n + 1) // 2)), (n, tile)


def _unpack_cover(n, misalign):
    """How often the int4 decode writes each element of an n-element wire
    whose first byte lies ``misalign`` bytes past a 4-byte boundary
    (``unpack_dequant_int4`` and ``unpack_dequant_kernel``): thread g <
    words reads its word, and a warp stores its words in two runs where
    lane l stores half l % 2 of the word of lane 16 s + l / 2 at
    consecutive 16 bytes; threads words + e, e < 8, the head and tail
    bytes."""
    full, nbytes = n // 2, (n + 1) // 2
    head = min((4 - misalign) % 4, full)
    words = (full - head) // 4
    hits = np.zeros(n, np.int64)
    threads = -(-(words + 8) // 128) * 128
    for warp in range(0, threads, 32):
        for lane in range(32):
            g = warp + lane
            if g < words:
                assert (misalign + head + 4 * g) % 4 == 0  # an aligned word
            for s in range(2):
                gs = warp + 16 * s + lane // 2
                if gs < words:
                    i = 2 * head + 8 * gs + 4 * (lane % 2)
                    assert i == 2 * head + 8 * warp + 128 * s + 4 * lane
                    assert i + 4 <= n
                    hits[i:i + 4] += 1
            if g < words:
                continue
            e = g - words
            j = (e if e < head else -1) if e < 4 else head + 4 * words + e - 4
            if 0 <= j < nbytes:
                hits[2 * j] += 1
                if 2 * j + 1 < n:
                    hits[2 * j + 1] += 1
    return hits


@pytest.mark.parametrize("misalign", range(4))
def test_unpack_word_layout_covers_every_element_once(misalign):
    for n in [*range(1, 70), 1023, 1024, 42000, 42001]:
        hits = _unpack_cover(n, misalign)
        assert (hits == 1).all(), (n, misalign)


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
    monkeypatch.setattr(tq, "on_card", lambda x, what: True)
    monkeypatch.setattr(tq, "_lib", lambda: lib)
    monkeypatch.setattr(tq, "current", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tq, "raw_stream", lambda device: 7)
    monkeypatch.setattr(tq, "cluster_limit", lambda index: request.param)
    lib.limit = request.param
    return lib


_COUNTERS = ("quantize_dequant_tiles", "quantize_dequant_block", "pack_int4",
             "unpack_int4", "quantize_pack_int4", "unpack_dequant_int4")


def _counts():
    return {name: getattr(tq, name).launches for name in _COUNTERS}


def _moved(before):
    """The counters that moved since ``before``, by how much."""
    return {name: count - before[name] for name, count in _counts().items()
            if count != before[name]}


@pytest.mark.parametrize("shape", [(42000,), (10500,), (7,), (2 ** 20,),
                                   (18000, 10), (4500, 2), (2040, 10),
                                   (1024, 3)], ids=str)
def test_int4_encode_is_one_call_with_its_plan(fake_card, shape):
    x, u = torch.zeros(shape), torch.zeros(shape)
    before = _counts()
    (packed, scales, wshape), _ = tcodecs.QuantCodec(bits=4).encode(
        x, _Draws(u))
    (name, args), = fake_card.calls
    tile, n = _tile(shape), x.numel()
    p = tq.plan(tile, fake_card.limit)
    assert name == "quantize_pack_int4"
    assert args[:4] == (x.data_ptr(), u.data_ptr(), packed.data_ptr(),
                        scales.data_ptr())
    assert args[4:] == (n, tile, p.cluster, p.per_cta, 7.0, tq.inv_qmax(7),
                        7)
    assert packed.shape == ((n + 1) // 2,) and packed.dtype == torch.int8
    assert scales.shape == (n // tile,) and wshape == shape
    assert _moved(before) == {"quantize_pack_int4": 1}


@pytest.mark.parametrize("shape", [(42000,), (7,), (18000, 10), (3069, 3)],
                         ids=str)
def test_int4_decode_is_one_call(fake_card, shape):
    n, tile = int(np.prod(shape)), _tile(shape)
    packed = torch.zeros((n + 1) // 2, dtype=torch.int8)
    scales = torch.ones(n // tile)
    before = _counts()
    xhat = tcodecs.QuantCodec(bits=4).decode((packed, scales, shape))
    (name, args), = fake_card.calls
    assert name == "unpack_dequant_int4"
    assert args == (packed.data_ptr(), scales.data_ptr(), xhat.data_ptr(),
                    n, tile, 7)
    assert xhat.shape == shape and xhat.dtype == torch.float32
    assert _moved(before) == {"unpack_dequant_int4": 1}


def test_int4_encode_of_odd_tiles_is_two_calls(fake_card):
    """The [3069, 3] block's nine tiles of 1023: the quantize-dequant,
    then the standalone pack of its q."""
    x, u = torch.zeros(3069, 3), torch.zeros(3069, 3)
    before = _counts()
    (packed, scales, _), _ = tcodecs.QuantCodec(bits=4).encode(x, _Draws(u))
    (n1, a1), (n2, a2) = fake_card.calls
    p = tq.plan(1023, fake_card.limit)
    assert n1 == "quantize_dequant" and n2 == "pack_int4"
    assert a1[4] == scales.data_ptr()
    assert a1[5:] == (9207, 1023, p.cluster, p.per_cta, 7.0, tq.inv_qmax(7),
                      7)
    assert a2 == (a1[3], packed.data_ptr(), 9207, 7)    # q -> the wire
    assert _moved(before) == {"quantize_dequant_block": 1, "pack_int4": 1}


def test_int4_encode_of_an_offset_view_is_two_calls(fake_card):
    """x off an 8-byte boundary cannot be read in pairs: the
    quantize-dequant, then the pack."""
    buf = torch.zeros(42001)
    x, u = buf[1:], torch.zeros(42000)
    assert x.data_ptr() % 8 == 4
    before = _counts()
    ops.quantize_pack_int4(x, u, 7, 42000)
    assert [name for name, _ in fake_card.calls] == ["quantize_dequant",
                                                     "pack_int4"]
    assert _moved(before) == {"quantize_dequant_tiles": 1, "pack_int4": 1}


def test_int4_encode_large_tile_route(fake_card):
    n = 2 ** 20 + 3           # one odd tile above LARGE_TILE
    x, u = torch.zeros(n), torch.zeros(n)
    before = _counts()
    packed, scales = ops.quantize_pack_int4(x, u, 7, n)
    (name, args), = fake_card.calls
    assert name == "quantize_pack_int4_large"
    assert args[2:4] == (packed.data_ptr(), scales.data_ptr())
    assert args[5:] == (n, n, 7.0, tq.inv_qmax(7), 7)   # args[4]: scratch
    assert _moved(before) == {"quantize_pack_int4": 1}


def test_int4_wire_checks_inputs_before_any_call(fake_card):
    x, u = torch.zeros(4500, 2), torch.zeros(4500, 2)
    before = _counts()
    with pytest.raises(ValueError):
        ops.quantize_pack_int4(x, u, 127, 9000)       # not an int4 carrier
    with pytest.raises(ValueError):
        ops.quantize_pack_int4(x, u, 7, 7000)         # tiles do not split
    with pytest.raises(ValueError):
        ops.quantize_pack_int4(x, u[:4000], 7, 9000)
    with pytest.raises(TypeError):
        ops.quantize_pack_int4(x.double(), u.double(), 7, 9000)
    with pytest.raises(ValueError):
        ops.quantize_pack_int4(x.t(), u.t(), 7, 9000)  # not contiguous
    with pytest.raises(ValueError):
        tcodecs.QuantCodec(bits=4).encode(torch.zeros(2, 3, 4),
                                          _Draws(torch.zeros(2, 3, 4)))
    packed, scales = torch.zeros(4500, dtype=torch.int8), torch.ones(1)
    with pytest.raises(ValueError):
        ops.unpack_dequant_int4(packed[:4000], scales, 9000, 9000)
    with pytest.raises(ValueError):
        ops.unpack_dequant_int4(packed, torch.ones(2), 9000, 9000)
    with pytest.raises(TypeError):
        ops.unpack_dequant_int4(packed, scales.double(), 9000, 9000)
    with pytest.raises(TypeError):
        ops.unpack_dequant_int4(packed.to(torch.uint8), scales, 9000, 9000)
    with pytest.raises(ValueError):
        ops.unpack_dequant_int4(packed, scales, 9000, 0)
    assert fake_card.calls == []
    assert _moved(before) == {}


# ---------------------------------------------------------------- the card
def _card_shapes():
    """The main path's payloads, both sides of each boundary of the plan
    (one CTA, the cluster limits, LARGE_TILE), 2^20 + 3, odd n, odd
    multi-tile blocks."""
    shapes = [(n,) for n in (1, 2, 7, 1023, 1024, 1025, 8192, 8193, 16384,
                             16385, 42000, 42001, 2 ** 18 - 1, 2 ** 18,
                             2 ** 18 + 1, 2 ** 20 + 3)]
    return shapes + list(BLOCKS)


@pytest.mark.gpu
def test_int4_wire_equals_plain_on_card():
    """The fused encode and decode and the standalone pack and unpack
    against their plain versions on the card, bit for bit, two runs the
    same bits, and the wire read from offset (unaligned) views (skips
    without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in _card_shapes():
        x = (torch.rand(shape, generator=gen, device=dev) - 0.3) * 5
        u = torch.rand(shape, generator=gen, device=dev)
        n, tile = x.numel(), _tile(shape)
        packed, scales = ops.quantize_pack_int4(x, u, 7.0, tile)
        want_p, want_s = tq.quantize_pack_int4_plain(x, u, 7.0, tile)
        assert torch.equal(packed, want_p) and torch.equal(scales, want_s), \
            shape
        again = ops.quantize_pack_int4(x, u, 7.0, tile)
        assert torch.equal(again[0], packed) and torch.equal(again[1],
                                                             scales)
        xhat = ops.unpack_dequant_int4(packed, scales, n, tile)
        want = tq.unpack_dequant_int4_plain(packed, scales, n, tile)
        assert torch.equal(xhat.view(torch.int32), want.view(torch.int32)), \
            shape
        roundtrip = tq.quantize_dequant_plain(x.reshape(-1), u.reshape(-1),
                                              7.0, bn=tile)[0]
        assert torch.equal(xhat, roundtrip), shape
        xbuf = torch.empty(n + 1, device=dev)         # x off 8 bytes
        xbuf[1:].copy_(x.reshape(-1))
        got = ops.quantize_pack_int4(xbuf[1:].view(shape), u, 7.0, tile)
        assert torch.equal(got[0], packed) and torch.equal(got[1], scales)
        q = tq.unpack_int4_plain(packed, n)
        assert torch.equal(ops.pack_int4(q), packed), shape
        assert torch.equal(ops.unpack_int4(packed, n), q), shape
        for lead in (1, 2, 3):                 # offset views of the wire
            buf = torch.empty(lead + packed.numel(), dtype=torch.int8,
                              device=dev)
            view = buf[lead:]
            view.copy_(packed)
            assert torch.equal(
                ops.unpack_dequant_int4(view, scales, n, tile).view(
                    torch.int32), want.view(torch.int32)), (shape, lead)
            assert torch.equal(ops.unpack_int4(view, n), q), (shape, lead)
            qbuf = torch.empty(lead + n, dtype=torch.int8, device=dev)
            qbuf[lead:].copy_(q)
            assert torch.equal(ops.pack_int4(qbuf[lead:]), packed), \
                (shape, lead)
