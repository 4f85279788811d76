"""The serve codec's block quantize-dequant over a serve bucket's slots
(``kernels/quantize.py::quantize_dequant_block_rows``, one launch of
``csrc/quantize.cu`` for B blocks) and the vmap rule of its custom op
(``kernels/ops.py``), which ``core.compiled.serve_batch`` reaches through
``torch.func.vmap``.

Exact throughout: block b of a batched call, plain version or vmap rule,
must give the bits of the lone call on block b (each block is a whole
number of the kernel's tiles).  The card path is held to the C calls a
stand-in library records (the pattern of tests/test_torch_fleet_kernels.py);
the ``gpu`` test holds the batched launch to its plain version and to B
lone launches on the card.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import quantize as tq

# MIMIC's request blocks and its held-out block (one global tile), a
# ten-class block, a blob-size block, a block of one row
SHAPES = [(8, 1024, 2), (8, 4500, 2), (8, 1024, 10), (4, 72, 3), (3, 1, 4)]


def _blocks(b, n, k, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, n, k)).astype(np.float32))
    u = torch.from_numpy(rng.random((b, n, k), dtype=np.float32))
    return x, u


@pytest.mark.parametrize("b,n,k", SHAPES)
@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_rows_plain_equals_lone_plain_calls(b, n, k, qmax):
    x, u = _blocks(b, n, k, n * k)
    xhat, q, scales = tq.quantize_dequant_block_rows(x, u, qmax)
    assert torch.equal(xhat, tq.quantize_dequant_block_rows_plain(
        x, u, qmax)[0])
    assert scales.shape == (b, n // tq.rows_for(n, k))
    for i in range(b):
        lone = tq.quantize_dequant_block_plain(x[i], u[i], qmax)
        for got, want in zip((xhat[i], q[i], scales[i]), lone):
            assert torch.equal(got, want), i


@pytest.mark.parametrize("b,n,k", SHAPES[:3])
def test_vmap_rule_gives_each_slot_its_own_call(b, n, k):
    x, u = _blocks(b, n, k, b + n)
    got = torch.func.vmap(
        lambda x, u: ops.quantize_dequant_block(x, u, 127.0))(x, u)
    for i in range(b):
        want = ops.quantize_dequant_block(x[i], u[i], 127.0)
        for g, w_ in zip(got, want):
            assert torch.equal(g[i], w_), i


def test_vmap_rule_with_shared_draws():
    """A deterministic codec's draws are one tensor for every slot."""
    x, u = _blocks(4, 1024, 2, 3)
    got = torch.func.vmap(
        lambda x: ops.quantize_dequant_block(x, u[0], 7.0))(x)
    for i in range(4):
        assert torch.equal(got[0][i],
                           ops.quantize_dequant_block(x[i], u[0], 7.0)[0])


@pytest.mark.parametrize("bad", ["rank", "shape", "dtype", "stride", "qmax"])
def test_rows_checks_its_inputs_before_any_call(bad):
    x, u = _blocks(2, 64, 2, 1)
    args = {"rank": (x[0], u[0], 127.0), "shape": (x, u[:, :32], 127.0),
            "dtype": (x.double(), u, 127.0),
            "stride": (x.transpose(1, 2).contiguous().transpose(1, 2), u,
                       127.0),
            "qmax": (x, u, 200.0)}[bad]
    with pytest.raises((ValueError, TypeError)):
        tq.quantize_dequant_block_rows(*args)


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
    monkeypatch.setattr(tq, "on_card", lambda x, what: True)
    monkeypatch.setattr(tq, "_lib", lambda: lib)
    monkeypatch.setattr(tq, "current", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tq, "raw_stream", lambda device: 7)
    monkeypatch.setattr(tq, "cluster_limit", lambda index: request.param)
    lib.limit = request.param
    return lib


@pytest.mark.parametrize("b,n,k", SHAPES[:3])
def test_vmap_rule_is_one_call_in_the_blocks_tiles(fake_card, b, n, k):
    """A bucket's blocks are one launch on the flat B·n·K payload, in the
    tiles a lone block uses, counted once under its own counter."""
    x, u = _blocks(b, n, k, 2)
    lone = tq.quantize_dequant_block.launches
    before = tq.quantize_dequant_block_rows.launches
    torch.func.vmap(lambda x, u: ops.quantize_dequant_block(x, u, 127.0))(
        x, u)
    (name, args), = fake_card.calls
    tile = tq.rows_for(n, k) * k
    p = tq.plan(tile, fake_card.limit)
    assert name == "quantize_dequant"
    assert args[5:9] == (b * n * k, tile, p.cluster, p.per_cta)
    assert args[9] == 127.0 and args[11] == 7
    assert tq.quantize_dequant_block_rows.launches == before + 1
    assert tq.quantize_dequant_block.launches == lone


def test_eager_block_call_bypasses_the_dispatcher(fake_card):
    """Outside a transform the block wrapper is one direct call, counted
    under the lone counter."""
    x, u = _blocks(1, 1024, 2, 4)
    before = tq.quantize_dequant_block.launches
    ops.quantize_dequant_block(x[0], u[0], 127.0)
    assert [c[0] for c in fake_card.calls] == ["quantize_dequant"]
    assert tq.quantize_dequant_block.launches == before + 1


# ---------------------------------------------------------------- the card
@pytest.mark.gpu
def test_block_rows_equal_plain_and_lone_launches_on_card():
    """The batched launch against its plain version and B lone launches,
    bit for bit, at the serve buckets' shapes (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for b, n, k in SHAPES:
        x, u = (t.to(dev) for t in _blocks(b, n, k, n))
        for qmax in (127.0, 7.0):
            got = tq.quantize_dequant_block_rows(x, u, qmax)
            plain = tq.quantize_dequant_block_rows_plain(x, u, qmax)
            for g, p in zip(got, plain):
                assert torch.equal(g, p), (b, n, k, qmax)
            for i in range(b):
                lone = tq.quantize_dequant_block(x[i], u[i], qmax)
                for g, w_ in zip(got, lone):
                    assert torch.equal(g[i], w_), (b, n, k, i)
