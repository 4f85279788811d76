"""The kernels' shard modes for tensor parallelism, on the CPU (their plain
versions), and the wrappers' C calls on a stand-in library.

  * The vocab-shard weighted CE: logits cut into 4 column shards, each
    shard's (lse, gold) from ``weighted_ce_shard_fwd`` combined by
    ``tp.combine_ce`` and its dlogits from ``weighted_ce_shard_bwd`` with
    the combined lse, equal the whole-vocab plain versions (loss atol
    1e-6 + rtol 1e-6 in float32, 1e-12 in float64; dlogits the same atol
    and 10x the rtol, as the combined lse is an ulp off the whole one; row
    sums 0).  Every shard holds some row's label.
  * The length-shard ``flash_decode``: a cache cut into 4 chunks of
    positions, each chunk's (o, lse) merged by ``tp.merge_partials``,
    equals the whole-cache plain version (atol 2e-6 + rtol 2e-6,
    float32), with a chunk wholly past ``pos`` (o 0, lse -inf, no NaN),
    ``pos`` on a chunk's first row, a window, and the int8 cache.
  * The wrappers on a stand-in library: the shard forward passes v0 and
    writes gold; the backward passes v0; the shard decode passes the
    chunk's own valid range and an lse pointer, and a chunk with no valid
    position calls nothing.
  * On the meta device (the dry run) the model path's kernels are custom
    ops: their outputs' shapes, and FlopCounterMode counts 4 D a (query,
    key) pair of the attentions and nothing for the CE.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops
from repro_torch.kernels import weighted_ce as twce
from repro_torch.sharding import tp

PARTS = 4


def _ce_inputs(t, v, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((t, v)) * 3).to(dtype)
    labels = torch.from_numpy(rng.integers(0, v, t)).to(torch.int32)
    labels[:PARTS] = torch.arange(PARTS, dtype=torch.int32) * (v // PARTS)
    w = torch.from_numpy(rng.uniform(0.1, 2.0, t)).to(torch.float32)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, t)).to(torch.float32)
    return x, labels, w, g


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12)])
def test_vocab_shard_ce_merges_to_the_whole(dtype, tol):
    t, v = 64, 1000
    x, labels, w, g = _ce_inputs(t, v, dtype)
    loss, lse = twce.weighted_ce_fwd(x, labels, w.to(dtype))
    v_loc = v // PARTS
    parts = [twce.weighted_ce_shard_fwd(x[:, r * v_loc:(r + 1) * v_loc],
                                        labels, r * v_loc)
             for r in range(PARTS)]
    lse_c, gold_c = tp.combine_ce(torch.stack([p[0] for p in parts]),
                                  torch.stack([p[1] for p in parts]))
    inside = [(labels >= r * v_loc) & (labels < (r + 1) * v_loc)
              for r in range(PARTS)]
    assert all(bool(m.any()) for m in inside)
    for (_, gold), m in zip(parts, inside):
        assert bool((gold[~m] == 0).all())
    np.testing.assert_allclose(lse_c.numpy(), lse.numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose((w.to(lse_c.dtype) * (lse_c - gold_c)).numpy(),
                               loss.numpy(), rtol=tol, atol=tol)
    whole = twce.weighted_ce_bwd(x, labels, w.to(dtype), lse, g.to(dtype))
    cut = torch.cat([twce.weighted_ce_shard_bwd(
        x[:, r * v_loc:(r + 1) * v_loc], labels, w.to(dtype), lse_c,
        g.to(dtype), r * v_loc) for r in range(PARTS)], dim=1)
    np.testing.assert_allclose(cut.numpy(), whole.numpy(), atol=tol,
                               rtol=tol * 10)
    rows = cut.to(torch.float64).sum(1)
    np.testing.assert_allclose(rows.numpy(), 0.0, atol=tol * 10)


def _cache(b, kv, s, d, quant, seed=1):
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((b, kv, s, d))).float()
    v = torch.from_numpy(rng.standard_normal((b, kv, s, d))).float()
    if not quant:
        return k, v, {}
    ks = k.abs().amax(-1) / 127
    vs = v.abs().amax(-1) / 127
    kq = torch.round(k / ks[..., None]).to(torch.int8)
    vq = torch.round(v / vs[..., None]).to(torch.int8)
    return kq, vq, dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pos,window", [(40, None), (32, None), (63, None),
                                        (50, 20), (16, 16)])
def test_length_shard_decode_merges_to_the_whole(quant, pos, window):
    """S 64 in 4 chunks of 16: pos 40 leaves chunk 3 past it; pos 32 and
    16 fall on a chunk's first row; a window of 20 at 50 leaves chunks 0
    and 1 before it."""
    b, h, kv, s, d = 2, 8, 2, 64, 32
    q = torch.from_numpy(np.random.default_rng(pos).standard_normal(
        (b, h, d))).float()
    k, v, sc = _cache(b, kv, s, d, quant)
    whole = tfd.flash_decode_plain(q, k, v, pos, window=window, **sc)
    n = s // PARTS
    os_, lses = [], []
    for r in range(PARTS):
        cut = {key: val[:, :, r * n:(r + 1) * n] for key, val in sc.items()}
        o, lse = tfd.flash_decode_shard(q, k[:, :, r * n:(r + 1) * n],
                                        v[:, :, r * n:(r + 1) * n], pos,
                                        r * n, window=window, **cut)
        assert o.dtype == lse.dtype == torch.float32
        lo, hi = tfd.valid_range(pos, n, window, r * n)
        if hi < lo:
            assert bool((o == 0).all()) and bool(torch.isneginf(lse).all())
        os_.append(o)
        lses.append(lse)
    merged = tp.merge_partials(torch.stack(os_), torch.stack(lses))
    assert bool(torch.isfinite(merged).all())
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), atol=2e-6,
                               rtol=2e-6)


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    for mod in (twce, tfd):
        monkeypatch.setattr(mod, "on_card", lambda x, what: True)
        monkeypatch.setattr(mod, "_lib", lambda: lib)
    monkeypatch.setattr(tfd, "current",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tfd, "raw_stream", lambda device: 7)
    monkeypatch.setattr(tfd, "sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return lib


def test_ce_shard_wrappers_pass_v0(fake_card):
    x = torch.zeros(8, 2 * 512, dtype=torch.bfloat16)[:, 512:]
    labels = torch.arange(8, dtype=torch.int32)
    w = torch.ones(8)
    before = (twce.weighted_ce_shard_fwd.launches,
              twce.weighted_ce_shard_bwd.launches,
              twce.weighted_ce_bwd.launches)
    lse, gold = twce.weighted_ce_shard_fwd(x, labels, 512)
    twce.weighted_ce_shard_bwd(x, labels, w, lse, torch.ones(8), 512)
    (f_name, f_args), (b_name, b_args) = fake_card.calls
    assert f_name == "weighted_ce_shard_fwd" and b_name == "weighted_ce_bwd"
    assert f_args[5:9] == (8, 512, 1024, 512) and f_args[-1] == 7
    assert f_args[3] == gold.data_ptr() and f_args[4] == lse.data_ptr()
    assert b_args[7:12] == (8, 512, 1024, 512, 512)
    assert (twce.weighted_ce_shard_fwd.launches,
            twce.weighted_ce_shard_bwd.launches,
            twce.weighted_ce_bwd.launches) == (before[0] + 1, before[1] + 1,
                                               before[2])


def test_decode_shard_passes_its_own_range_and_lse(fake_card):
    b, h, kv, s, d = 4, 16, 8, 2048, 128
    q = torch.zeros(b, h, d, dtype=torch.bfloat16)
    k = torch.zeros(b, s, kv, d, dtype=torch.bfloat16).transpose(1, 2)
    before = tfd.flash_decode_shard.launches
    o, lse = tfd.flash_decode_shard(q, k, k, 5000, 4096)
    (name, args), = fake_card.calls
    assert name == "flash_decode" and o.dtype == torch.float32
    assert args[15:17] == (0, 5000 - 4096)          # lo, hi of this chunk
    assert args[-2] == lse.data_ptr() and args[5] == o.data_ptr()
    o, lse = tfd.flash_decode_shard(q, k, k, 5000, 6144)   # past pos
    assert len(fake_card.calls) == 1
    assert bool((o == 0).all()) and bool(torch.isneginf(lse).all())
    assert tfd.flash_decode_shard.launches == before + 1
    with pytest.raises(ValueError, match="s0"):
        tfd.flash_decode_shard(q, k, k, 5, -1)


def test_model_path_kernels_on_meta_count_their_products():
    from torch.utils.flop_counter import FlopCounterMode
    q = torch.empty(2, 8, 64, 32, device="meta")
    k = torch.empty(2, 2, 64, 32, device="meta")
    x = torch.empty(16, 1000, device="meta", requires_grad=True)
    labels = torch.zeros(16, dtype=torch.int32, device="meta")
    w = torch.ones(16, device="meta")
    with FlopCounterMode(display=False) as fc:
        assert ops.flash_attention(q, k, k, window=16).shape == q.shape
        o = ops.flash_decode(q[:, :, 0], k, k, 40)
        o2, lse = ops.flash_decode_shard(q[:, :, 0], k, k, 40, 32)
        ops.weighted_ce(x, labels, w).sum().backward()
        lse_l, gold = ops.weighted_ce_shard_fwd(x, labels, 1000)
    assert o.shape == o2.shape == (2, 8, 32) and lse.shape == (2, 8)
    assert lse_l.shape == gold.shape == (16,) and x.grad.shape == x.shape
    pairs = sum(min(i, 15) + 1 for i in range(64))      # causal, window 16
    assert ops.attention_pairs(64, 64, True, 16) == pairs
    assert fc.get_total_flops() == 4 * 2 * 8 * 32 * (pairs + 41 + 9)
    assert math.isclose(ops.attention_pairs(4, 10, False, None), 40)
