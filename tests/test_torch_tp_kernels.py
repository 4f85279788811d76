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
  * The shard forward's kernel choice (:func:`shard_fwd_plan`: the staged
    kernel where a row fits a stage and a bulk copy's 16-byte rule, else
    the streaming one), and the staged kernel's arithmetic (a max pass,
    then the sum of exp2((x - max) log2 e) in its thread order, warp
    butterflies and the warps in order, in float32) against
    ``weighted_ce_shard_fwd_plain`` within rtol 1e-6.
  * The wrappers on a stand-in library: the shard forward passes v0, its
    plan and writes gold (the staged entry, or the streaming one on a
    misaligned shard); the backward passes v0; the shard decode passes the
    chunk's own valid range, its cluster plan and an lse pointer (the
    split kernel on a range whose blocks would take more than
    ``CLUSTER_MAX_CHUNK`` positions each), and a chunk with no valid
    position calls nothing.
  * On the meta device (the dry run) the model path's kernels are custom
    ops: their outputs' shapes, and FlopCounterMode counts 4 D a (query,
    key) pair of the attentions and nothing for the CE.
  * On the card (``gpu``; skips without one, deciding inside the test; no
    JAX): both shard kernels and their other routes against the plain
    versions at odd shapes.
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
SMS = 132   # an H100's SMs
LOG2E = 1.4426950408889634


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
    monkeypatch.setattr(tfd, "sm_count", lambda index: SMS)
    monkeypatch.setattr(twce, "sm_count", lambda index: SMS)
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
    assert f_name == "weighted_ce_shard_fwd_staged"
    assert b_name == "weighted_ce_bwd"
    assert f_args[5:9] == (8, 512, 1024, 512) and f_args[-1] == 7
    assert f_args[9:12] == (8, 4, 1024)       # grid, stages, stage bytes
    assert f_args[3] == gold.data_ptr() and f_args[4] == lse.data_ptr()
    assert b_args[7:12] == (8, 512, 1024, 512, 512)
    assert (twce.weighted_ce_shard_fwd.launches,
            twce.weighted_ce_shard_bwd.launches,
            twce.weighted_ce_bwd.launches) == (before[0] + 1, before[1] + 1,
                                               before[2])


def test_ce_shard_fwd_streams_a_misaligned_shard(fake_card):
    """A shard starting 2 bytes past a 16-byte boundary takes the streaming
    kernel's shard mode."""
    x = torch.zeros(4, 1024, dtype=torch.bfloat16)[:, 1:513]
    labels = torch.arange(4, dtype=torch.int32)
    before = twce.weighted_ce_shard_fwd.launches
    assert twce.shard_fwd_plan(x, SMS) is None
    lse, gold = twce.weighted_ce_shard_fwd(x, labels, 1)
    (name, args), = fake_card.calls
    assert name == "weighted_ce_shard_fwd" and len(args) == 10
    assert args[5:9] == (4, 512, 1024, 1) and args[-1] == 7
    assert args[3] == gold.data_ptr() and args[4] == lse.data_ptr()
    assert twce.weighted_ce_shard_fwd.launches == before + 1


def _shard(t, total, col0, width, dtype):
    return torch.zeros(t, total, dtype=dtype)[:, col0:col0 + width]


@pytest.mark.parametrize("x,want", [
    # qwen3-0.6b's vocab in 16 shards, shard 3: 18992-byte rows
    (_shard(4, 151936, 3 * 9496, 9496, torch.bfloat16), (4, 2, 19072)),
    (_shard(4, 151936, 3 * 9496, 9496, torch.float32), (4, 2, 38016)),
    (_shard(400, 512, 256, 256, torch.bfloat16), (2 * SMS, 4, 512)),
    (_shard(4, 8192, 0, 8192, torch.bfloat16), (4, 2, 16384)),
    (_shard(4, 4096, 0, 4096, torch.bfloat16), (4, 4, 8192)),
    (_shard(2, 24576, 0, 24576, torch.bfloat16), (2, 2, 49152)),  # 48 KB
    (_shard(4, 151936, 9495, 9496, torch.bfloat16), None),  # base 2 B off
    (_shard(4, 151936, 0, 9497, torch.bfloat16), None),   # V not 8 * n
    (_shard(4, 1001, 0, 1000, torch.bfloat16), None),     # stride 2002 B
    (_shard(2, 24584, 0, 24584, torch.bfloat16), None),   # above 48 KB
    (_shard(1, 1001, 0, 1000, torch.bfloat16), (1, 4, 2048)),  # T 1
])
def test_ce_shard_fwd_plan_chooses_by_width_and_alignment(x, want):
    assert twce.shard_fwd_plan(x, SMS) == want


def _staged_lse(x: np.ndarray, values: int) -> np.ndarray:
    """The staged kernel's lse in float32: a max, then each of 256
    threads sums exp2((x - max) * log2 e) over its vectors (thread t:
    vectors t, t + 256, ...) value by value, each warp's sums by a
    butterfly, the 8 warps in order."""
    t, v = x.shape
    vec = x.reshape(t, v // values, values)
    big = x.max(axis=1)
    sums = np.zeros((t, 256), np.float32)
    for i0 in range(0, vec.shape[1], 256):
        blk = vec[:, i0:i0 + 256]
        for j in range(values):
            sums[:, :blk.shape[1]] += np.exp2(
                (blk[:, :, j] - big[:, None]) * np.float32(LOG2E))
    warps = sums.reshape(t, 8, 32)
    for off in (16, 8, 4, 2, 1):
        warps = warps + warps[:, :, np.arange(32) ^ off]
    total = warps[:, 0, 0]
    for w in range(1, 8):
        total = total + warps[:, w, 0]
    return big + np.log(total)


@pytest.mark.parametrize("dtype,v", [(torch.bfloat16, 9496),
                                     (torch.float32, 9496),
                                     (torch.bfloat16, 2048)])
def test_staged_two_pass_lse_equals_the_plain_shard_forward(dtype, v):
    """At qwen3-0.6b's shard width (1187 vectors of bf16: threads with 5
    and 4 vectors) and one of whole rounds; the gold logit read from the
    staged row."""
    t, v0 = 8, 3 * v
    rng = np.random.default_rng(v)
    x = torch.from_numpy(rng.standard_normal((t, v)) * 4).to(dtype)
    labels = torch.from_numpy(rng.integers(v0, v0 + v, t)).to(torch.int32)
    labels[:3] = torch.tensor([v0 - 1, v0 + v, v0 + v - 1])  # out, out, in
    lse, gold = twce.weighted_ce_shard_fwd_plain(x, labels, v0)
    xf = x.float().numpy()
    got = _staged_lse(xf, 16 // x.element_size())
    np.testing.assert_allclose(got, lse.numpy(), rtol=1e-6, atol=0)
    col = labels.numpy().astype(np.int64) - v0
    inside = (col >= 0) & (col < v)
    assert inside.any() and not inside.all()
    want_gold = np.where(inside, xf[np.arange(t), np.clip(col, 0, v - 1)],
                         0.0)
    np.testing.assert_array_equal(gold.numpy(), want_gold)


def test_decode_shard_passes_its_own_range_and_lse(fake_card):
    b, h, kv, s, d = 4, 16, 8, 2048, 128
    q = torch.zeros(b, h, d, dtype=torch.bfloat16)
    k = torch.zeros(b, s, kv, d, dtype=torch.bfloat16).transpose(1, 2)
    before = (tfd.flash_decode_shard.launches, tfd.flash_decode.launches)
    o, lse = tfd.flash_decode_shard(q, k, k, 5000, 4096)
    (name, args), = fake_card.calls
    assert name == "flash_decode_cluster" and o.dtype == torch.float32
    assert tfd.decode_plan(0, 904, b * h // 2, SMS, 32)[0] == name
    assert args[13:15] == (0, 5000 - 4096)          # lo, hi of this chunk
    assert args[15:17] == tfd.cluster_plan(0, 904, b * h // 2, SMS, 32)[::-1]
    assert args[-2] == lse.data_ptr() and args[5] == o.data_ptr()
    assert args[-1] == 7                            # the stream
    o, lse = tfd.flash_decode_shard(q, k, k, 5000, 6144)   # past pos
    assert len(fake_card.calls) == 1
    assert bool((o == 0).all()) and bool(torch.isneginf(lse).all())
    assert (tfd.flash_decode_shard.launches,
            tfd.flash_decode.launches) == (before[0] + 1, before[1])
    with pytest.raises(ValueError, match="s0"):
        tfd.flash_decode_shard(q, k, k, 5, -1)


def test_decode_shard_on_a_long_range_takes_the_split_kernel(fake_card):
    """Batch 1 and 8192 valid positions: the cluster plan's 8 blocks a row
    would take 1024 each, so the split kernel and its merge run."""
    b, h, kv, s, d = 1, 16, 8, 8192, 128
    q = torch.zeros(b, h, d, dtype=torch.bfloat16)
    k = torch.zeros(b, s, kv, d, dtype=torch.bfloat16).transpose(1, 2)
    before = (tfd.flash_decode_shard.launches, tfd.flash_decode.launches)
    o, lse = tfd.flash_decode_shard(q, k, k, 30000, 8192)
    (name, args), = fake_card.calls
    assert name == "flash_decode"
    assert tfd.decode_plan(0, s - 1, 8, SMS, 32) == (
        name, *tfd.split_plan(0, s - 1, 8, SMS, 32))
    assert args[15:19] == (0, s - 1, *tfd.split_plan(0, s - 1, 8, SMS, 32)
                           [::-1])
    assert args[-2] == lse.data_ptr() and args[5] == o.data_ptr()
    assert (tfd.flash_decode_shard.launches,
            tfd.flash_decode.launches) == (before[0] + 1, before[1])


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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_shard_kernels_equal_plain_on_card():
    """Each shard kernel and its other route on the card against its plain
    version at odd shapes.  Decode: pos inside a chunk, a window, GT 1 and
    8, the int8 cache (D 120), float32, a chunk past pos, batch 1, and a
    batch-1 range of 8100 (the split kernel); o within 2e-5 max|v| and lse
    within 1e-4 (float32 both ways; another summation order), -inf where
    the plain one is, two runs the same bits.  CE: the staged kernel in bf16
    and float32, T 1, V not a multiple of 8 and a misaligned v0 (the
    streaming kernel), labels outside the shard; lse rtol 1e-5, gold
    exact, two runs the same bits."""
    dev = _card()
    gen = torch.Generator().manual_seed(5)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype).to(dev)

    bf16, f32 = torch.bfloat16, torch.float32
    # B, H, KV, S, D, dtype, int8 cache, pos, s0, window, kernel counter
    for b, h, kv, s, d, dt, quant, pos, s0, window, route in [
            (4, 16, 16, 1000, 128, bf16, False, 3517, 3000, None, "cluster"),
            (4, 64, 8, 1000, 128, bf16, False, 3517, 3000, 300, "cluster"),
            (4, 16, 8, 1000, 120, bf16, True, 3999, 3000, None, "cluster"),
            (4, 16, 8, 777, 64, f32, False, 700, 0, 1000, "cluster"),
            (4, 16, 8, 500, 128, bf16, False, 2999, 3000, None, None),
            (1, 16, 8, 2048, 128, bf16, False, 9000, 2048, None, "cluster"),
            (1, 16, 8, 8192, 128, bf16, False, 9000, 0, 8100, "split")]:
        q = randn(b, h, d, dtype=dt)
        kw = {}
        if quant:
            k, v = (torch.randint(-127, 128, (b, s, kv, d), generator=gen,
                                  dtype=torch.int8).to(dev).transpose(1, 2)
                    for _ in range(2))
            kw = {name: (torch.rand(b, s, kv, generator=gen) * 0.05
                         + 1e-3).to(dev).transpose(1, 2)
                  for name in ("k_scale", "v_scale")}
        else:
            k, v = (randn(b, s, kv, d, dtype=dt).transpose(1, 2)
                    for _ in range(2))
        lo, hi = tfd.valid_range(pos, s, window, s0)
        if route is None:
            assert hi < lo
        else:
            assert tfd.decode_plan(lo, hi, b * h // tfd.heads_per_block(
                h // kv), tfd.sm_count(dev.index or 0), tfd.rows_per_pass(
                    k.dtype, d))[0] == {"cluster": "flash_decode_cluster",
                                        "split": "flash_decode"}[route]
        before = tfd.flash_decode_shard.launches
        o, lse = tfd.flash_decode_shard(q, k, v, pos, s0, window=window,
                                        **kw)
        again = tfd.flash_decode_shard(q, k, v, pos, s0, window=window, **kw)
        torch.cuda.synchronize()
        assert tfd.flash_decode_shard.launches - before == (
            0 if route is None else 2)
        po, plse = tfd.flash_decode_plain(q, k, v, pos, window=window,
                                          s0=s0, return_lse=True, **kw)
        vmax = float((v.float() * kw["v_scale"][..., None] if quant
                      else v.float()).abs().max())
        assert float((o - po).abs().max()) <= 2e-5 * vmax, (b, h, d, pos)
        fin = torch.isfinite(plse)
        assert torch.equal(torch.isfinite(lse), fin)
        if bool(fin.any()):
            assert float((lse[fin] - plse[fin]).abs().max()) <= 1e-4
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1])

    # T, whole vocab, shard columns [v0, v0 + V), dtype, kernel counter
    for t, total, v0, width, dt, route in [
            (300, 8000, 3000, 1000, bf16, "staged"),
            (300, 8000, 3000, 1000, f32, "staged"),
            (1, 8000, 0, 1000, bf16, "staged"),
            (300, 8000, 3000, 1001, bf16, "stream"),
            (300, 8000, 1, 1000, bf16, "stream")]:
        x = randn(t, total, dtype=dt) * 3
        labels = torch.randint(0, total, (t,), generator=gen,
                               dtype=torch.int32).to(dev)
        labels[0] = v0 + width - 1
        cols = x[:, v0:v0 + width]
        assert (twce.shard_fwd_plan(cols, tfd.sm_count(dev.index or 0))
                is None) == (route == "stream")
        before = twce.weighted_ce_shard_fwd.launches
        lse, gold = twce.weighted_ce_shard_fwd(cols, labels, v0)
        lse2, gold2 = twce.weighted_ce_shard_fwd(cols, labels, v0)
        torch.cuda.synchronize()
        assert twce.weighted_ce_shard_fwd.launches - before == 2
        plse, pgold = twce.weighted_ce_shard_fwd_plain(cols, labels, v0)
        torch.testing.assert_close(lse, plse, rtol=1e-5, atol=0)
        assert torch.equal(gold, pgold.float())
        assert bool((gold == 0).any()) or t == 1
        assert torch.equal(lse, lse2) and torch.equal(gold, gold2)
