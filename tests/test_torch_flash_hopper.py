"""What surrounds the Hopper designs of the port's flash kernels, on the CPU.

The CUDA kernels run only on a card (``chip_smoke.py`` phase 8 and the
``gpu`` test in ``tests/test_torch_flash.py`` hold them against their plain
versions there).  Here the parts a CPU can reach are held:

* flash decode's split plan (``split_plan``, ``valid_range``,
  ``heads_per_block``) and the cluster kernel's (``cluster_plan``: at most
  ``CLUSTER_LIMIT`` chunks a row, each a whole number of passes) cover
  every valid position once, with no empty chunk, at the serve shapes and
  at decode_32k's chunk of a tensor-parallel rank;
* the split-then-merge arithmetic the decode kernels run (per-chunk
  partial (m, l, acc) in the exp2 domain, merged in chunk order: the split
  kernel's merge launch, or the cluster's ranks in order) equals
  ``flash_decode_plain`` and the Pallas kernel in interpret mode on either
  plan, and an empty partial merges to weight 0;
* the bf16 attention kernel's numerics (P rounded to bf16 for the PV
  product, l summed from the float32 p, tiles of 64 x 64, live tiles only)
  stay within 2^-7 max|v| of ``flash_attention_plain`` at qwen3-0.6b's
  prefill shape and at head dims 120 and 256: the tolerance phase 8 holds
  the kernel to;
* the wrappers route on dtype, check the layouts the kernels read (TMA's
  16-byte rule, the decode kernel's vectors) and raise on the rest; their
  launch arguments are checked through a stand-in library.

Tolerances: float32 2e-5 max|v| (another summation order); bf16 2^-7
max|v| (one bf16 rounding of P, ~2^-9 relative, and one of the output).
"""
import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd

LOG2E = 1.4426950408889634
NEG_INF = -1e30
SERVE_SMS = 132  # an H100's SMs


# ------------------------------------------------------------ split plan
def _chunks(lo, hi, n_split, chunk):
    return [(lo + j * chunk, min(hi, lo + (j + 1) * chunk - 1))
            for j in range(n_split)]


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("pos,window", [(0, None), (5, None), (31, None),
                                        (511, None), (575, None),
                                        (575, 128), (575, 100), (300, 37),
                                        (40, 128)])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 120),
                                     (torch.bfloat16, 256),
                                     (torch.int8, 128),
                                     (torch.float32, 128)])
def test_split_plan_covers_each_valid_position_once(g, pos, window, dtype,
                                                    d):
    """pos 0, pos inside the first chunk, the last position, windows that
    cut a chunk; G = 1 (gemma), 2 (qwen3), 4 (danube)."""
    b, kv, s = 4, 8, 576
    lo, hi = tfd.valid_range(pos, s, window)
    want = [t for t in range(s) if t <= pos
            and (window is None or t > pos - window)]
    assert (lo, hi) == (want[0], want[-1])
    gt = tfd.heads_per_block(g)
    n_split, chunk = tfd.split_plan(lo, hi, b * kv * (g // gt), SERVE_SMS,
                                    tfd.rows_per_pass(dtype, d))
    chunks = _chunks(lo, hi, n_split, chunk)
    covered = [t for c_lo, c_hi in chunks for t in range(c_lo, c_hi + 1)]
    assert covered == want                      # each once, in order
    assert all(c_lo <= c_hi for c_lo, c_hi in chunks)   # none empty
    assert chunk % tfd.CHUNK_ALIGN == 0 and 1 <= n_split <= tfd.MAX_SPLIT
    assert chunk <= tfd.rows_per_pass(dtype, d) or n_split == tfd.MAX_SPLIT


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("pos,window", [(0, None), (5, None), (31, None),
                                        (511, None), (575, None),
                                        (575, 128), (575, 100), (300, 37),
                                        (40, 128)])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 120),
                                     (torch.bfloat16, 256),
                                     (torch.int8, 128),
                                     (torch.float32, 128)])
def test_cluster_plan_covers_each_valid_position_once(g, pos, window, dtype,
                                                      d):
    """The split plan's cases on the cluster kernel's plan: one cluster of
    at most CLUSTER_LIMIT blocks a row, each chunk whole passes."""
    b, kv, s = 4, 8, 576
    lo, hi = tfd.valid_range(pos, s, window)
    want = [t for t in range(s) if t <= pos
            and (window is None or t > pos - window)]
    gt = tfd.heads_per_block(g)
    pass_rows = tfd.rows_per_pass(dtype, d)
    n_split, chunk = tfd.cluster_plan(lo, hi, b * kv * (g // gt), SERVE_SMS,
                                      pass_rows)
    chunks = _chunks(lo, hi, n_split, chunk)
    covered = [t for c_lo, c_hi in chunks for t in range(c_lo, c_hi + 1)]
    assert covered == want                      # each once, in order
    assert all(c_lo <= c_hi for c_lo, c_hi in chunks)   # none empty
    assert 1 <= n_split <= tfd.CLUSTER_LIMIT and chunk % pass_rows == 0


@pytest.mark.parametrize("pos,s0,want", [
    (32767, 0, (8, 256)),        # a whole chunk: 8 blocks of 8 passes
    (20000, 18432, (8, 224)),    # 1569 positions: 7 passes, the last one
    (4096, 4096, (1, 32)),       # one position
])
def test_cluster_plan_at_decode_32ks_chunk(pos, s0, want):
    """decode_32k on a rank of 16 (B 8, H 16, KV 8, D 128 bf16, chunks of
    2048): 64 rows, so 8 blocks a row give ~4 blocks on each of 132 SMs,
    one cluster a row; the cluster route."""
    b, h, kv, d, n = 8, 16, 8, 128, 2048
    blocks = b * h // tfd.heads_per_block(h // kv)
    assert blocks == 64
    lo, hi = tfd.valid_range(pos, n, None, s0)
    plan = tfd.cluster_plan(lo, hi, blocks, SERVE_SMS,
                            tfd.rows_per_pass(torch.bfloat16, d))
    assert plan == want
    assert tfd.decode_plan(lo, hi, blocks, SERVE_SMS, 32) == (
        "flash_decode_cluster", *want)
    chunks = _chunks(lo, hi, *plan)
    assert [t for c_lo, c_hi in chunks for t in range(c_lo, c_hi + 1)] \
        == list(range(lo, hi + 1))
    with pytest.raises(ValueError):
        tfd.cluster_plan(5, 4, blocks, SERVE_SMS, 32)   # no valid position


@pytest.mark.parametrize("n,blocks,kernel", [
    (2048, 64, "flash_decode_cluster"),   # a rank's chunk of decode_32k
    (576, 32, "flash_decode_cluster"),    # qwen3-0.6b's serve step
    (4096, 8, "flash_decode_cluster"),    # batch 1: chunks of 512
    (8192, 8, "flash_decode"),            # batch 1: 64 blocks of 1024
    (32768, 8, "flash_decode"),           # batch 1: 64 blocks of 4096
    (8192, 16, "flash_decode_cluster"),   # batch 2: 128 blocks of 1024
    (32768, 64, "flash_decode_cluster")])  # decode_32k's whole cache
def test_decode_plan_picks_the_kernel_by_chunk_and_grid(n, blocks, kernel):
    """The cluster kernel where its plan gives a block at most
    CLUSTER_MAX_CHUNK positions or puts a block on half the SMs or more,
    else the split kernel on its own plan."""
    got = tfd.decode_plan(0, n - 1, blocks, SERVE_SMS, 32)
    plan = (tfd.cluster_plan if kernel == "flash_decode_cluster"
            else tfd.split_plan)(0, n - 1, blocks, SERVE_SMS, 32)
    assert got == (kernel, *plan)
    n_split, chunk = tfd.cluster_plan(0, n - 1, blocks, SERVE_SMS, 32)
    assert (chunk <= tfd.CLUSTER_MAX_CHUNK
            or 2 * blocks * n_split >= SERVE_SMS) \
        == (kernel == "flash_decode_cluster")


@pytest.mark.parametrize("n,blocks,sms", [(1, 1, 1), (576, 32, 132),
                                          (576, 1, 132), (10 ** 5, 1, 132),
                                          (4096, 8, 1000), (9, 3, 7)])
def test_split_plan_bounds(n, blocks, sms):
    """At most MAX_SPLIT chunks cover any range; every chunk is nonempty,
    and the chunk fits one pass unless the cap forces a longer one."""
    n_split, chunk = tfd.split_plan(0, n - 1, blocks, sms, 32)
    assert n_split <= tfd.MAX_SPLIT and n_split * chunk >= n
    assert (n_split - 1) * chunk < n
    assert chunk <= 32 or n_split == tfd.MAX_SPLIT


def test_split_plan_fills_the_card_at_the_serve_shape():
    """qwen3-0.6b's decode step (B 4, H 16, KV 8, cache 576, bf16): each
    KV head read once for its 2 query heads, 2 or more blocks a SM."""
    b, h, kv, d = 4, 16, 8, 128
    gt = tfd.heads_per_block(h // kv)
    assert gt == 2
    lo, hi = tfd.valid_range(575, 576, None)
    n_split, chunk = tfd.split_plan(lo, hi, b * h // gt, SERVE_SMS,
                                    tfd.rows_per_pass(torch.bfloat16, d))
    assert b * h // gt * n_split >= 2 * SERVE_SMS
    with pytest.raises(ValueError):
        tfd.split_plan(5, 4, 32, SERVE_SMS, 32)    # no valid position


@pytest.mark.parametrize("g,want", [(1, 1), (2, 2), (3, 1), (4, 4), (6, 2),
                                    (8, 8), (12, 4), (16, 8)])
def test_heads_per_block(g, want):
    assert tfd.heads_per_block(g) == want


# ------------------------------------------------ split-then-merge numerics
def _split_merge(q, k, v, pos, window, k_scale, v_scale, n_split, chunk,
                 extra_empty=False):
    """The decode kernel's arithmetic in float32: each
    chunk's partial (m, l, acc) in the exp2 domain (q scaled by
    log2(e) / sqrt(D)), merged in chunk order with weights 2^(m_j - M)."""
    k, v = k.float(), v.float()
    if k_scale is not None:
        k, v = k * k_scale[..., None], v * v_scale[..., None]
    b, h, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kv, h // kv, d) * (LOG2E / math.sqrt(d))
    lo, hi = tfd.valid_range(pos, s, window)
    parts = []
    for c_lo, c_hi in _chunks(lo, hi, n_split, chunk):
        sc = torch.einsum("bkgd,bktd->bkgt", qg, k[:, :, c_lo:c_hi + 1])
        m = sc.amax(-1)
        p = torch.exp2(sc - m[..., None])
        parts.append((m, p.sum(-1), torch.einsum(
            "bkgt,bktd->bkgd", p, v[:, :, c_lo:c_hi + 1])))
    if extra_empty:
        m0 = parts[0][0]
        parts.append((torch.full_like(m0, NEG_INF), torch.zeros_like(m0),
                      torch.zeros_like(parts[0][2])))
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(big)
    for m, l, acc in parts:                     # chunk order
        w = torch.exp2(m - big)
        num += acc * w[..., None]
        den += l * w
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


def _cache(seed, b, kv, s, d, quant):
    rng = np.random.default_rng(seed)
    if not quant:
        return (torch.from_numpy(rng.standard_normal((b, kv, s, d))
                                 .astype(np.float32)),
                torch.from_numpy(rng.standard_normal((b, kv, s, d))
                                 .astype(np.float32)), None, None)
    return tuple(torch.from_numpy(x) for x in (
        rng.integers(-127, 128, (b, kv, s, d)).astype(np.int8),
        rng.integers(-127, 128, (b, kv, s, d)).astype(np.int8),
        (rng.random((b, kv, s)) * 0.05 + 1e-3).astype(np.float32),
        (rng.random((b, kv, s)) * 0.05 + 1e-3).astype(np.float32)))


def _vmax(v, vs):
    return float((v.float() if vs is None
                  else v.float() * vs[..., None]).abs().max())


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("h,kv", [(4, 4), (8, 4), (16, 4)])
@pytest.mark.parametrize("pos,window", [(0, None), (5, None), (100, 16),
                                        (255, None), (255, 100)])
def test_split_merge_matches_plain_and_pallas(quant, h, kv, pos, window):
    """The kernel's plan and merge, fp and int8, G = 1, 2, 4, against
    ``flash_decode_plain`` and the Pallas kernel in interpret mode."""
    b, s, d = 2, 256, 64
    q = torch.from_numpy(np.random.default_rng(pos + h).standard_normal(
        (b, h, d)).astype(np.float32))
    k, v, ks, vs = _cache(h * 10 + kv, b, kv, s, d, quant)
    lo, hi = tfd.valid_range(pos, s, window)
    gt = tfd.heads_per_block(h // kv)
    n_split, chunk = tfd.split_plan(lo, hi, b * h // gt, SERVE_SMS,
                                    tfd.rows_per_pass(k.dtype, d))
    got = _split_merge(q, k, v, pos, window, ks, vs, n_split, chunk)
    kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    plain = tfd.flash_decode_plain(q, k, v, pos, window=window, **kw)
    jkw = {} if ks is None else dict(k_scale=jnp.asarray(ks.numpy()),
                                     v_scale=jnp.asarray(vs.numpy()))
    pallas = jops.flash_decode(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()),
                               jnp.asarray(pos, jnp.int32), window=window,
                               interpret=True, **jkw)
    bound = 2e-5 * _vmax(v, vs)
    assert float((got - plain).abs().max()) <= bound
    assert float((got - torch.from_numpy(np.array(pallas))).abs().max()) \
        <= bound


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("pos,window", [(255, None), (150, 100)])
def test_cluster_plan_merge_matches_plain_and_pallas(quant, pos, window):
    """The cluster kernel's plan and rank-order merge, fp and int8, G = 2,
    against ``flash_decode_plain`` and the Pallas kernel in interpret
    mode."""
    b, h, kv, s, d = 2, 8, 4, 256, 64
    q = torch.from_numpy(np.random.default_rng(pos).standard_normal(
        (b, h, d)).astype(np.float32))
    k, v, ks, vs = _cache(pos + 7, b, kv, s, d, quant)
    lo, hi = tfd.valid_range(pos, s, window)
    n_split, chunk = tfd.cluster_plan(lo, hi, b * h // 2, SERVE_SMS,
                                      tfd.rows_per_pass(k.dtype, d))
    assert n_split > 1
    got = _split_merge(q, k, v, pos, window, ks, vs, n_split, chunk)
    kw = {} if ks is None else dict(k_scale=ks, v_scale=vs)
    plain = tfd.flash_decode_plain(q, k, v, pos, window=window, **kw)
    jkw = {} if ks is None else dict(k_scale=jnp.asarray(ks.numpy()),
                                     v_scale=jnp.asarray(vs.numpy()))
    pallas = jops.flash_decode(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(v.numpy()),
                               jnp.asarray(pos, jnp.int32), window=window,
                               interpret=True, **jkw)
    bound = 2e-5 * _vmax(v, vs)
    assert float((got - plain).abs().max()) <= bound
    assert float((got - torch.from_numpy(np.array(pallas))).abs().max()) \
        <= bound


def test_cluster_plan_merge_at_decode_32ks_chunk():
    """A 2048-position chunk in 8 chunks of 256 (the cluster plan at
    decode_32k's geometry) merges to the plain version, narrow heads."""
    b, h, kv, s, d = 1, 2, 1, 2048, 16
    q = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (b, h, d)).astype(np.float32))
    k, v, _, _ = _cache(12, b, kv, s, d, False)
    got = _split_merge(q, k, v, s - 1, None, None, None,
                       *tfd.cluster_plan(0, s - 1, 64, SERVE_SMS, 32))
    plain = tfd.flash_decode_plain(q, k, v, s - 1)
    assert float((got - plain).abs().max()) <= 2e-5 * _vmax(v, None)


@pytest.mark.parametrize("quant", [False, True])
def test_an_empty_partial_merges_to_weight_zero(quant):
    """A chunk with no position (m = -1e30, l = 0, acc = 0) changes nothing;
    nor does a plan of a single chunk."""
    b, h, kv, s, d = 2, 8, 4, 576, 128
    q = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, h, d)).astype(np.float32))
    k, v, ks, vs = _cache(4, b, kv, s, d, quant)
    lo, hi = tfd.valid_range(575, s, None)
    n_split, chunk = tfd.split_plan(lo, hi, b * h // 2, SERVE_SMS,
                                    tfd.rows_per_pass(k.dtype, d))
    with_empty = _split_merge(q, k, v, 575, None, ks, vs, n_split, chunk,
                              extra_empty=True)
    without = _split_merge(q, k, v, 575, None, ks, vs, n_split, chunk)
    one = _split_merge(q, k, v, 575, None, ks, vs, 1, s)
    assert torch.equal(with_empty, without)
    assert float((without - one).abs().max()) <= 2e-5 * _vmax(v, vs)


# ---------------------------------------------------- bf16-P attention
def _bf16_p_attention(q, k, v, causal=True, window=None):
    """The tensor-core kernel's arithmetic: 64-query tiles over their live
    64-key tiles, scores in float32 in the exp2 domain, masked to -1e30,
    P = 2^(s - m) summed into l in float32 and rounded to bf16 for the PV
    product (float32 accumulation), out = acc / max(l, 1e-30) in bf16."""
    b, h, s, d = q.shape
    kv, t = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, kv, h // kv, s, d)
    kf, vf = k.float(), v.float()
    scale = LOG2E / math.sqrt(d)
    out = torch.empty(b, kv, h // kv, s, d)
    offset = t - s
    for q0 in range(0, s, 64):
        rows = torch.arange(q0, min(s, q0 + 64)) + offset
        k_begin = 0 if window is None else max(0, int(rows[0]) - window + 1)
        k_end = min(t, int(rows[-1]) + 1) if causal else t
        m = torch.full((b, kv, h // kv, len(rows)), NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, kv, h // kv, len(rows), d)
        for k0 in range(k_begin // 64 * 64, k_end, 64):
            cols = torch.arange(k0, min(t, k0 + 64))
            sc = torch.einsum("bkgsd,bktd->bkgst", qf[:, :, :, q0:q0 + 64],
                              kf[:, :, k0:k0 + 64]) * scale
            ok = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                ok &= cols[None] <= rows[:, None]
            if window is not None:
                ok &= cols[None] > rows[:, None] - window
            sc = torch.where(ok, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(sc - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,bktd->bkgsd", p.to(torch.bfloat16).float(),
                vf[:, :, k0:k0 + 64])
            m = m_new
        out[:, :, :, q0:q0 + 64] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, s, d).to(torch.bfloat16)


@pytest.mark.parametrize("b,h,kv,s,t,d,window", [
    (4, 16, 8, 512, 512, 128, None),     # qwen3-0.6b's prefill
    (1, 32, 8, 512, 512, 120, 128),      # h2o-danube-3-4b, window biting
    (1, 16, 16, 500, 512, 256, None),    # gemma-7b, ragged, S < T
])
def test_bf16_p_numerics_within_phase_8_tolerance(b, h, kv, s, t, d, window):
    """P in bf16 for the PV product keeps the kernel within 2^-7 max|v| of
    the float32 plain version (both outputs rounded to bf16 once)."""
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16)
        for shape in ((b, h, s, d), (b, kv, t, d), (b, kv, t, d)))
    got = _bf16_p_attention(q, k, v, window=window)
    want = tfa.flash_attention_plain(q, k, v, window=window)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2 ** -7 * float(v.float().abs().max()), err
    assert err > 0          # the rounding of P is visible, not a no-op


# ------------------------------------------------------------ wrappers
def test_kernel_for_routes_on_dtype():
    assert tfa.kernel_for(torch.bfloat16) == "flash_attention_bf16"
    assert tfa.kernel_for(torch.float32) == "flash_attention_f32"
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError):
            tfa.kernel_for(dtype)


def _model_view(b, s, h, d, dtype=torch.bfloat16, pad=0):
    """[B, S, H, D + pad] memory seen as [B, H, S, D] (pad: extra columns
    per row, which move the strides off the 16-byte grid)."""
    return torch.zeros(b, s, h, d + pad, dtype=dtype)[..., :d].transpose(1, 2)


def test_tma_layout_takes_the_models_views_and_raises_on_the_rest():
    tfa.check_tma_layout(("q", _model_view(2, 64, 16, 128)),
                         ("k", _model_view(2, 64, 8, 120)),
                         ("v", _model_view(1, 64, 16, 256)))
    with pytest.raises(ValueError, match="head dim 100"):
        tfa.check_tma_layout(("q", _model_view(1, 8, 2, 100)))
    with pytest.raises(ValueError, match="strides"):          # 132 * 2 B
        tfa.check_tma_layout(("k", _model_view(1, 8, 2, 128, pad=4)))
    flat = torch.zeros(1 + 2 * 8 * 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="base"):             # 2 B off
        tfa.check_tma_layout(("v", flat[1:].view(1, 2, 8, 128)))
    one = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16)
    tfa.check_tma_layout(("q", one.expand(1, 1, 1, 8)))  # size-1 axes free


@pytest.mark.parametrize("dtype,d,ok", [
    (torch.bfloat16, 128, True), (torch.bfloat16, 120, True),
    (torch.bfloat16, 100, False), (torch.int8, 120, True),
    (torch.int8, 100, False), (torch.float32, 6, False),
    (torch.float32, 64, True)])
def test_cache_layout_vectors(dtype, d, ok):
    """The decode kernel reads rows in 16-byte vectors (8 bytes for int8):
    D must be a multiple of the vector's values."""
    cache = torch.zeros(2, 40, 8, d, dtype=dtype).transpose(1, 2)
    if ok:
        tfd.check_cache_layout(("k", cache))
    else:
        with pytest.raises(ValueError, match="head dim"):
            tfd.check_cache_layout(("k", cache))


def test_cache_layout_raises_on_misaligned_strides():
    cache = torch.zeros(2, 40, 8, 132, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="strides"):
        tfd.check_cache_layout(("v", cache.transpose(1, 2)))
    assert tfd.vector_of(torch.int8) == (8, 8)
    assert tfd.vector_of(torch.bfloat16) == (16, 8)
    assert tfd.vector_of(torch.float32) == (16, 4)


class _FakeLib:
    """Records the C calls a wrapper makes and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card path on CPU tensors, down to a stand-in library:
    what they check, route and pass to the C entry points."""
    lib = _FakeLib()
    for mod in (tfa, tfd):
        monkeypatch.setattr(mod, "on_card", lambda x, what: True)
        monkeypatch.setattr(mod, "_lib", lambda: lib)
        monkeypatch.setattr(mod, "current",
                            lambda device: contextlib.nullcontext())
        monkeypatch.setattr(mod, "raw_stream", lambda device: 7)
    monkeypatch.setattr(tfd, "sm_count", lambda index: SERVE_SMS)
    return lib


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_launches_the_kernel_of_its_dtype(fake_card, dtype):
    q = _model_view(2, 40, 16, 120, dtype)
    k, v = _model_view(2, 48, 8, 120, dtype), _model_view(2, 48, 8, 120, dtype)
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v, window=16)
    (name, args), = fake_card.calls
    assert name == tfa.kernel_for(dtype)
    assert args[4:12] == (2, 16, 8, 40, 48, 120, 1, 16) and args[-1] == 7
    assert list(args[13]) == [*q.stride()[:3], *k.stride()[:3],
                              *v.stride()[:3], *out.stride()[:3]]
    assert out.shape == (2, 16, 40, 120) and out.dtype == dtype
    assert out.transpose(1, 2).is_contiguous()
    assert tfa.flash_attention.launches == before + 1


def test_flash_attention_raises_where_tma_cannot_read(fake_card):
    q = _model_view(1, 8, 4, 128, pad=4)
    k = _model_view(1, 8, 2, 128)
    with pytest.raises(ValueError, match="strides"):
        tfa.flash_attention(q, k, k)
    # the CUDA-core kernel takes any unit-stride layout
    q32 = _model_view(1, 8, 4, 100, torch.float32)
    k32 = _model_view(1, 8, 2, 100, torch.float32)
    tfa.flash_attention(q32, k32, k32)
    assert fake_card.calls[-1][0] == "flash_attention_f32"
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(*(x.to(torch.bfloat16) for x in (q32, k32, k32)))


@pytest.mark.parametrize("quant", [False, True])
def test_flash_decode_passes_its_plan(fake_card, quant):
    """One launch per call with ``decode_plan``'s kernel, plan and heads
    per block: the serve step's window on the cluster kernel (no scratch),
    a 32k cache at batch 1 on the split kernel with scratch for every
    partial."""
    b, h, kv, s, d = 4, 16, 8, 576, 128
    q = torch.zeros(b, h, d, dtype=torch.bfloat16)
    dt = torch.int8 if quant else torch.bfloat16
    k = torch.zeros(b, s, kv, d, dtype=dt).transpose(1, 2)
    kw = {}
    if quant:
        sc = torch.ones(b, s, kv).transpose(1, 2)
        kw = dict(k_scale=sc, v_scale=sc)
    before = tfd.flash_decode.launches
    tfd.flash_decode(q, k, k, 575, window=100, **kw)
    (name, args), = fake_card.calls
    assert tfd.flash_decode.launches == before + 1
    lo, hi = tfd.valid_range(575, s, 100)
    kernel, n_split, chunk = tfd.decode_plan(lo, hi, b * h // 2, SERVE_SMS,
                                             tfd.rows_per_pass(dt, d))
    assert name == kernel == "flash_decode_cluster"
    assert args[6:18] == (1, int(quant), b, h, kv, s, d, lo, hi, chunk,
                          n_split, 2)
    assert (args[3] is None) == (not quant) and args[-1] == 7
    assert args[-2] is None                                    # no lse

    s = 32768
    k = torch.zeros(1, s, kv, d, dtype=dt).transpose(1, 2)
    if quant:
        sc = torch.ones(1, s, kv).transpose(1, 2)
        kw = dict(k_scale=sc, v_scale=sc)
    tfd.flash_decode(q[:1], k, k, s - 1, **kw)
    name, args = fake_card.calls[-1]
    kernel, n_split, chunk = tfd.decode_plan(0, s - 1, h // 2, SERVE_SMS,
                                             tfd.rows_per_pass(dt, d))
    assert name == kernel == "flash_decode"
    assert args[8:20] == (1, int(quant), 1, h, kv, s, d, 0, s - 1, chunk,
                          n_split, 2)
    assert args[7] - args[6] == 4 * h * n_split * d  # acc, then (m, l)
    assert tfd.flash_decode.launches == before + 2


def test_flash_decode_raises_where_vectors_cannot_read(fake_card):
    q = torch.zeros(1, 4, 100, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 16, 100, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 100"):
        tfd.flash_decode(q, k, k, 3)
    assert fake_card.calls == []
