"""The port's flash-attention and flash-decode kernel modules against the
JAX package.

On the CPU the wrappers run their plain PyTorch versions (the CUDA kernels
build and run only on a card; ``chip_smoke.py`` and the ``gpu`` test below
hold them against the plain versions there).  Inputs are made with numpy
from a seed and handed to both packages.  The Pallas kernels run in
interpret mode, as ``tests/test_kernels.py`` runs them, at sizes where
their divisibility asserts hold (S, T <= 256, D = 64); the port's ragged
shapes are held against ``repro/kernels/ref.py`` instead.

Tolerance: float32 max |got - want| <= 2e-5 * max|v|.  The outputs are
convex combinations of v's rows, so max|v| bounds them; the two sides sum
the same products in other orders (an online recurrence over tiles
against one softmax), a few float32 ulps of the largest term.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops

TOL = 2e-5


def _close(got: torch.Tensor, want, v: np.ndarray) -> None:
    err = float(np.max(np.abs(got.numpy().astype(np.float64)
                              - np.asarray(want, np.float64))))
    bound = TOL * float(np.max(np.abs(v)))
    assert err <= bound, (err, bound)


def _qkv(seed, b, h, kv, s, t, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, t, d)).astype(np.float32)
    return q, k, v


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("s,t", [(256, 256), (128, 256)])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])
def test_flash_attention_matches_pallas_interpret(h, kv, window, s, t):
    """Causal GQA attention, S = T and right-aligned S < T, with and without
    a window, against the Pallas kernel in interpret mode."""
    q, k, v = _qkv(h * 100 + kv + s, 1, h, kv, s, t, 64)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    assert got.shape == (1, h, s, 64) and got.dtype == torch.float32
    _close(got, want, v)


def test_flash_attention_non_causal_matches_pallas_interpret():
    q, k, v = _qkv(7, 2, 4, 2, 128, 256, 64)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=False, interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    _close(got, want, v)


@pytest.mark.parametrize("s,t,d,window", [(100, 100, 64, None),
                                          (37, 130, 120, 16),
                                          (500, 500, 128, 128),
                                          (1, 77, 256, None)])
def test_flash_attention_plain_ragged_matches_ref(s, t, d, window):
    """Any S <= T and any D <= 256 (qwen3's 128, danube's 120, gemma's
    256), against the reference's jnp oracle."""
    q, k, v = _qkv(s + t + d, 2, 4, 2, s, t, d)
    want = jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    _close(got, want, v)


def test_flash_attention_takes_the_models_strided_views():
    """The model hands [B, S, H, D] activations over as permuted views; the
    result equals the contiguous call's (to the summation order)."""
    q, k, v = _qkv(3, 2, 4, 2, 32, 32, 64)
    qs, ks, vs = (_t(x).transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    assert not qs.is_contiguous()
    got = ops.flash_attention(qs, ks, vs, window=8)
    want = ops.flash_attention(_t(q), _t(k), _t(v), window=8)
    _close(got, want.numpy(), v)


def test_flash_attention_bf16_rounds_to_the_input_dtype():
    q, k, v = _qkv(11, 1, 4, 2, 64, 64, 64)
    got = ops.flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    want = jref.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                  for x in (q, k, v)))
    # both compute in float32 from the same bf16 inputs and round once
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=2 ** -7 * float(np.max(np.abs(v))))


# --------------------------------------------------------------- decode
def _cache(seed, b, kv, s, d, quant):
    rng = np.random.default_rng(seed)
    if not quant:
        return (rng.standard_normal((b, kv, s, d)).astype(np.float32),
                rng.standard_normal((b, kv, s, d)).astype(np.float32),
                None, None)
    return (rng.integers(-127, 128, (b, kv, s, d)).astype(np.int8),
            rng.integers(-127, 128, (b, kv, s, d)).astype(np.int8),
            (rng.random((b, kv, s)) * 0.05 + 1e-3).astype(np.float32),
            (rng.random((b, kv, s)) * 0.05 + 1e-3).astype(np.float32))


def _dequant_v(v, vs):
    return v if vs is None else v.astype(np.float32) * vs[..., None]


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 1)])
def test_flash_decode_matches_pallas_interpret(h, kv, quant, window):
    """fp and int8 caches, with and without a window, at several pos."""
    b, s, d = 2, 256, 64
    q = np.random.default_rng(h + kv).standard_normal((b, h, d)).astype(
        np.float32)
    k, v, ks, vs = _cache(h * 10 + kv, b, kv, s, d, quant)
    jkw = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    tkw = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    for pos in (0, 5, 100, 255):
        want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos, jnp.int32),
                                 window=window, interpret=True, **jkw)
        got = ops.flash_decode(_t(q), _t(k), _t(v), pos, window=window,
                               **tkw)
        assert got.shape == (b, h, d) and got.dtype == torch.float32
        _close(got, want, _dequant_v(v, vs))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 128])
def test_flash_decode_plain_any_cache_length_matches_ref(quant, window):
    """The serve path's cache of 512 + 64 = 576 positions (not a multiple
    of the Pallas kernel's 256) at the first, a middle and the last
    position, against the reference's jnp oracle."""
    b, h, kv, s, d = 2, 4, 2, 576, 128
    q = np.random.default_rng(5).standard_normal((b, h, d)).astype(
        np.float32)
    k, v, ks, vs = _cache(9, b, kv, s, d, quant)
    jkw = {} if ks is None else dict(k_scale=jnp.asarray(ks),
                                     v_scale=jnp.asarray(vs))
    tkw = {} if ks is None else dict(k_scale=_t(ks), v_scale=_t(vs))
    for pos in (0, 511, 575):
        want = jref.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), pos, window=window, **jkw)
        got = ops.flash_decode(_t(q), _t(k), _t(v), pos, window=window,
                               **tkw)
        _close(got, want, _dequant_v(v, vs))


def test_flash_decode_takes_the_models_strided_cache():
    """The model's [B, S, KV, D] cache and [B, S, KV] scales, permuted to
    [B, KV, S, D] / [B, KV, S] views, give the contiguous call's result
    (to the summation order)."""
    b, h, kv, s, d = 2, 4, 2, 40, 64
    q = _t(np.random.default_rng(1).standard_normal((b, h, d)).astype(
        np.float32))
    k, v, ks, vs = (_t(x) for x in _cache(2, b, kv, s, d, True))

    def strided(x):
        return x.transpose(1, 2).contiguous().transpose(1, 2)

    got = ops.flash_decode(q, strided(k), strided(v), 30,
                           k_scale=strided(ks), v_scale=strided(vs))
    want = ops.flash_decode(q, k, v, 30, k_scale=ks, v_scale=vs)
    _close(got, want.numpy(), (v.float() * vs[..., None]).numpy())


# ------------------------------------------------------------ wrappers
def test_wrappers_validate_inputs():
    q, k, v = (_t(x) for x in _qkv(0, 1, 4, 2, 16, 16, 64))
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):                     # S > T
        ops.flash_attention(q, k[:, :, :8], v[:, :, :8])
    with pytest.raises(ValueError):                     # H % KV
        ops.flash_attention(q[:, :3], k, v)
    big = torch.zeros(1, 2, 4, 264)
    with pytest.raises(ValueError):                     # D > 256
        ops.flash_attention(big, big, big)
    qd = q[:, :, 0]
    with pytest.raises(ValueError):                     # pos outside [0, S)
        ops.flash_decode(qd, k, v, 16)
    with pytest.raises(TypeError):                      # int8 without scales
        ops.flash_decode(qd, k.to(torch.int8), v.to(torch.int8), 3)
    with pytest.raises(ValueError):                     # one scale only
        ops.flash_decode(qd, k.to(torch.int8), v.to(torch.int8), 3,
                         k_scale=torch.ones(1, 2, 16))


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a card gets no plain
    version: the wrapper raises (on a card it launches the kernel)."""
    q = torch.zeros(1, 4, 16, 64, device="meta")
    k = torch.zeros(1, 2, 16, 64, device="meta")
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="no flash_decode kernel"):
        tfd.flash_decode(q[:, :, 0], k, k, 3)


@pytest.mark.gpu
def test_flash_kernels_match_plain_on_card():
    """The CUDA kernels against their plain versions on the card at the
    dense models' shapes (skips without one): qwen3-0.6b (H 16, KV 8, D
    128), h2o-danube-3-4b (H 32, KV 8, D 120, a window of 128 that bites at
    S 512) and gemma-7b (H = KV = 16, D 256), and one non-causal case;
    f32 within 2e-5 max|v|, bf16 within 2^-7 max|v|; two runs give the
    same bits; the launch counters count one per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = ((4, 16, 8, 128, None), (2, 32, 8, 120, 128),
              (2, 16, 16, 256, None))
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 2 ** -7)):
        for b, h, kv, d, win in shapes:
            cases = ((512, 512, win, True), (500, 500, win, True),
                     (512, 512, 128, True), (37, 130, 16, True),
                     (200, 300, None, False))
            for s, t, window, causal in cases:
                # the model's layout: [B, S, H, D] seen as [B, H, S, D]
                q = torch.randn(b, s, h, d, generator=gen, device=dev)
                k = torch.randn(b, t, kv, d, generator=gen, device=dev)
                v = torch.randn(b, t, kv, d, generator=gen, device=dev)
                q, k, v = (x.to(dtype).transpose(1, 2) for x in (q, k, v))
                before = tfa.flash_attention.launches
                got, again = (tfa.flash_attention(q, k, v, causal=causal,
                                                  window=window)
                              for _ in range(2))
                want = tfa.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window)
                torch.cuda.synchronize()
                assert tfa.flash_attention.launches == before + 2
                assert torch.equal(got, again), (d, s, t)
                err = float((got.float() - want.float()).abs().max())
                assert err <= tol * float(v.float().abs().max()), \
                    (d, s, t, err)
            for quant in (False, True):
                q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
                if quant:
                    k = torch.randint(-127, 128, (b, 576, kv, d),
                                      generator=gen, device=dev,
                                      dtype=torch.int8)
                    v = torch.randint(-127, 128, (b, 576, kv, d),
                                      generator=gen, device=dev,
                                      dtype=torch.int8)
                    kw = dict(k_scale=torch.rand(b, 576, kv, generator=gen,
                                                 device=dev) * 0.05,
                              v_scale=torch.rand(b, 576, kv, generator=gen,
                                                 device=dev) * 0.05)
                    vmax = float((v.float() * kw["v_scale"][..., None])
                                 .abs().max())
                    kw = {n: x.transpose(1, 2) for n, x in kw.items()}
                else:
                    k = torch.randn(b, 576, kv, d, generator=gen,
                                    device=dev).to(dtype)
                    v = torch.randn(b, 576, kv, d, generator=gen,
                                    device=dev).to(dtype)
                    kw, vmax = {}, float(v.float().abs().max())
                k, v = k.transpose(1, 2), v.transpose(1, 2)
                for pos in (0, 511, 575):
                    for window in (None, 128):
                        before = tfd.flash_decode.launches
                        got = tfd.flash_decode(q, k, v, pos, window=window,
                                               **kw)
                        again = tfd.flash_decode(q, k, v, pos, window=window,
                                                 **kw)
                        want = tfd.flash_decode_plain(q, k, v, pos,
                                                      window=window, **kw)
                        torch.cuda.synchronize()
                        assert tfd.flash_decode.launches == before + 2
                        assert torch.equal(got, again), (d, quant, pos)
                        err = float((got.float() - want.float()).abs().max())
                        assert err <= tol * vmax, (d, quant, pos, window,
                                                   err)
