"""The port's model zoo serve path (``repro_torch.models``, the dense GQA
archs) against the JAX package's.

The main config is qwen3-0.6b reduced with 2 KV heads (``reduced()`` alone
gives 4 query heads and 4 KV heads, which would leave the GQA grouping
untested).  The reference's ``init_params`` output goes through
``model_params_from_numpy``, so both packages run the same weights on the
same tokens (numpy, from a seed).  The port runs once with
``use_flash=False`` (the reference's einsum attention) and once with
``use_flash=True`` (the flash kernels' plain versions here on the CPU;
``chip_smoke.py`` and the ``gpu`` test run the CUDA kernels); the
reference runs its default path in both cases.

Tolerance: float32 logits and caches within atol 1e-4 and rtol 1e-4
(the two packages' matmuls and softmaxes sum in other orders: about 1e-6
here); greedy tokens and int8 cache values exactly.  An int8 cache value
sits on a rounding boundary now and then, where a float32 ulp in K decides
it (ROADMAP Queue 3), so the int8 decode starts both packages from the
reference's quantized cache, and ``quantize_cache`` is held on one input.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import api as japi
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn

ARCH = "qwen3-0.6b"
B, S, GEN = 2, 24, 8
TOL = dict(atol=1e-4, rtol=1e-4)


def _jcfg(arch=ARCH, **kw):
    cfg = JARCHS[arch].reduced()
    if arch == ARCH:
        cfg = cfg.with_overrides(num_kv_heads=2)
    return cfg.with_overrides(**kw)


def _tcfg(arch=ARCH, **kw):
    cfg = TARCHS[arch].reduced()
    if arch == ARCH:
        cfg = cfg.with_overrides(num_kv_heads=2)
    return cfg.with_overrides(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tcache(jcache):
    """A reference cache tree as the port's (the same NamedTuple fields)."""
    leaf = jcache["sub0"]
    kind = (tattn.QuantKVCache if len(leaf) == 4 else tattn.KVCache)
    return {"sub0": kind(*(torch.from_numpy(np.array(a)) for a in leaf))}


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


class Ref:
    """One reference run: params, prefill, padded cache and 8 greedy
    decode steps (jit, as the JAX serve CLI runs them)."""

    def __init__(self, arch=ARCH, **kw):
        self.cfg = _jcfg(arch, **kw)
        self.params = japi.init_params(jax.random.key(0), self.cfg)
        self.tokens = np.random.default_rng(0).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)
        self.logits, self.caches, _ = japi.forward(
            self.params, {"tokens": jnp.asarray(self.tokens)}, self.cfg)
        self.padded = japi.pad_prefill_cache(self.caches, self.cfg, S + GEN)
        self.step = jax.jit(japi.make_serve_step(self.cfg))

    def decode(self, caches, steps=GEN):
        tok = jnp.argmax(self.logits[:, -1], -1).astype(jnp.int32)[:, None]
        out = []
        for i in range(steps):
            tok, logits, caches = self.step(self.params, caches, tok,
                                            jnp.asarray(S + i, jnp.int32))
            out.append((np.asarray(logits), np.asarray(tok)))
        return out, caches


@pytest.fixture(scope="module")
def ref():
    return Ref()


def _port(ref, use_flash):
    cfg = _tcfg(use_flash=use_flash)
    params = model_params_from_numpy(cfg, _np(ref.params), device="cpu")
    return cfg, params


def _port_decode(cfg, params, caches, first_logits, steps=GEN):
    step = tapi.make_serve_step(cfg)
    tok = torch.argmax(first_logits[:, -1], -1).to(torch.int32)[:, None]
    out = []
    for i in range(steps):
        tok, logits, caches = step(params, caches, tok, S + i)
        out.append((logits, tok))
    return out, caches


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_configs_match_reference(arch):
    """The port's copies of the ten configs, full and reduced."""
    assert sorted(TARCHS) == sorted(JARCHS)
    assert (dataclasses.asdict(TARCHS[arch])
            == dataclasses.asdict(JARCHS[arch]))
    assert (dataclasses.asdict(TARCHS[arch].reduced())
            == dataclasses.asdict(JARCHS[arch].reduced()))


def test_param_tree_and_count_match_reference(ref):
    cfg = _tcfg()
    params = model_params_from_numpy(cfg, _np(ref.params), device="cpu")
    assert tapi.count_params(params) == japi.count_params(ref.params)
    # full width on the meta device: no memory drawn
    full = tapi.init_params(TARCHS[ARCH])
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: japi.init_params(jax.random.key(0),
                                                JARCHS[ARCH]))))
    assert tapi.count_params(full) == want == 596_049_920
    bad = _np(ref.params)
    bad["final_norm"] = {"scale": np.ones(7, np.float32)}
    with pytest.raises(ValueError, match="final_norm/scale"):
        model_params_from_numpy(cfg, bad, device="cpu")


def test_rope_and_rmsnorm_match_reference():
    """The layers on their own: RoPE (halves, float64 frequencies) and
    RMSNorm (float32 inside, cast back) against the reference's.  The
    reference's float32 frequencies may sit an ulp from the port's rounded
    float64 ones, and the angle is pos * freq: at positions below 140 the
    angles differ by up to 140 * 2^-23 rad, times max|x| (4.5) in the
    output, so RoPE is held to atol 1e-4."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 4, 128)).astype(np.float32)
    pos = np.tile(np.arange(100, 140, dtype=np.int32), (2, 1))
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(got, want, atol=1e-4, rtol=1e-5)
    scale = rng.standard_normal(128).astype(np.float32)
    for dtype in (jnp.float32, jnp.bfloat16):
        jx = jnp.asarray(x, dtype)
        want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)
        got = tl.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(np.array(jx, np.float32)).to(
                             torch.float32 if dtype == jnp.float32
                             else torch.bfloat16), 1e-6)
        # float32 to a few ulps; bf16 within one rounding (2^-8 relative)
        _close(got.float(), np.asarray(want, np.float32), atol=1e-5,
               rtol=1e-5 if dtype == jnp.float32 else 2 ** -8)


# ------------------------------------------------------ prefill, decode
@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_matches_reference(ref, use_flash):
    cfg, params = _port(ref, use_flash)
    logits, caches, aux = tapi.forward(
        params, {"tokens": torch.from_numpy(ref.tokens)}, cfg)
    _close(logits, ref.logits)
    for got, want in zip(caches["sub0"], ref.caches["sub0"]):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    assert float(aux) == 0.0
    last, _ = tapi.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(ref.tokens)})
    _close(last, ref.logits[:, -1:])


@pytest.mark.parametrize("use_flash", [False, True])
def test_greedy_decode_matches_reference(ref, use_flash):
    cfg, params = _port(ref, use_flash)
    logits, caches, _ = tapi.forward(
        params, {"tokens": torch.from_numpy(ref.tokens)}, cfg)
    caches = tapi.pad_prefill_cache(caches, cfg, S + GEN)
    got, caches = _port_decode(cfg, params, caches, logits)
    want, jcaches = ref.decode(ref.padded)
    for i, ((gl, gt), (wl, wt)) in enumerate(zip(got, want)):
        _close(gl, wl)
        assert np.array_equal(gt.numpy(), wt), f"step {i}: tokens differ"
    for g, w in zip(caches["sub0"], jcaches["sub0"]):
        _close(g, w)


def test_pad_prefill_cache_matches_reference(ref):
    cfg = _tcfg()
    got = tapi.pad_prefill_cache(_tcache(ref.caches), cfg, S + GEN)
    for g, w in zip(got["sub0"], ref.padded["sub0"]):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    same = tapi.pad_prefill_cache(got, cfg, S)        # never shrinks
    assert same["sub0"].k is got["sub0"].k


def test_quantize_cache_matches_reference(ref):
    """On one input: int8 values and scales exactly those of the
    reference's compiled quantize_kv (scale = absmax * float32(1/127))."""
    cfg = _tcfg()
    want = jax.jit(lambda c: japi.quantize_cache(c, ref.cfg))(ref.padded)
    got = tapi.quantize_cache(_tcache(ref.padded), cfg)
    assert isinstance(got["sub0"], tattn.QuantKVCache)
    for g, w in zip(got["sub0"], want["sub0"]):
        assert g.dtype == (torch.int8 if w.dtype == jnp.int8
                           else torch.float32)
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the port's own int8 cache round-trips within half a step
    c = got["sub0"]
    deq = tattn.dequantize_kv(c.k, c.k_scale, torch.float32)
    step = c.k_scale[..., None]
    assert bool(((deq - _tcache(ref.padded)["sub0"].k).abs()
                 <= 0.5 * step + 1e-6).all())


@pytest.mark.parametrize("use_flash", [False, True])
def test_kv_quant_decode_matches_reference(ref, use_flash):
    """8 greedy steps on the int8 cache, both packages starting from the
    reference's quantized prefill cache; with use_flash the port's decode
    dequantizes inside flash_decode."""
    cfg, params = _port(ref, use_flash)
    jq = jax.jit(lambda c: japi.quantize_cache(c, ref.cfg))(ref.padded)
    got, caches = _port_decode(cfg, params, _tcache(jq),
                               torch.from_numpy(np.array(ref.logits)))
    want, jcaches = ref.decode(jq)
    for i, ((gl, gt), (wl, wt)) in enumerate(zip(got, want)):
        _close(gl, wl)
        assert np.array_equal(gt.numpy(), wt), f"step {i}: tokens differ"
    for g, w in zip(caches["sub0"], jcaches["sub0"]):
        if g.dtype == torch.int8:
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)


def test_use_flash_routes_through_the_kernels(ref, monkeypatch):
    """With use_flash every layer's prefill calls ops.flash_attention and
    every layer's decode step ops.flash_decode (with the int8 cache and its
    scales under kv_quant); without it neither is called."""
    calls = {"attention": 0, "decode": 0, "scaled": 0}
    real_fa, real_fd = tops.flash_attention, tops.flash_decode

    def fa(*a, **kw):
        calls["attention"] += 1
        return real_fa(*a, **kw)

    def fd(*a, **kw):
        calls["decode"] += 1
        calls["scaled"] += kw.get("k_scale") is not None
        return real_fd(*a, **kw)

    monkeypatch.setattr(tops, "flash_attention", fa)
    monkeypatch.setattr(tops, "flash_decode", fd)
    for use_flash in (False, True):
        cfg, params = _port(ref, use_flash)
        logits, caches, _ = tapi.forward(
            params, {"tokens": torch.from_numpy(ref.tokens)}, cfg)
        caches = tapi.pad_prefill_cache(caches, cfg, S + GEN)
        _port_decode(cfg, params, caches, logits, steps=3)
        _port_decode(cfg, params, tapi.quantize_cache(caches, cfg), logits,
                     steps=2)
    n = _tcfg().num_layers
    assert calls == {"attention": n, "decode": 5 * n, "scaled": 2 * n}


@pytest.mark.parametrize("arch", ["gemma-7b", "h2o-danube-3-4b"])
def test_other_dense_archs_match_reference(arch):
    """gemma's GeGLU, embedding scale and head_dim, and danube's sliding
    window (overridden to 8 so that it masks), through both attention
    paths."""
    kw = {"window": 8} if arch == "h2o-danube-3-4b" else {}
    r = Ref(arch, **kw)
    want, _ = r.decode(r.padded, steps=4)
    for use_flash in (False, True):
        cfg = _tcfg(arch, use_flash=use_flash, **kw)
        params = model_params_from_numpy(cfg, _np(r.params), device="cpu")
        logits, caches, _ = tapi.forward(
            params, {"tokens": torch.from_numpy(r.tokens)}, cfg)
        _close(logits, r.logits)
        caches = tapi.pad_prefill_cache(caches, cfg, S + GEN)
        got, _ = _port_decode(cfg, params, caches, logits, steps=4)
        for (gl, gt), (wl, wt) in zip(got, want):
            _close(gl, wl)
            assert np.array_equal(gt.numpy(), wt)


def test_ring_cache_matches_full_for_swa():
    """``tests/test_serve.py::test_ring_cache_matches_full_for_swa`` in the
    port: with window W = 8, decoding through a ring buffer of length W
    equals decoding with the full cache (same tolerance as there), and each
    equals the reference's (use_flash=False: ring mode runs _sdpa)."""
    W, n_dec = 8, 6
    r = Ref("h2o-danube-3-4b", window=W)
    cfg = _tcfg("h2o-danube-3-4b", window=W)
    params = model_params_from_numpy(cfg, _np(r.params), device="cpu")
    start = S - n_dec
    tokens = torch.from_numpy(r.tokens)
    _, caches, _ = tapi.forward(params, {"tokens": tokens[:, :start]}, cfg)
    full = tapi.pad_prefill_cache(caches, cfg, S + 4)

    def ring_leaf(a):
        out = torch.zeros((a.shape[0], a.shape[1], W) + a.shape[3:],
                          dtype=a.dtype)
        out[:, :, torch.arange(start - W, start) % W] = a[:, :, start - W:
                                                          start]
        return out

    ring = {"sub0": tattn.KVCache(*(ring_leaf(a) for a in caches["sub0"]))}
    _, jcaches, _ = japi.forward(r.params,
                                 {"tokens": jnp.asarray(r.tokens[:, :start])},
                                 r.cfg)
    jring = {"sub0": type(jcaches["sub0"])(*(
        jnp.asarray(ring_leaf(torch.from_numpy(np.array(a))).numpy())
        for a in jcaches["sub0"]))}
    tok = tokens[:, start:start + 1]
    tok_r, jtok = tok, jnp.asarray(tok.numpy())
    for i in range(n_dec):
        logits_f, full = tapi.decode_step(params, full, tok, start + i, cfg,
                                          "full")
        logits_r, ring = tapi.decode_step(params, ring, tok_r, start + i,
                                          cfg, "ring")
        jlog, jring = japi.decode_step(r.params, jring, jtok,
                                       jnp.asarray(start + i, jnp.int32),
                                       r.cfg, "ring")
        a, b = logits_f[:, -1].numpy(), logits_r[:, -1].numpy()
        err = np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)
        assert err < 5e-3, (i, err)
        _close(logits_r, jlog)
        tok = torch.argmax(logits_f[:, -1:], -1).to(torch.int32)
        tok_r = torch.argmax(logits_r[:, -1:], -1).to(torch.int32)
        jtok = jnp.argmax(jlog[:, -1:], -1).astype(jnp.int32)
        assert np.array_equal(tok_r.numpy(), np.asarray(jtok))


# -------------------------------------------------------- what raises
def test_use_flash_never_drops_to_sdpa(ref):
    """The kernels have no ring validity and no softcap: use_flash with
    either raises instead of computing _sdpa."""
    cfg, params = _port(ref, True)
    caches = tapi.init_cache(cfg, B, 8, device="cpu")
    tok = torch.zeros(B, 1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ring"):
        tapi.decode_step(params, caches, tok, 0, cfg, "ring")
    capped = cfg.with_overrides(logit_softcap=30.0)
    with pytest.raises(NotImplementedError, match="softcap"):
        tapi.forward(params, {"tokens": tok}, capped)
    with pytest.raises(NotImplementedError, match="softcap"):
        tapi.decode_step(params, caches, tok, 0, capped)


def test_init_cache_layout():
    cfg = _tcfg()
    c = tapi.init_cache(cfg, B, 40, device="cpu")["sub0"]
    assert isinstance(c, tattn.KVCache)
    assert tuple(c.k.shape) == (cfg.num_layers, B, 40, 2, cfg.head_dim)
    q = tapi.init_cache(cfg.with_overrides(kv_quant=True), B, 40,
                        device="cpu")["sub0"]
    assert isinstance(q, tattn.QuantKVCache) and q.k.dtype == torch.int8
    assert tuple(q.k_scale.shape) == (cfg.num_layers, B, 40, 2)
    assert tapi.cache_length(cfg.with_overrides(window=16), 64) == 16
    assert tapi.cache_length(cfg, 64) == 64


# ---------------------------------------------------------------- CLI
@pytest.mark.parametrize("extra", [[], ["--use_flash", "--kv_quant"]])
def test_serve_cli_on_cpu(extra, capsys):
    tserve.main(["--device", "cpu", "--batch", "2", "--prompt_len", "12",
                 "--gen", "5", *extra])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill 12 tokens in ")
    assert "(cache len 17, mode full)" in lines[0]
    assert lines[1].startswith("decoded 4 steps x batch 2 in ")
    sample = json.loads(lines[2].removeprefix("sample: "))
    assert len(sample) == 5 and all(0 <= t < 512 for t in sample)


def test_serve_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--batch", "1", "--gen", "2"])


# ------------------------------------------------------------- on card
@pytest.mark.gpu
def test_rope_frequencies_are_the_same_bits_on_card_and_cpu():
    """Computed in float64 on each device and rounded to float32 (skips
    without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models.layers import rope_frequencies
    for cfg in TARCHS.values():
        if cfg.head_dim:
            got = rope_frequencies(cfg.head_dim, cfg.rope_theta, "cuda")
            want = rope_frequencies(cfg.head_dim, cfg.rope_theta, "cpu")
            assert torch.equal(got.cpu(), want), cfg.name


@pytest.mark.gpu
def test_qwen3_full_width_tracks_reference_on_card():
    """qwen3-0.6b at full width (d 1024, 16/8 heads, head_dim 128, d_ff
    3072, vocab 151936) cut to 2 layers, float32, B 2, S 256: the port on
    the card with use_flash (the CUDA kernels) against the reference (JAX,
    on the host), prefill and 8 teacher-forced decode steps, fp and
    kv_quant (skips without a card).

    Tolerance: max |logits - reference| <= 1e-3 * max |reference logits|.
    Both sides compute in float32 (TF32 off); they differ by summation
    order (cuBLAS and the kernels against XLA's CPU dot), about 1e-6
    relative per layer.  The kv_quant steps start from the reference's
    quantized prefill cache (an int8 value on a rounding boundary goes
    either way between the two); the port's own quantized cache differs
    from it by at most one int8 step, at under 0.1 % of its values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, s, steps = 2, 256, 8
    jcfg = JARCHS[ARCH].with_overrides(num_layers=2, dtype="float32")
    tcfg = TARCHS[ARCH].with_overrides(num_layers=2, dtype="float32",
                                       use_flash=True)
    jparams = japi.init_params(jax.random.key(0), jcfg)
    params = model_params_from_numpy(tcfg, _np(jparams), device="cuda")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (b, s + steps)).astype(
        np.int32)
    jlogits, jcaches, _ = japi.forward(
        jparams, {"tokens": jnp.asarray(tokens[:, :s])}, jcfg)
    logits, caches, _ = tapi.forward(
        params, {"tokens": torch.from_numpy(tokens[:, :s]).cuda()}, tcfg)
    scale = float(np.abs(np.asarray(jlogits)).max())
    err = float(np.abs(logits.cpu().numpy() - np.asarray(jlogits)).max())
    assert err <= 1e-3 * scale, ("prefill", err, scale)
    jpad = japi.pad_prefill_cache(jcaches, jcfg, s + steps)
    pad = tapi.pad_prefill_cache(caches, tcfg, s + steps)
    jq = jax.jit(lambda c: japi.quantize_cache(c, jcfg))(jpad)
    own = tapi.quantize_cache(pad, tcfg)["sub0"]
    for mine, theirs in ((own.k, jq["sub0"].k), (own.v, jq["sub0"].v)):
        diff = np.abs(mine.cpu().numpy().astype(np.int32)
                      - np.asarray(theirs).astype(np.int32))
        assert diff.max() <= 1 and diff.mean() < 1e-3, diff.mean()
    jstep = jax.jit(lambda p, c, t, i: japi.decode_step(p, c, t, i, jcfg))
    for name, jc, tc in (
            ("fp", jpad, pad),
            ("kv_quant", jq, {"sub0": tattn.QuantKVCache(
                *(torch.from_numpy(np.array(a)).cuda()
                  for a in jq["sub0"]))})):
        for i in range(steps):
            tok = tokens[:, s + i:s + i + 1]
            jl, jc = jstep(jparams, jc, jnp.asarray(tok),
                           jnp.asarray(s + i, jnp.int32))
            tl, tc = tapi.decode_step(params, tc,
                                      torch.from_numpy(tok).cuda(), s + i,
                                      tcfg)
            scale = float(np.abs(np.asarray(jl)).max())
            err = float(np.abs(tl.cpu().numpy() - np.asarray(jl)).max())
            assert err <= 1e-3 * scale, (name, i, err, scale)
