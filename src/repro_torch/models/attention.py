"""Attention: grouped-query (qk-norm, sliding window), multi-head latent
(MLA, a compressed-latent cache) and the encoder-decoder's
cross-attention, each with its full-sequence (prefill) and single-token
decode paths.

Counterpart of ``repro/models/attention.py``.  Cache layouts as in the
reference:
  * GQA: k/v [B, S_cache, KV, D] (``cache_mode='full'``) or a
    [B, W, KV, D] ring buffer (``'ring'``, sliding-window archs);
  * MLA: ``KVCache(k=c_kv [B, S_cache, kv_lora_rank], v=k_rope [B,
    S_cache, qk_rope_head_dim])``, the latents and not per-head K/V;
    decode scores through the absorbed projections;
  * cross: the encoder's K/V [B, T, KV, D], projected once at prefill.
RoPE is applied at write time with absolute positions.
``cfg.attn_impl == "chunked"`` runs the einsum attention a block of
``cfg.attn_chunk`` queries at a time (``_sdpa_q_chunked``), as the
reference does.

``cfg.use_flash`` (the switch ``ArchConfig`` declares) routes GQA and
cross-attention through the port's hand-written kernels: prefill to
``ops.flash_attention`` (``causal=False`` for the encoder and the cross
attention), full-cache decode to ``ops.flash_decode`` (with the int8 cache
and its scales for a :class:`QuantKVCache`; the cross cache at
``pos = T - 1``).  With it off, every path computes the reference's einsum
``_sdpa``.  The kernels have no ring validity, no logit softcap and one
head dim for q, k and v (MLA's differ), so ``use_flash`` with any of
these raises rather than drop to ``_sdpa``.

Decode writes the new token's K/V into the cache tensors in place (the
reference returns an updated copy) and returns the same cache object:
this keeps one cache in device memory.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (he_init, rmsnorm, rmsnorm_init,
                                       rope_tables, rotate)

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor            # [B, S, KV, D] (stacked: [L, B, S, KV, D])
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """int8 KV cache (kv_quant): per-(token, head) absmax scales."""
    k: torch.Tensor            # int8 [B, S, KV, D]
    v: torch.Tensor            # int8 [B, S, KV, D]
    k_scale: torch.Tensor      # f32 [B, S, KV]
    v_scale: torch.Tensor      # f32 [B, S, KV]


def _f32_reciprocal(x: float) -> float:
    """float32(1) / float32(x), rounded once in float32."""
    return float(torch.tensor(1.0) / torch.tensor(x, dtype=torch.float32))


_INV_127 = _f32_reciprocal(127.0)


def inv_sqrt(d: int) -> float:
    """The reference's score scale as its compiler computes it: XLA turns
    ``scores / float32(sqrt(d))`` into a product with the float32
    reciprocal.  A product with a host float is the same bits on the card
    and the CPU (torch's CUDA division by a scalar is itself a product with
    its reciprocal, its CPU division is not)."""
    return _f32_reciprocal(math.sqrt(d))


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 values, f32 absmax scale over D).  The scale is
    absmax * float32(1/127), the form the reference computes under ``jit``
    (XLA turns its division by the constant into this product; see
    ROADMAP Queue 3); rounding is half to even, as ``jnp.round``."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) * _INV_127
    q = torch.round(xf / torch.clamp(scale[..., None], min=1e-8))
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def check_flash(cfg: ArchConfig, cache_mode: str = "full") -> None:
    """The kernels' limits: no logit softcap, no ring-buffer validity, one
    head dim for q, k and v."""
    if not cfg.use_flash:
        return
    if cfg.attention == "mla":
        raise NotImplementedError(
            f"{cfg.name}: use_flash with MLA: the flash kernels take one "
            f"head dim for q, k and v, and MLA's differ (qk "
            f"{cfg.qk_nope_head_dim + cfg.qk_rope_head_dim}, v "
            f"{cfg.v_head_dim}); set use_flash=False")
    if cfg.logit_softcap:
        raise NotImplementedError(
            "use_flash with logit_softcap: the flash kernels have no softcap")
    if cache_mode == "ring":
        raise NotImplementedError(
            "use_flash with cache_mode='ring': flash_decode has no ring "
            "validity; use cache_mode='full' or use_flash=False")


# =================================================================== GQA
def gqa_init(gen: torch.Generator | None, cfg: ArchConfig,
             dtype: torch.dtype, *, lead: tuple = (),
             device: torch.device | str = "meta") -> dict:
    """One attention block's params, stacked over ``lead`` (e.g. (L,))."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(lead=lead, device=device)
    params = {
        "wq": he_init(gen, (d, h * hd), dtype, **kw),
        "wk": he_init(gen, (d, kv * hd), dtype, **kw),
        "wv": he_init(gen, (d, kv * hd), dtype, **kw),
        "wo": he_init(gen, (h * hd, d), dtype, fan_in=h * hd, **kw),
    }
    if cfg.qk_norm:
        params["q_norm"] = rmsnorm_init(hd, dtype, **kw)
        params["k_norm"] = rmsnorm_init(hd, dtype, **kw)
    return params


def _project_qkv(params: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor | None, rope=None):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kv, hd)
    v = (x @ params["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if rope is None:
        rope = rope_tables(positions, hd, cfg.rope_theta)
    return rotate(q, *rope), rotate(k, *rope), v


def _sdpa(q, k, v, mask, softcap=None):
    """q [B,S,H,D] x k/v [B,T,KV,D] grouped-query attention core (einsum);
    mask broadcastable to [B, KV, G, S, T]."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32)
    scores = scores * inv_sqrt(d)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, d)


def causal_mask(s: int, t: int, q_offset: int, window: int | None,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """[1,1,1,s,t] boolean mask; q_offset = absolute position of query 0."""
    q_pos = q_offset + torch.arange(s, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    m = k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    return m[None, None, None]


def _sdpa_q_chunked(q, k, v, cfg: ArchConfig, chunk: int, softcap=None):
    """Query-chunked attention (``attn_impl='chunked'``): Q in blocks of
    ``chunk`` rows, so the scores held at once are [chunk, S], not
    [S, S]."""
    b, s, h, d = q.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    outs = [_sdpa(q[:, i:i + chunk], k, v,
                  causal_mask(chunk, s, i, cfg.window, q.device), softcap)
            for i in range(0, s, chunk)]
    return torch.cat(outs, dim=1)


def _flash(q, k, v, causal: bool, window=None):
    """The flash kernel on [B, S, H, D] activations: the [B, H, S, D] views
    in, the output back as the [B, S, H, D] tensor it is in memory."""
    return ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window).transpose(1, 2)


def _chunked(cfg: ArchConfig, s: int) -> bool:
    return cfg.attn_impl == "chunked" and s > cfg.attn_chunk


def gqa_forward(params: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor,
                rope=None) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence path (prefill). Returns output and fresh cache.
    ``rope``: the (cos, sin) tables of ``positions`` when the caller has
    them (the model computes them once for all layers)."""
    check_flash(cfg)
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions, rope)
    if cfg.use_flash:
        out = _flash(q, k, v, True, cfg.window)
    elif _chunked(cfg, s):
        out = _sdpa_q_chunked(q, k, v, cfg, cfg.attn_chunk,
                              cfg.logit_softcap)
    else:
        mask = causal_mask(s, s, 0, cfg.window, x.device)
        out = _sdpa(q, k, v, mask, cfg.logit_softcap)
    out = out.reshape(b, s, -1) @ params["wo"]
    return out, KVCache(k=k, v=v)


def self_attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor, rope=None) -> torch.Tensor:
    """The encoder's bidirectional attention over x [B, T, d] (RoPE'd q
    and k, no mask): the kernel with ``causal=False`` under
    ``use_flash``."""
    check_flash(cfg)
    b, t, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions, rope)
    if cfg.use_flash:
        out = _flash(q, k, v, False)
    else:
        mask = torch.ones((1, 1, 1, t, t), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(q, k, v, mask)
    return out.reshape(b, t, -1) @ params["wo"]


def gqa_decode(params: dict, x: torch.Tensor, cache, pos: int,
               cfg: ArchConfig, cache_mode: str = "full", rope=None):
    """Single-token decode. x: [B,1,d]; pos: absolute position (host int).
    cache: KVCache or QuantKVCache (int8) of this layer, [B, S, KV, D];
    written in place at the token's slot and returned.  ``rope``: the
    (cos, sin) tables of the position, as in :func:`gqa_forward`."""
    check_flash(cfg, cache_mode)
    b = x.shape[0]
    if rope is None:
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q, k_new, v_new = _project_qkv(params, x, cfg, None, rope)
    s_cache = cache.k.shape[1]
    slot = pos % s_cache if cache_mode == "ring" else pos
    quant = isinstance(cache, QuantKVCache)
    if quant:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        cache.k[:, slot] = kq[:, 0]
        cache.v[:, slot] = vq[:, 0]
        cache.k_scale[:, slot] = ks[:, 0]
        cache.v_scale[:, slot] = vs[:, 0]
    else:
        cache.k[:, slot] = k_new[:, 0]
        cache.v[:, slot] = v_new[:, 0]
    if cfg.use_flash:
        scales = {}
        if quant:
            scales = dict(k_scale=cache.k_scale.transpose(1, 2),
                          v_scale=cache.v_scale.transpose(1, 2))
        out = ops.flash_decode(q[:, 0], cache.k.transpose(1, 2),
                               cache.v.transpose(1, 2), pos,
                               window=cfg.window, **scales)
        return out.reshape(b, 1, -1) @ params["wo"], cache
    if quant:
        k = dequantize_kv(cache.k, cache.k_scale, k_new.dtype)
        v = dequantize_kv(cache.v, cache.v_scale, v_new.dtype)
    else:
        k, v = cache.k, cache.v
    idx = torch.arange(s_cache, device=x.device)
    valid = _valid(idx, slot, pos, s_cache, cfg, cache_mode)
    out = _sdpa(q, k, v, valid[None, None, None, None, :], cfg.logit_softcap)
    return out.reshape(b, 1, -1) @ params["wo"], cache


def _valid(idx, slot: int, pos: int, s_cache: int, cfg: ArchConfig,
           cache_mode: str) -> torch.Tensor:
    """The cache entries a decode step at ``pos`` attends to."""
    if cache_mode == "ring":
        # validity only: entries written so far and within the window
        age = (slot - idx) % s_cache          # 0 = just written
        valid = age <= min(pos, s_cache - 1)
        if cfg.window is not None:
            valid &= age < cfg.window
    else:
        valid = idx <= pos
        if cfg.window is not None:
            valid &= idx > pos - cfg.window
    return valid


# =================================================================== MLA
def mla_init(gen: torch.Generator | None, cfg: ArchConfig,
             dtype: torch.dtype, *, lead: tuple = (),
             device: torch.device | str = "meta") -> dict:
    d, h = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    d_nope, d_rope, d_v = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                           cfg.v_head_dim)
    kw = dict(lead=lead, device=device)
    return {
        "wq_a": he_init(gen, (d, r_q), dtype, **kw),
        "q_a_norm": rmsnorm_init(r_q, dtype, **kw),
        "wq_b": he_init(gen, (r_q, h * (d_nope + d_rope)), dtype, **kw),
        "wkv_a": he_init(gen, (d, r_kv + d_rope), dtype, **kw),
        "kv_a_norm": rmsnorm_init(r_kv, dtype, **kw),
        "wk_b": he_init(gen, (r_kv, h * d_nope), dtype, **kw),
        "wv_b": he_init(gen, (r_kv, h * d_v), dtype, **kw),
        "wo": he_init(gen, (h * d_v, d), dtype, fan_in=h * d_v, **kw),
    }


def _mla_q(params: dict, x: torch.Tensor, cfg: ArchConfig, rope):
    b, s, _ = x.shape
    d_nope, d_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = rmsnorm(params["q_a_norm"], x @ params["wq_a"], cfg.norm_eps)
    q = (q @ params["wq_b"]).reshape(b, s, cfg.num_heads, d_nope + d_rope)
    return q[..., :d_nope], rotate(q[..., d_nope:], *rope)


def _mla_latents(params: dict, x: torch.Tensor, cfg: ArchConfig, rope):
    r_kv = cfg.kv_lora_rank
    kv = x @ params["wkv_a"]
    c_kv = rmsnorm(params["kv_a_norm"], kv[..., :r_kv], cfg.norm_eps)
    k_rope = rotate(kv[..., r_kv:][..., None, :], *rope)[..., 0, :]
    return c_kv, k_rope                        # k_rope: one shared head


def mla_forward(params: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor,
                rope=None) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence MLA (the expanded form); caches the latents only.
    ``rope``: the tables of ``positions`` at ``qk_rope_head_dim``."""
    check_flash(cfg)
    b, s, _ = x.shape
    h, d_nope, d_v = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    if rope is None:
        rope = rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope = _mla_q(params, x, cfg, rope)
    c_kv, k_rope = _mla_latents(params, x, cfg, rope)
    k_nope = (c_kv @ params["wk_b"]).reshape(b, s, h, d_nope)
    v = (c_kv @ params["wv_b"]).reshape(b, s, h, d_v)
    scale = inv_sqrt(d_nope + cfg.qk_rope_head_dim)

    def block(qn, qr, q_offset, c):
        scores = (torch.einsum("bshd,bthd->bhst", qn, k_nope)
                  + torch.einsum("bshd,btd->bhst", qr, k_rope)
                  ).to(torch.float32) * scale
        mask = causal_mask(c, s, q_offset, cfg.window, x.device)[:, :, 0]
        probs = torch.softmax(torch.where(mask, scores, NEG_INF),
                              dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthd->bshd", probs, v)

    if _chunked(cfg, s):     # [chunk, S] scores instead of [S, S]
        c = cfg.attn_chunk
        out = torch.cat([block(q_nope[:, i:i + c], q_rope[:, i:i + c], i, c)
                         for i in range(0, s, c)], dim=1)
    else:
        out = block(q_nope, q_rope, 0, s)
    out = out.reshape(b, s, -1) @ params["wo"]
    return out, KVCache(k=c_kv, v=k_rope)


def mla_decode(params: dict, x: torch.Tensor, cache: KVCache, pos: int,
               cfg: ArchConfig, cache_mode: str = "full", rope=None):
    """Absorbed-projection decode: scores through the latents, never
    per-head K/V for the whole cache.  The token's latents are written
    into ``cache`` (this layer's [B, S, R] and [B, S, Dr]) in place."""
    check_flash(cfg)
    b = x.shape[0]
    h, d_nope, d_v = cfg.num_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    if rope is None:
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        rope = rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope = _mla_q(params, x, cfg, rope)              # [b,1,h,*]
    c_new, kr_new = _mla_latents(params, x, cfg, rope)
    s_cache = cache.k.shape[1]
    slot = pos % s_cache if cache_mode == "ring" else pos
    cache.k[:, slot] = c_new[:, 0]
    cache.v[:, slot] = kr_new[:, 0]
    c_kv, k_rope = cache.k, cache.v
    # absorb W_uk into the query: q_abs [b, h, r_kv]
    wk_b = params["wk_b"].reshape(r_kv, h, d_nope)
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)[:, 0]
    scores = (torch.einsum("bhr,btr->bht", q_abs, c_kv)
              + torch.einsum("bshd,btd->bht", q_rope, k_rope)
              ).to(torch.float32) * inv_sqrt(d_nope + cfg.qk_rope_head_dim)
    idx = torch.arange(s_cache, device=x.device)
    valid = _valid(idx, slot, pos, s_cache, cfg, cache_mode)
    probs = torch.softmax(torch.where(valid[None, None, :], scores, NEG_INF),
                          dim=-1).to(c_kv.dtype)
    out_latent = torch.einsum("bht,btr->bhr", probs, c_kv)     # [b, h, r]
    wv_b = params["wv_b"].reshape(r_kv, h, d_v)
    out = torch.einsum("bhr,rhd->bhd", out_latent, wv_b).reshape(b, 1, -1)
    return out @ params["wo"], cache


# ========================================================== Cross-attention
def cross_attn_init(gen: torch.Generator | None, cfg: ArchConfig,
                    dtype: torch.dtype, *, lead: tuple = (),
                    device: torch.device | str = "meta") -> dict:
    return gqa_init(gen, cfg, dtype, lead=lead, device=device)


def cross_attn(params: dict, x: torch.Tensor, enc_kv: KVCache,
               cfg: ArchConfig, decode: bool = False) -> torch.Tensor:
    """Decoder-to-encoder attention of x [B, S, d] over the encoder's K/V
    [B, T, KV, D] (projected once at prefill; no mask, no RoPE).  Under
    ``use_flash``: ``flash_attention(causal=False)`` at prefill (S <= T),
    ``flash_decode`` at ``pos = T - 1`` for a decode step."""
    check_flash(cfg)
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    t = enc_kv.k.shape[1]
    if cfg.use_flash and decode:
        out = ops.flash_decode(q[:, 0], enc_kv.k.transpose(1, 2),
                               enc_kv.v.transpose(1, 2), t - 1)[:, None]
    elif cfg.use_flash:
        if s > t:
            raise NotImplementedError(
                f"{cfg.name}: use_flash cross-attention of {s} queries over "
                f"{t} encoder positions: the flash kernel takes S <= T")
        out = _flash(q, enc_kv.k, enc_kv.v, False)
    else:
        mask = torch.ones((1, 1, 1, s, t), dtype=torch.bool, device=x.device)
        out = _sdpa(q, enc_kv.k, enc_kv.v, mask)
    return out.reshape(b, s, -1) @ params["wo"]


def encode_kv(params: dict, enc_out: torch.Tensor,
              cfg: ArchConfig) -> KVCache:
    b, t, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return KVCache(k=(enc_out @ params["wk"]).reshape(b, t, kv, hd),
                   v=(enc_out @ params["wv"]).reshape(b, t, kv, hd))
