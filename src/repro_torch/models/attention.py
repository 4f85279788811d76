"""Grouped-query attention (qk-norm, sliding window) with its full-sequence
(prefill) and single-token decode paths.

Counterpart of the GQA half of ``repro/models/attention.py``; MLA and
cross-attention wait for a later slice.  KV cache layout as in the
reference: k/v [B, S_cache, KV, D] (``cache_mode='full'``) or a [B, W, KV, D]
ring buffer (``'ring'``, sliding-window archs).  RoPE is applied at write
time with absolute positions.

``cfg.use_flash`` (the switch ``ArchConfig`` declares) routes attention
through the port's hand-written kernels: prefill to
``ops.flash_attention``, full-cache decode to ``ops.flash_decode`` (with
the int8 cache and its scales for a :class:`QuantKVCache`).  With it off,
both paths compute the reference's einsum ``_sdpa``.  The kernels have no
ring validity and no logit softcap, so ``use_flash`` with either raises
rather than drop to ``_sdpa``.

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
    """The kernels' limits: no logit softcap, no ring-buffer validity."""
    if not cfg.use_flash:
        return
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
        # [B,S,H,D] views as [B,H,S,D]; the output comes back as the
        # [B,H,S,D] view of a [B,S,H,D] tensor
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
                                  window=cfg.window).transpose(1, 2)
    else:
        mask = causal_mask(s, s, 0, cfg.window, x.device)
        out = _sdpa(q, k, v, mask, cfg.logit_softcap)
    out = out.reshape(b, s, -1) @ params["wo"]
    return out, KVCache(k=k, v=v)


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
    out = _sdpa(q, k, v, valid[None, None, None, None, :], cfg.logit_softcap)
    return out.reshape(b, 1, -1) @ params["wo"], cache
