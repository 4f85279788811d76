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

Tensor parallelism (``tp``, a :class:`repro_torch.sharding.tp.TP`: the
mesh's ``model`` axis, :func:`repro_torch.sharding.tp.active`): a rank
holds the rules' shard of each leaf, and the local shapes say what it
computes.  ``wq`` split over whole heads: the rank's H / tp query heads,
``wo`` row-parallel, the partial outputs summed over ``model``.  ``wk``
and ``wv`` split too when KV divides tp; else they stay whole and the rank
hands the attention only the KV heads its query heads read (KV head = q
head // (H / KV)).  H not dividing tp: every rank computes the whole
attention.  Under ``split`` (sequence parallelism) x is the rank's chunk
of S, gathered on entry and reduce-scattered on exit.  The decode cache
is laid out by ``rules.cache_specs``: the rank's KV heads, or (KV not
dividing tp) its chunk of the positions, when each rank attends its
chunk with all query heads and the ranks' partial outputs are merged
(``tp.merge_decode``).  MLA splits its b-matrices over whole heads (the
latent projections every rank's), or with ``mla_rank_shard`` where H
does not divide over their rank dim; its latent cache is split along
the positions.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (he_init, rmsnorm, rmsnorm_init,
                                       rope_tables, rotate)
from repro_torch.sharding import tp as tp_lib

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
    """q, k, v [B, S, heads, D]: the heads of the leaves this rank holds
    (all of them without tensor parallelism)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, -1, hd)
    k = (x @ params["wk"]).reshape(b, s, -1, hd)
    v = (x @ params["wv"]).reshape(b, s, -1, hd)
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


def heads_split(params: dict, cfg: ArchConfig, tp) -> bool:
    """Whether this rank holds a share of the query heads (``wq`` split
    over ``model``)."""
    return tp is not None and (params["wq"].shape[-1]
                               < cfg.num_heads * cfg.head_dim)


def _gqa_local(params: dict, cfg: ArchConfig, tp) -> dict:
    """The params as a rank holding a share of the heads uses them: the
    leaves it holds whole (the qk norms; ``wk``/``wv`` when KV does not
    divide tp) through ``tp.shared``."""
    if tp is None:
        return params
    out = dict(params)
    if params["wk"].shape[-1] == cfg.num_kv_heads * cfg.head_dim:
        out["wk"] = tp_lib.shared(params["wk"], tp)
        out["wv"] = tp_lib.shared(params["wv"], tp)
    for name in ("q_norm", "k_norm"):
        if name in params:
            out[name] = {"scale": tp_lib.shared(params[name]["scale"], tp)}
    return out


def _kv_read(k: torch.Tensor, cfg: ArchConfig, tp) -> torch.Tensor:
    """Of all KV heads k [B, S, KV, D], the ones this rank's query heads
    read (q head h reads KV head h // (H / KV)): one head when they share
    one, else one a query head."""
    g = cfg.num_heads // cfg.num_kv_heads
    idx = [h // g for h in tp_lib.local_heads(tp, cfg.num_heads)]
    if len(set(idx)) == 1:
        return k[:, :, idx[0]:idx[0] + 1]
    return k[:, :, idx]


def gqa_forward(params: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, rope=None, tp=None,
                split: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence path (prefill). Returns output and fresh cache.
    ``rope``: the (cos, sin) tables of ``positions`` when the caller has
    them (the model computes them once for all layers).  ``tp``,
    ``split``: this rank's share (module docstring); the cache holds the
    rank's KV heads, or all of them when ``wk`` is whole."""
    check_flash(cfg)
    share = heads_split(params, cfg, tp)
    params = _gqa_local(params, cfg, tp if share else None)
    x = tp_lib.enter(x, tp, split, whole=not share)
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions, rope)
    ka, va = k, v
    if share and k.shape[2] == cfg.num_kv_heads:
        ka, va = _kv_read(k, cfg, tp), _kv_read(v, cfg, tp)
    if cfg.use_flash:
        out = _flash(q, ka, va, True, cfg.window)
    elif _chunked(cfg, s):
        out = _sdpa_q_chunked(q, ka, va, cfg, cfg.attn_chunk,
                              cfg.logit_softcap)
    else:
        mask = causal_mask(s, s, 0, cfg.window, x.device)
        out = _sdpa(q, ka, va, mask, cfg.logit_softcap)
    out = out.reshape(b, s, -1) @ params["wo"]
    return tp_lib.leave(out, tp, split, whole=not share), KVCache(k=k, v=v)


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
               cfg: ArchConfig, cache_mode: str = "full", rope=None,
               tp=None, seq=None):
    """Single-token decode. x: [B,1,d]; pos: absolute position (host int).
    cache: KVCache or QuantKVCache (int8) of this layer, [B, S, KV, D];
    written in place at the token's slot and returned.  ``rope``: the
    (cos, sin) tables of the position, as in :func:`gqa_forward`.
    ``tp``: this rank's share; ``seq`` (a ``tp.CacheSplit``): the cache is
    this rank's chunk of the positions (:func:`_decode_split`)."""
    check_flash(cfg, cache_mode)
    b = x.shape[0]
    if rope is None:
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    share = heads_split(params, cfg, tp)
    x = tp_lib.enter(x, tp, False, whole=not share)
    q, k_new, v_new = _project_qkv(params, x, cfg, None, rope)
    if seq is not None:
        out = _decode_split(q, k_new, v_new, cache, pos, cfg, cache_mode,
                            tp if share else None, seq)
        out = out.reshape(b, 1, -1) @ params["wo"]
        return tp_lib.leave(out, tp, False, whole=not share), cache
    if share and k_new.shape[2] == cfg.num_kv_heads:
        raise ValueError(f"{cfg.name}: a decode cache of all "
                         f"{cfg.num_kv_heads} KV heads under tensor "
                         f"parallelism must be split over its positions "
                         f"(api.init_cache or api.pad_prefill_cache under "
                         f"the mesh)")
    s_cache = cache.k.shape[1]
    slot = pos % s_cache if cache_mode == "ring" else pos
    quant = isinstance(cache, QuantKVCache)
    _write(cache, slot, k_new, v_new)
    if cfg.use_flash:
        scales = {}
        if quant:
            scales = dict(k_scale=cache.k_scale.transpose(1, 2),
                          v_scale=cache.v_scale.transpose(1, 2))
        out = ops.flash_decode(q[:, 0], cache.k.transpose(1, 2),
                               cache.v.transpose(1, 2), pos,
                               window=cfg.window, **scales)
    else:
        if quant:
            k = dequantize_kv(cache.k, cache.k_scale, k_new.dtype)
            v = dequantize_kv(cache.v, cache.v_scale, v_new.dtype)
        else:
            k, v = cache.k, cache.v
        idx = torch.arange(s_cache, device=x.device)
        valid = _valid(idx, slot, pos, s_cache, cfg, cache_mode)
        out = _sdpa(q, k, v, valid[None, None, None, None, :],
                    cfg.logit_softcap)
    out = out.reshape(b, 1, -1) @ params["wo"]
    return tp_lib.leave(out, tp, False, whole=not share), cache


def _write(cache, slot: int, k_new, v_new) -> None:
    """The token's K/V into slot ``slot`` of a layer's cache (int8 with
    its scales for a QuantKVCache)."""
    if isinstance(cache, QuantKVCache):
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        cache.k[:, slot] = kq[:, 0]
        cache.v[:, slot] = vq[:, 0]
        cache.k_scale[:, slot] = ks[:, 0]
        cache.v_scale[:, slot] = vs[:, 0]
    else:
        cache.k[:, slot] = k_new[:, 0]
        cache.v[:, slot] = v_new[:, 0]


def _chunk_valid(pos: int, s0: int, s_loc: int, s_glob: int,
                 cfg: ArchConfig, cache_mode: str) -> bool:
    """Whether the chunk [s0, s0 + s_loc) of a cache of ``s_glob`` holds a
    position a decode step at ``pos`` attends to (:func:`_valid`'s rule,
    tested on the host: no device read).  A ring's valid slots are the
    cyclic interval of the last min(pos + 1, s_glob, window) ones."""
    if cache_mode == "ring":
        slot = pos % s_glob
        k = min(pos + 1, s_glob, cfg.window or s_glob)
        lo = slot - k + 1
        spans = [(lo, slot)] if lo >= 0 else [(0, slot),
                                              (lo + s_glob, s_glob - 1)]
    else:
        spans = [(0 if cfg.window is None else max(0, pos - cfg.window + 1),
                  pos)]
    return any(max(a, s0) <= min(b, s0 + s_loc - 1) for a, b in spans)


def _sdpa_partial(q, k, v, valid, any_valid: bool, softcap=None):
    """The einsum attention of q [B, 1, H, D] over the valid positions of
    k/v [B, T, KV, D] as a partial state: (o [B, H, D], lse [B, H])
    float32; o = 0 and lse = -inf when none is valid (``any_valid``)."""
    b, _, h, d = q.shape
    kv = k.shape[2]
    if not any_valid:
        return (q.new_zeros((b, h, d), dtype=torch.float32),
                q.new_full((b, h), -math.inf, dtype=torch.float32))
    qg = q.reshape(b, 1, kv, h // kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    scores = scores * inv_sqrt(d)
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(valid, scores, NEG_INF)[:, :, :, 0]   # [b,k,g,t]
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None])
    o = torch.einsum("bkgt,btkd->bkgd", probs, v.to(torch.float32))
    return o.reshape(b, h, d), lse.reshape(b, h)


def _decode_split(q, k_new, v_new, cache, pos: int, cfg: ArchConfig,
                  cache_mode: str, tp, seq) -> torch.Tensor:
    """One decode step over a cache split along its positions: this rank
    holds [seq.s0, seq.s0 + S) of every KV head.  It writes the token if
    its slot is here, attends its positions with all query heads (``tp``:
    q holds this rank's share of them, gathered first) and merges the
    ranks' partial states; returns this rank's heads' [B, 1, H_loc, D]."""
    s_loc = cache.k.shape[1]
    s_glob = seq.parts * s_loc
    slot = pos % s_glob if cache_mode == "ring" else pos
    if k_new.shape[2] < cache.k.shape[2]:    # split KV heads, whole cache
        k_new, v_new = (tp_lib.gather(t, tp, 2) for t in (k_new, v_new))
    if seq.s0 <= slot < seq.s0 + s_loc:
        _write(cache, slot - seq.s0, k_new, v_new)
    q_all = q if tp is None else tp_lib.gather(q, tp, 2)
    quant = isinstance(cache, QuantKVCache)
    if cfg.use_flash:
        scales = {}
        if quant:
            scales = dict(k_scale=cache.k_scale.transpose(1, 2),
                          v_scale=cache.v_scale.transpose(1, 2))
        o, lse = ops.flash_decode_shard(
            q_all[:, 0], cache.k.transpose(1, 2), cache.v.transpose(1, 2),
            pos, seq.s0, window=cfg.window, **scales)
    else:
        if quant:
            k = dequantize_kv(cache.k, cache.k_scale, k_new.dtype)
            v = dequantize_kv(cache.v, cache.v_scale, v_new.dtype)
        else:
            k, v = cache.k, cache.v
        idx = seq.s0 + torch.arange(s_loc, device=q.device)
        valid = _valid(idx, slot, pos, s_glob, cfg, cache_mode)
        o, lse = _sdpa_partial(q_all, k, v, valid[None, None, None, None, :],
                               _chunk_valid(pos, seq.s0, s_loc, s_glob, cfg,
                                            cache_mode), cfg.logit_softcap)
    o = tp_lib.merge_decode(o, lse, seq.group, seq.parts).to(q.dtype)
    if tp is not None:
        heads = tp_lib.local_heads(tp, cfg.num_heads)
        o = o[:, heads.start:heads.stop]
    return o[:, None]


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


def _mla_q(params: dict, x: torch.Tensor, cfg: ArchConfig, rope,
           rank_tp=None):
    """q's nope and (rotated) rope parts; ``rank_tp``: ``wq_b`` is this
    rank's rows of the rank dim (``mla_rank_shard``)."""
    b, s, _ = x.shape
    d_nope, d_rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = rmsnorm(params["q_a_norm"], x @ params["wq_a"], cfg.norm_eps)
    q = (q @ params["wq_b"] if rank_tp is None
         else _rank_product(q, params["wq_b"], rank_tp))
    q = q.reshape(b, s, -1, d_nope + d_rope)
    return q[..., :d_nope], rotate(q[..., d_nope:], *rope)


def _mla_latents(params: dict, x: torch.Tensor, cfg: ArchConfig, rope):
    r_kv = cfg.kv_lora_rank
    kv = x @ params["wkv_a"]
    c_kv = rmsnorm(params["kv_a_norm"], kv[..., :r_kv], cfg.norm_eps)
    k_rope = rotate(kv[..., r_kv:][..., None, :], *rope)[..., 0, :]
    return c_kv, k_rope                        # k_rope: one shared head


def _mla_split(params: dict, cfg: ArchConfig, tp) -> str | None:
    """How this rank holds MLA's b-matrices: "heads" (split over whole
    heads), "rank" (``mla_rank_shard`` where H does not divide the axis:
    split on their input rank dim, the products partial sums), or None
    (whole)."""
    if tp is None:
        return None
    if params["wq_b"].shape[-2] < cfg.q_lora_rank:
        return "rank"
    width = cfg.num_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    return "heads" if params["wq_b"].shape[-1] < width else None


def _rank_product(x: torch.Tensor, w: torch.Tensor, tp) -> torch.Tensor:
    """x [..., R] (every rank's) through w [R / tp, N] (this rank's rows
    of the rank dim): the ranks' partial products summed, whole on each
    rank; backward, the rank's chunk of dx gathered."""
    return tp_lib.reduce_from_model(tp_lib.split(x, tp, -1) @ w, tp)


def _mla_out(params: dict, out: torch.Tensor, cfg: ArchConfig, tp,
             split: bool, mode: str | None) -> torch.Tensor:
    """The output projection of [B, S, H * dv] (``mode`` "heads": of this
    rank's heads): row-parallel where ``wo``'s input dim is split (every
    rank's whole output cut to the rank's chunk first), else whole."""
    wo_split = tp is not None and (params["wo"].shape[-2]
                                   < cfg.num_heads * cfg.v_head_dim)
    if wo_split and mode != "heads":
        out = tp_lib.split(out, tp, -1)
    return tp_lib.leave(out @ params["wo"], tp, split, whole=not wo_split)


def mla_forward(params: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, rope=None, tp=None,
                split: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence MLA (the expanded form); caches the latents only.
    ``rope``: the tables of ``positions`` at ``qk_rope_head_dim``.
    ``tp``, ``split``: this rank's share of the heads (``wq_b``,
    ``wk_b``, ``wv_b`` split over whole heads, ``wo`` row-parallel); where
    H does not divide ``model``, the whole attention on every rank, with
    under ``mla_rank_shard`` the b-matrices' products over their rank dim
    and ``wo``'s over H * dv split (partial sums, all-reduced); the
    latents are every rank's."""
    check_flash(cfg)
    mode = _mla_split(params, cfg, tp)
    if mode == "heads":  # the latent projections: every rank's, for a share
        params = dict(params)
        for name in ("wq_a", "wkv_a"):
            params[name] = tp_lib.shared(params[name], tp)
        for name in ("q_a_norm", "kv_a_norm"):
            params[name] = {"scale": tp_lib.shared(params[name]["scale"],
                                                   tp)}
    x = tp_lib.enter(x, tp, split, whole=mode != "heads")
    b, s, _ = x.shape
    d_nope, d_v = cfg.qk_nope_head_dim, cfg.v_head_dim
    if rope is None:
        rope = rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope = _mla_q(params, x, cfg, rope, tp if mode == "rank"
                            else None)
    c_kv, k_rope = _mla_latents(params, x, cfg, rope)
    if mode == "rank":
        k_nope = _rank_product(c_kv, params["wk_b"], tp)
        v = _rank_product(c_kv, params["wv_b"], tp)
    else:
        k_nope, v = c_kv @ params["wk_b"], c_kv @ params["wv_b"]
    k_nope, v = k_nope.reshape(b, s, -1, d_nope), v.reshape(b, s, -1, d_v)
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
    return (_mla_out(params, out.reshape(b, s, -1), cfg, tp, split, mode),
            KVCache(k=c_kv, v=k_rope))


def mla_decode(params: dict, x: torch.Tensor, cache: KVCache, pos: int,
               cfg: ArchConfig, cache_mode: str = "full", rope=None,
               tp=None, seq=None):
    """Absorbed-projection decode: scores through the latents, never
    per-head K/V for the whole cache.  The token's latents are written
    into ``cache`` (this layer's [B, S, R] and [B, S, Dr]) in place.
    ``tp``: this rank's share of the heads or of the b-matrices' rank
    dim, as in :func:`mla_forward`; ``seq`` (a ``tp.CacheSplit``): the
    cache is the rank's chunk of the positions, attended with all heads
    and merged across the ranks."""
    check_flash(cfg)
    mode = _mla_split(params, cfg, tp)
    share = mode == "heads"
    x = tp_lib.enter(x, tp, False, whole=not share)
    b = x.shape[0]
    d_nope, d_v = cfg.qk_nope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    if rope is None:
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=x.device)
        rope = rope_tables(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    q_nope, q_rope = _mla_q(params, x, cfg, rope,           # [b,1,h,*]
                            tp if mode == "rank" else None)
    c_new, kr_new = _mla_latents(params, x, cfg, rope)
    s_cache = cache.k.shape[1]
    s0, s_glob = (0, s_cache) if seq is None else (seq.s0,
                                                   seq.parts * s_cache)
    slot = pos % s_glob if cache_mode == "ring" else pos
    if seq is None or s0 <= slot < s0 + s_cache:    # the chunk holding it
        cache.k[:, slot - s0] = c_new[:, 0]
        cache.v[:, slot - s0] = kr_new[:, 0]
    c_kv, k_rope = cache.k, cache.v
    # absorb W_uk into the query: q_abs [b, h, r_kv] (under "rank" this
    # rank's rows of W_uk give its chunk of r, gathered)
    wk_b = params["wk_b"].reshape(params["wk_b"].shape[0], -1, d_nope)
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, wk_b)[:, 0]
    if mode == "rank":
        q_abs = tp_lib.gather(q_abs, tp, 2)
    q_rope = q_rope[:, 0]                                      # [b, h, dr]
    if seq is not None and share:          # every head over this chunk
        q_abs, q_rope = (tp_lib.gather(t, tp, 1) for t in (q_abs, q_rope))
    scores = (torch.einsum("bhr,btr->bht", q_abs, c_kv)
              + torch.einsum("bhd,btd->bht", q_rope, k_rope)
              ).to(torch.float32) * inv_sqrt(d_nope + cfg.qk_rope_head_dim)
    idx = s0 + torch.arange(s_cache, device=x.device)
    valid = _valid(idx, slot, pos, s_glob, cfg, cache_mode)
    scores = torch.where(valid[None, None, :], scores, NEG_INF)
    if seq is None:
        probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
        out_latent = torch.einsum("bht,btr->bhr", probs, c_kv)  # [b, h, r]
    else:
        if _chunk_valid(pos, s0, s_cache, s_glob, cfg, cache_mode):
            lse = torch.logsumexp(scores, dim=-1)
            part = torch.einsum("bht,btr->bhr", torch.exp(
                scores - lse[..., None]), c_kv.to(torch.float32))
        else:
            lse = torch.full(scores.shape[:2], -math.inf,
                             device=x.device)
            part = torch.zeros(scores.shape[:2] + (r_kv,), device=x.device)
        out_latent = tp_lib.merge_decode(part, lse, seq.group,
                                         seq.parts).to(c_kv.dtype)
        if share:
            heads = tp_lib.local_heads(tp, cfg.num_heads)
            out_latent = out_latent[:, heads.start:heads.stop]
    wv_b = params["wv_b"].reshape(params["wv_b"].shape[0], -1, d_v)
    if mode == "rank":
        out = tp_lib.reduce_from_model(torch.einsum(
            "bhr,rhd->bhd", tp_lib.chunk(out_latent, tp, 2), wv_b), tp)
    else:
        out = torch.einsum("bhr,rhd->bhd", out_latent, wv_b)
    return _mla_out(params, out.reshape(b, 1, -1), cfg, tp, False,
                    mode), cache


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
