"""Encoder-decoder backbone (whisper-tiny).

Counterpart of ``repro/models/encdec.py``.  The mel-spectrogram and conv
feature extractor is the reference's sanctioned frontend stub:
``batch["frames"]`` carries precomputed frame embeddings [B, T, d].  The
encoder is bidirectional attention blocks (RoPE'd, as the reference's
backbone); the decoder is causal self-attention, cross-attention to the
encoder and a gated MLP, a plain loop over the layers stacked on a leading
axis as the reference's ``scan`` lays them out::

  {"embed": {"embedding": [V, d]},
   "enc_layers": {"ln1", "attn", "ln2", "mlp"} each [Le, ...],
   "enc_norm": {"scale": [d]},
   "dec_layers": {"ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"}
                 each [L, ...],
   "final_norm": {"scale": [d]}}

The decode cache is ``{"self": KVCache [L, B, S, KV, D] (or a
QuantKVCache), "cross": KVCache [L, B, T, KV, D]}``: the encoder's K/V
projected once at prefill, never padded or quantized.  Under ``use_flash``
the encoder and the cross-attention run ``flash_attention`` with
``causal=False`` and a decode step's cross-attention ``flash_decode`` at
``pos = T - 1``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, mlp_apply, mlp_init,
                                       normal_init, rmsnorm, rmsnorm_init,
                                       rope_tables, unembed)
from repro_torch.models.transformer import _dtype, _layers, check_supported


def init_params(cfg: ArchConfig, gen: torch.Generator | None = None) -> dict:
    """Random parameters drawn from ``gen`` on its device, in
    ``cfg.dtype`` (``gen`` None: shapes on the meta device)."""
    check_supported(cfg)
    dtype, device = _dtype(cfg), ("meta" if gen is None else gen.device)
    d = cfg.d_model
    enc = dict(lead=(cfg.encoder_layers,), device=device)
    dec = dict(lead=(cfg.num_layers,), device=device)
    return {
        "embed": {"embedding": normal_init(gen, (cfg.vocab_size, d), dtype,
                                           device=device)},
        "enc_layers": {"ln1": rmsnorm_init(d, dtype, **enc),
                       "attn": attn.gqa_init(gen, cfg, dtype, **enc),
                       "ln2": rmsnorm_init(d, dtype, **enc),
                       "mlp": mlp_init(gen, d, cfg.d_ff, dtype, **enc)},
        "enc_norm": rmsnorm_init(d, dtype, device=device),
        "dec_layers": {"ln1": rmsnorm_init(d, dtype, **dec),
                       "self_attn": attn.gqa_init(gen, cfg, dtype, **dec),
                       "ln_x": rmsnorm_init(d, dtype, **dec),
                       "cross_attn": attn.cross_attn_init(gen, cfg, dtype,
                                                          **dec),
                       "ln2": rmsnorm_init(d, dtype, **dec),
                       "mlp": mlp_init(gen, d, cfg.d_ff, dtype, **dec)},
        "final_norm": rmsnorm_init(d, dtype, device=device),
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _enc_layer(p: dict, x: torch.Tensor, cfg: ArchConfig, positions, rope):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attn.self_attention(p["attn"], h, cfg, positions, rope)
    return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                         cfg.act)


def encode(params: dict, frames: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """The encoder over frame embeddings [B, T, d]: [B, T, d]."""
    b, t, _ = frames.shape
    positions = _positions(b, t, frames.device)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = frames.to(_dtype(cfg))
    for p in _layers(params["enc_layers"], cfg.encoder_layers):
        x = _enc_layer(p, x, cfg, positions, rope)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def cross_kv(params: dict, enc_out: torch.Tensor,
             cfg: ArchConfig) -> attn.KVCache:
    """The encoder output projected to every decoder layer's K/V (once):
    [L, B, T, KV, D] each."""
    kvs = [attn.encode_kv(p["cross_attn"], enc_out, cfg)
           for p in _layers(params["dec_layers"], cfg.num_layers)]
    return attn.KVCache(k=torch.stack([kv.k for kv in kvs]),
                        v=torch.stack([kv.v for kv in kvs]))


def _dec_layer(p: dict, x: torch.Tensor, cfg: ArchConfig, positions, rope,
               enc_k: torch.Tensor, enc_v: torch.Tensor):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    out, cache = attn.gqa_forward(p["self_attn"], h, cfg, positions, rope)
    x = x + out
    h = rmsnorm(p["ln_x"], x, cfg.norm_eps)
    x = x + attn.cross_attn(p["cross_attn"], h, attn.KVCache(enc_k, enc_v),
                            cfg)
    x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    return x, cache


def forward(params: dict, batch: dict, cfg: ArchConfig):
    """Teacher-forced prefill.  batch: {"frames": [B, T, d], "tokens":
    [B, S]}.  Returns (logits [B, S, V], {"self": K/V, "cross": the
    encoder's K/V}, aux = 0)."""
    check_supported(cfg)
    enc_kv = cross_kv(params, encode(params, batch["frames"], cfg), cfg)
    x = embed(params["embed"], batch["tokens"], cfg.embed_scale)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    layers = _layers(params["dec_layers"], cfg.num_layers)
    for p, ek, ev in zip(layers, enc_kv.k.unbind(0), enc_kv.v.unbind(0)):
        x, cache = _dec_layer(p, x, cfg, positions, rope, ek, ev)
        ks.append(cache.k)
        vs.append(cache.v)
    logits = unembed(params["embed"], rmsnorm(params["final_norm"], x,
                                              cfg.norm_eps))
    caches = {"self": attn.KVCache(k=torch.stack(ks), v=torch.stack(vs)),
              "cross": enc_kv}
    return (logits, caches,
            torch.zeros((), dtype=torch.float32, device=logits.device))


def forward_train(params: dict, batch: dict, cfg: ArchConfig):
    """The training forward: (logits, aux = 0).  The caches are dropped
    (the reference's encoder-decoder has no remat either)."""
    logits, _, aux = forward(params, batch, cfg)
    return logits, aux


def decode_step(params: dict, caches: dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, cache_mode: str = "full"):
    """One decoder token against the self cache (written in place) and the
    encoder memory.  Returns (logits [B, 1, V], caches)."""
    check_supported(cfg)
    attn.check_flash(cfg, cache_mode)
    pos = int(pos)
    x = embed(params["embed"], tokens, cfg.embed_scale)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    stacked, cross = caches["self"], caches["cross"]
    for i, p in enumerate(_layers(params["dec_layers"], cfg.num_layers)):
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        out, _ = attn.gqa_decode(p["self_attn"], h,
                                 type(stacked)(*(a[i] for a in stacked)),
                                 pos, cfg, cache_mode, rope)
        x = x + out
        h = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        x = x + attn.cross_attn(p["cross_attn"], h,
                                attn.KVCache(cross.k[i], cross.v[i]), cfg,
                                decode=True)
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                          cfg.act)
    return unembed(params["embed"], rmsnorm(params["final_norm"], x,
                                            cfg.norm_eps)), caches


def init_cache(cfg: ArchConfig, batch: int, s_cache: int,
               dtype: torch.dtype | None = None,
               device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """Zero self and cross caches [L, B, *, KV, D] on ``device``."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    lead = (cfg.num_layers, batch)
    tail = (cfg.num_kv_heads, cfg.head_dim)

    def zeros(n):
        return torch.zeros(lead + (n,) + tail, dtype=dtype, device=device)

    return {"self": attn.KVCache(k=zeros(s_cache), v=zeros(s_cache)),
            "cross": attn.KVCache(k=zeros(cfg.encoder_seq),
                                  v=zeros(cfg.encoder_seq))}
