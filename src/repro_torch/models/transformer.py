"""Decoder-only model assembly, the dense GQA path.

Counterpart of ``repro/models/transformer.py``.  Parameters keep the
reference's tree and leaf names, with every per-layer leaf stacked on a
leading layer axis as the reference's ``scan`` lays them out::

  {"embed": {"embedding": [V, d]},
   "layers": {"sub0": {"ln1": {"scale": [L, d]}, "attn": {"wq": [L, d, H*D],
              ...}, "ln2": ..., "mlp": ...}},
   "final_norm": {"scale": [d]}, ["lm_head": {"unembedding": [d, V]}]}

and the decode cache is ``{"sub0": KVCache(k=[L, B, S, KV, D], v=...)}``
(or a ``QuantKVCache`` with [L, B, S, KV] scales).  A plain loop over the
layers, each a view of the stacked tensors, replaces ``lax.scan``; there is
no sequence sharding.  ``cfg.remat == "block"`` recomputes each layer in
the backward pass (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` of its scan body.

Entry points, as in the reference:
  * ``forward(params, batch, cfg)``              -> logits, caches, aux
  * ``forward_train(params, batch, cfg)``        -> logits, aux (no caches)
  * ``hidden_states(params, x, cfg)``            -> final normed hidden
    states of embeddings x (no head; ``models/classifier.py``)
  * ``decode_step(params, caches, tokens, pos, cfg, cache_mode)``
                                                 -> logits, caches
  * ``init_params(cfg, gen)`` / ``init_cache(cfg, batch, s_cache)``

Only dense GQA architectures run (qwen3-0.6b, h2o-danube-3-4b, gemma-7b);
MoE, SSM, hybrid, MLA, the encoder-decoder and the modality frontends
raise ``NotImplementedError`` naming the slice they wait for.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed, lm_head, mlp_apply, mlp_init,
                                       normal_init, rmsnorm, rmsnorm_init,
                                       rope_tables, unembed)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what this slice of the port does not run."""
    missing = None
    if cfg.cross_attention:
        missing = "the encoder-decoder (whisper)"
    elif cfg.frontend is not None:
        missing = f"the {cfg.frontend} frontend"
    elif cfg.layer_pattern:
        missing = "hybrid SSM/attention stacks"
    elif cfg.arch_type == "ssm" or cfg.attention == "none":
        missing = "SSM (Mamba2) blocks"
    elif cfg.is_moe:
        missing = "MoE blocks"
    elif cfg.attention == "mla":
        missing = "multi-head latent attention (MLA)"
    elif cfg.attn_impl != "einsum":
        missing = f"attn_impl={cfg.attn_impl!r} (use_flash is the port's "
        missing += "path that keeps no [S, S] scores)"
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {missing} is not ported yet; the port runs dense "
            f"GQA models only (a later slice of the model zoo)")
    attn.check_flash(cfg)


# --------------------------------------------------------------- layers
def _layers(params: dict, n: int) -> list[dict]:
    """All n layers' params, views of the stacked leaves, each leaf unbound
    once: under autograd the n layers' gradients then go back into each
    stacked leaf in one stack, not through n full-size scatters of a
    select."""
    per_leaf = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in params.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _block_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor, rope):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    out, cache = attn.gqa_forward(p["attn"], h, cfg, positions, rope)
    x = x + out
    x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    return x, cache


def _block_train(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, rope) -> torch.Tensor:
    """One layer without its K/V (the training forward's unit)."""
    return _block_forward(p, x, cfg, positions, rope)[0]


def _block_decode(p: dict, x: torch.Tensor, cache, pos: int,
                  cfg: ArchConfig, cache_mode: str, rope):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    out, cache = attn.gqa_decode(p["attn"], h, cache, pos, cfg, cache_mode,
                                 rope)
    x = x + out
    x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    return x, cache


# --------------------------------------------------------------- model
def init_params(cfg: ArchConfig, gen: torch.Generator | None = None) -> dict:
    """Random parameters drawn from ``gen`` on its device (he init, the
    embeddings N(0, 0.02^2), norms 1), in ``cfg.dtype``.  ``gen`` None gives
    the same tree on the meta device: shapes without memory."""
    check_supported(cfg)
    dtype, device = _dtype(cfg), ("meta" if gen is None else gen.device)
    lead = (cfg.num_layers,)
    kw = dict(lead=lead, device=device)
    params = {
        "embed": {"embedding": normal_init(gen, (cfg.vocab_size, cfg.d_model),
                                           dtype, device=device)},
        "layers": {"sub0": {
            "ln1": rmsnorm_init(cfg.d_model, dtype, **kw),
            "attn": attn.gqa_init(gen, cfg, dtype, **kw),
            "ln2": rmsnorm_init(cfg.d_model, dtype, **kw),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, **kw)}},
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"unembedding": normal_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype, device=device)}
    return params


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return lm_head(params["lm_head"], x)


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings (the frontends' stub embeddings wait for a later
    slice)."""
    return embed(params["embed"], batch["tokens"], cfg.embed_scale)


def _stack(params: dict, x: torch.Tensor, cfg: ArchConfig,
           keep_caches: bool):
    """The layers over embeddings x [B, S, d]: (x, K/V of every layer or
    None)."""
    check_supported(cfg)
    if cfg.remat not in ("none", "block"):
        raise ValueError(f"remat must be 'none' or 'block', got "
                         f"{cfg.remat!r}")
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for layer in _layers(params["layers"]["sub0"], cfg.num_layers):
        if keep_caches:
            x, cache = _block_forward(layer, x, cfg, positions, rope)
            ks.append(cache.k)
            vs.append(cache.v)
        elif cfg.remat == "block" and torch.is_grad_enabled():
            x = checkpoint(_block_train, layer, x, cfg, positions, rope,
                           use_reentrant=False)
        else:
            x = _block_train(layer, x, cfg, positions, rope)
    caches = ({"sub0": attn.KVCache(k=torch.stack(ks), v=torch.stack(vs))}
              if keep_caches else None)
    return x, caches


def _run(params: dict, batch: dict, cfg: ArchConfig, keep_caches: bool):
    """Embed, the layers, the head: (logits, K/V of every layer or None)."""
    check_supported(cfg)
    x, caches = _stack(params, embed_inputs(params, batch, cfg), cfg,
                       keep_caches)
    return _logits(params, x, cfg), caches


def hidden_states(params: dict, x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """The final hidden states [B, S, d] of embeddings x: the layers and
    the final norm, no head (the classifier's and the neural backbone's
    forward; the reference's ``scan`` of ``_unit_forward``)."""
    x, _ = _stack(params, x, cfg, keep_caches=False)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params: dict, batch: dict, cfg: ArchConfig):
    """Full-sequence forward (prefill).  batch: {"tokens": [B, S]}.
    Returns (logits [B, S, V], caches, aux_loss = 0)."""
    logits, caches = _run(params, batch, cfg, keep_caches=True)
    return (logits, caches,
            torch.zeros((), dtype=torch.float32, device=logits.device))


def forward_train(params: dict, batch: dict, cfg: ArchConfig):
    """The training forward: (logits [B, S, V], aux_loss = 0).  The same
    computation as :func:`forward` without stacking every layer's K/V into
    a cache (a training step has no use for it), and each layer under
    ``torch.utils.checkpoint`` when ``cfg.remat == "block"``."""
    logits, _ = _run(params, batch, cfg, keep_caches=False)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def decode_step(params: dict, caches: dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, cache_mode: str = "full"):
    """One-token decode.  tokens [B, 1]; pos the absolute position (a host
    int).  Writes each layer's new K/V into ``caches`` in place; returns
    (logits [B, 1, V], caches)."""
    check_supported(cfg)
    attn.check_flash(cfg, cache_mode)
    pos = int(pos)
    x = embed(params["embed"], tokens, cfg.embed_scale)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    stacked = caches["sub0"]
    layers = _layers(params["layers"]["sub0"], cfg.num_layers)
    for i, layer in enumerate(layers):
        layer_cache = type(stacked)(*(a[i] for a in stacked))
        x, _ = _block_decode(layer, x, layer_cache, pos, cfg, cache_mode,
                             rope)
    return _logits(params, x, cfg), caches


def init_cache(cfg: ArchConfig, batch: int, s_cache: int,
               dtype: torch.dtype | None = None,
               device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """Zero-initialized decode cache in the stacked layout [L, B, S, ...]
    on ``device`` (the card unless the caller asks for the CPU); int8 with
    float32 scales when ``cfg.kv_quant``."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    shape = (cfg.num_layers, batch, s_cache, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        return {"sub0": attn.QuantKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device))}
    return {"sub0": attn.KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device))}


def cache_length(cfg: ArchConfig, seq_len: int) -> int:
    """Decode-cache length: the window when sliding-window attention is on
    and shorter than the sequence (a ring buffer), else the sequence."""
    if cfg.window is not None and cfg.window < seq_len:
        return cfg.window
    return seq_len


def count_params(params: dict) -> int:
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in params.values())
