"""Decoder-only model assembly: dense, MoE, SSM, hybrid and vision-language
stacks.

Counterpart of ``repro/models/transformer.py``.  Parameters keep the
reference's tree and leaf names.  The layers are ``U`` units of the
sub-layer kinds ``_block_kinds(cfg)`` (one "attn" or "ssm" sub-layer, or
Jamba's pattern of eight), every per-unit leaf stacked on a leading unit
axis as the reference's ``scan`` lays them out::

  {"embed": {"embedding": [V, d]},
   "layers": {"sub0": {"ln1": {"scale": [U, d]}, "attn" | "ssm": {...},
              ["ln2": ..., "mlp" | "moe": {...}]}, "sub1": ...},
   "final_norm": {"scale": [d]}, ["lm_head": {"unembedding": [d, V]}]}

A sub-layer is its mixer (GQA or MLA attention, or the Mamba2 SSD block)
followed by an MoE block, a gated MLP or nothing (``_ffn_kind``).  The
decode cache is ``{"sub<i>": leaf}`` with each leaf stacked over the
units: ``KVCache(k=[U, B, S, KV, D], v=...)`` (or a ``QuantKVCache``),
MLA's latent ``KVCache(k=[U, B, S, R], v=[U, B, S, Dr])`` or an
``SSMState`` ([U, B, conv-1, *] and a float32 [U, B, H, N, P]).  A plain
loop over the units, each a view of the stacked tensors, replaces
``lax.scan``.  ``cfg.remat == "block"`` recomputes
each unit in the backward pass (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` of its scan body.  The MoE blocks' aux
losses are summed over the sub-layers of a unit, then over the units.

Entry points, as in the reference:
  * ``forward(params, batch, cfg)``              -> logits, caches, aux
  * ``forward_train(params, batch, cfg)``        -> logits, aux (no caches)
  * ``hidden_states(params, x, cfg)``            -> final normed hidden
    states of embeddings x (no head; ``models/classifier.py``)
  * ``decode_step(params, caches, tokens, pos, cfg, cache_mode)``
                                                 -> logits, caches
  * ``init_params(cfg, gen)`` / ``init_cache(cfg, batch, s_cache)``

``batch["patch_emb"]`` [B, Timg, d] (the vision frontend's stub
embeddings) is prepended to the token embeddings.  What raises:
``use_flash`` where the kernels cannot serve (``attention.check_flash``).

Tensor parallelism: under :func:`~repro_torch.sharding.context.mesh_context`
with a ``model`` axis above 1 and ``rules.use_tp(cfg)``
(:func:`repro_torch.sharding.tp.active`), the params are this rank's
shards (``rules.held_specs``) and every step runs the rank's share of the
reference's sharded program: the vocab-parallel embedding (its rows of
the table, the ranks' lookups summed) and head (logits of its vocab
range, [B, S, V / tp]), column- and row-parallel attention, MLP, MoE and
SSM blocks (``models/attention.py``, ``layers.py``, ``moe.py``,
``ssm.py``).  With ``cfg.seq_parallel`` the residual stream between the
blocks is the rank's chunk of S, as the reference's ``_seq_shard``
constrains it, and skipped, as there, when ``model`` does not divide S.
Decode caches are laid out by ``rules.cache_specs`` (``init_cache`` under
the mesh gives this rank's shard; a cache split along its positions is
registered with ``tp.register_split``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (embed, lm_head, mlp_apply, mlp_init,
                                       normal_init, rmsnorm, rmsnorm_init,
                                       rope_tables, unembed)
from repro_torch.sharding import tp as tp_lib

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what the port does not run: unknown implementation
    switches, and ``use_flash`` where the kernels cannot serve."""
    if cfg.is_moe and cfg.moe_impl not in ("gmm", "dense", "ep_a2a"):
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}")
    if cfg.attn_impl not in ("einsum", "chunked"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    attn.check_flash(cfg)


# ------------------------------------------------------------ block defs
def _block_kinds(cfg: ArchConfig) -> tuple[str, ...]:
    """Sub-layer kinds of one unit."""
    if cfg.layer_pattern:
        return tuple(cfg.layer_pattern)
    if cfg.arch_type == "ssm":
        return ("ssm",)
    return ("attn",)


def _num_units(cfg: ArchConfig) -> int:
    return cfg.num_layers // len(_block_kinds(cfg))


def _ffn_kind(cfg: ArchConfig, sub_idx: int) -> str:
    """What follows the mixer in this sub-layer: moe | mlp | none."""
    if cfg.arch_type == "ssm":
        return "none"                       # pure mamba2: no FFN
    if cfg.is_moe:
        if cfg.moe_every <= 1 or sub_idx % cfg.moe_every == 1:
            return "moe"
        return "mlp"
    return "mlp"


def _init_sub_block(gen, cfg: ArchConfig, kind: str, sub_idx: int, dtype,
                    **kw) -> dict:
    p: dict = {"ln1": rmsnorm_init(cfg.d_model, dtype, **kw)}
    if kind == "attn":
        init = attn.mla_init if cfg.attention == "mla" else attn.gqa_init
        p["attn"] = init(gen, cfg, dtype, **kw)
    else:
        p["ssm"] = ssm_lib.ssm_init(gen, cfg, dtype, **kw)
    ffn = _ffn_kind(cfg, sub_idx)
    if ffn != "none":
        p["ln2"] = rmsnorm_init(cfg.d_model, dtype, **kw)
        if ffn == "moe":
            p["moe"] = moe_lib.moe_init(gen, cfg, dtype, **kw)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, **kw)
    return p


def _ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, sub_idx: int, tp=None,
         split: bool = False):
    """The sub-layer's feed-forward half: (x, aux)."""
    ffn = _ffn_kind(cfg, sub_idx)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, aux
    h = rmsnorm(tp_lib.norm_params(p["ln2"], tp, split), x, cfg.norm_eps)
    if ffn == "moe":
        y, aux = moe_lib.moe_apply(p["moe"], h, cfg, tp=tp, split=split)
        x = x + y
    else:
        whole = p["mlp"]["wi_gate"].shape[-1] == cfg.d_ff
        x = x + mlp_apply(p["mlp"], h, cfg.act, tp, split, whole)
    return x, aux


def _sub_block_forward(p: dict, x: torch.Tensor, cfg: ArchConfig, kind: str,
                       sub_idx: int, positions: torch.Tensor, rope, tp=None,
                       split: bool = False):
    """Full-sequence sub-layer: (x, cache leaf, aux); ``tp``, ``split``:
    this rank's share and whether x is its chunk of S."""
    h = rmsnorm(tp_lib.norm_params(p["ln1"], tp, split), x, cfg.norm_eps)
    if kind == "attn":
        fwd = attn.mla_forward if cfg.attention == "mla" else attn.gqa_forward
        out, cache = fwd(p["attn"], h, cfg, positions, rope, tp, split)
    else:
        out, cache = ssm_lib.ssm_forward(p["ssm"], h, cfg, tp, split)
    x, aux = _ffn(p, x + out, cfg, sub_idx, tp, split)
    return x, cache, aux


def _sub_block_decode(p: dict, x: torch.Tensor, cache, pos: int,
                      cfg: ArchConfig, kind: str, sub_idx: int,
                      cache_mode: str, rope, tp=None, seq=None):
    """One-token sub-layer: (x, cache leaf).  An attention leaf is written
    in place; an SSM state comes back new.  ``seq``: the attention cache's
    split along its positions (``tp.CacheSplit``)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "attn":
        dec = attn.mla_decode if cfg.attention == "mla" else attn.gqa_decode
        out, cache = dec(p["attn"], h, cache, pos, cfg, cache_mode, rope,
                         tp, seq)
    else:
        out, cache = ssm_lib.ssm_decode(p["ssm"], h, cache, cfg, tp)
    x, _ = _ffn(p, x + out, cfg, sub_idx, tp)
    return x, cache


# ------------------------------------------------------------- unit defs
def _layers(params: dict, n: int) -> list[dict]:
    """All n units' params, views of the stacked leaves, each leaf unbound
    once: under autograd the n units' gradients then go back into each
    stacked leaf in one stack, not through n full-size scatters of a
    select."""
    per_leaf = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in params.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _unit_forward(unit: dict, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, rope, tp=None,
                  split: bool = False):
    """One unit's sub-layers: (x, {"sub<i>": cache leaf}, aux)."""
    caches = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(_block_kinds(cfg)):
        x, caches[f"sub{i}"], aux = _sub_block_forward(
            unit[f"sub{i}"], x, cfg, kind, i, positions, rope, tp, split)
        aux_total = aux_total + aux
    return x, caches, aux_total


def _unit_train(unit: dict, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, rope, tp=None,
                split: bool = False):
    """One unit without its caches (the training forward's unit)."""
    x, _, aux = _unit_forward(unit, x, cfg, positions, rope, tp, split)
    return x, aux


def _rope(cfg: ArchConfig, positions: torch.Tensor):
    """The (cos, sin) tables of ``positions`` at the attention's rotary
    dim, computed once for all layers (None without attention)."""
    if "attn" not in _block_kinds(cfg):
        return None
    dim = (cfg.qk_rope_head_dim if cfg.attention == "mla"
           else cfg.head_dim)
    return rope_tables(positions, dim, cfg.rope_theta)


# --------------------------------------------------------------- model
def init_params(cfg: ArchConfig, gen: torch.Generator | None = None) -> dict:
    """Random parameters drawn from ``gen`` on its device (he init, the
    embeddings N(0, 0.02^2), norms 1; the SSM's float32 leaves as the
    reference makes them), in ``cfg.dtype``.  ``gen`` None gives the same
    tree on the meta device: shapes without memory."""
    check_supported(cfg)
    dtype, device = _dtype(cfg), ("meta" if gen is None else gen.device)
    kw = dict(lead=(_num_units(cfg),), device=device)
    params = {
        "embed": {"embedding": normal_init(gen, (cfg.vocab_size, cfg.d_model),
                                           dtype, device=device)},
        "layers": {f"sub{i}": _init_sub_block(gen, cfg, kind, i, dtype, **kw)
                   for i, kind in enumerate(_block_kinds(cfg))},
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"unembedding": normal_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype, device=device)}
    return params


def _head(params: dict) -> tuple[torch.Tensor, bool]:
    """The head's matrix and whether it is [V, d] (the tied embedding)."""
    if "lm_head" in params:
        return params["lm_head"]["unembedding"], False
    return params["embed"]["embedding"], True


def vocab_split(params: dict, cfg: ArchConfig, tp) -> bool:
    """Whether this rank's head holds a share of the vocab: its logits
    are then [..., V / tp], the columns [rank * V / tp, ...)."""
    w, tied = _head(params)
    return tp is not None and w.shape[0 if tied else 1] < cfg.vocab_size


def _logits(params: dict, x: torch.Tensor, cfg: ArchConfig, tp=None,
            split: bool = False) -> torch.Tensor:
    """The final norm and the head over x (this rank's chunk of S when
    ``split``): logits of every position, of the rank's vocab range under
    a vocab split."""
    x = rmsnorm(tp_lib.norm_params(params["final_norm"], tp, split), x,
                cfg.norm_eps)
    x = tp_lib.enter(x, tp, split, whole=not vocab_split(params, cfg, tp))
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return lm_head(params["lm_head"], x)


def _embed_tokens(params: dict, tokens: torch.Tensor, cfg: ArchConfig, tp,
                  split: bool) -> torch.Tensor:
    """The token embeddings (the rank's chunk of S when ``split``): the
    vocab-parallel lookup where the rank holds a share of the table."""
    table = params["embed"]["embedding"]
    if tp is None or table.shape[0] == cfg.vocab_size:
        x = embed(params["embed"], tokens, cfg.embed_scale)
        return tp_lib.split(x, tp) if split else x
    x = tp_lib.embed(table, tokens, tp, split)
    if cfg.embed_scale:   # as layers.embed: sqrt(d) in x's dtype
        x = x * float(torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype))
    return x


def embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings, with the vision frontend's stub embeddings
    ``batch["patch_emb"]`` prepended."""
    return _inputs(params, batch, cfg, None)[0]


def _inputs(params: dict, batch: dict, cfg: ArchConfig, tp):
    """The residual stream's input and whether it is this rank's chunk of
    S (sequence parallelism): the embeddings, the vision stub's
    prepended."""
    tokens = batch["tokens"]
    prefix = batch.get("patch_emb") if cfg.frontend == "vision" else None
    s = tokens.shape[1] + (0 if prefix is None else prefix.shape[1])
    split = tp_lib.seq_split(tp, s)
    if prefix is None:
        return _embed_tokens(params, tokens, cfg, tp, split), split
    x = _embed_tokens(params, tokens, cfg, tp, False)
    x = torch.cat([prefix.to(x.dtype), x], dim=1)
    return (tp_lib.split(x, tp) if split else x), split


def _stack(params: dict, x: torch.Tensor, cfg: ArchConfig,
           keep_caches: bool, tp=None, split: bool = False):
    """The units over embeddings x [B, S, d] (this rank's chunk of S when
    ``split``): (x, the caches stacked over the units or None, aux)."""
    if cfg.remat not in ("none", "block"):
        raise ValueError(f"remat must be 'none' or 'block', got "
                         f"{cfg.remat!r}")
    b, s, _ = x.shape
    s = s * tp.size if split else s
    positions = torch.arange(s, device=x.device).expand(b, s)
    rope = _rope(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_unit = []
    for unit in _layers(params["layers"], _num_units(cfg)):
        if keep_caches:
            x, caches, aux_u = _unit_forward(unit, x, cfg, positions, rope,
                                             tp, split)
            per_unit.append(caches)
        elif cfg.remat == "block" and torch.is_grad_enabled():
            x, aux_u = checkpoint(_unit_train, unit, x, cfg, positions, rope,
                                  tp, split, use_reentrant=False)
        else:
            x, aux_u = _unit_train(unit, x, cfg, positions, rope, tp, split)
        aux = aux + aux_u
    if not keep_caches:
        return x, None, aux
    stacked = {name: type(leaf)(*(torch.stack([c[name][j] for c in per_unit])
                                  for j in range(len(leaf))))
               for name, leaf in per_unit[0].items()}
    return x, stacked, aux


def hidden_states(params: dict, x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """The final hidden states [B, S, d] of embeddings x (the units and
    the final norm, no head): the classifier's and the neural backbone's
    forward, the reference's ``scan`` of ``_unit_forward``, whose aux loss
    it carries and drops."""
    check_supported(cfg)
    tp = tp_lib.active(cfg)
    split = tp_lib.seq_split(tp, x.shape[1])
    if split:
        x = tp_lib.split(x, tp)
    x, _, _ = _stack(params, x, cfg, False, tp, split)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return tp_lib.gather_seq(x, tp, partial_grad=False) if split else x


def forward(params: dict, batch: dict, cfg: ArchConfig):
    """Full-sequence forward (prefill).  batch: {"tokens": [B, S]} (+
    "patch_emb" [B, Timg, d] for the vision frontend).  Returns (logits
    [B, S_total, V], caches, aux_loss)."""
    check_supported(cfg)
    tp = tp_lib.active(cfg)
    x, split = _inputs(params, batch, cfg, tp)
    x, caches, aux = _stack(params, x, cfg, True, tp, split)
    return _logits(params, x, cfg, tp, split), caches, aux


def forward_train(params: dict, batch: dict, cfg: ArchConfig):
    """The training forward: (logits [B, S_total, V], aux_loss).  The same
    computation as :func:`forward` without stacking every unit's cache (a
    training step has no use for it), and each unit under
    ``torch.utils.checkpoint`` when ``cfg.remat == "block"``."""
    check_supported(cfg)
    tp = tp_lib.active(cfg)
    x, split = _inputs(params, batch, cfg, tp)
    x, _, aux = _stack(params, x, cfg, False, tp, split)
    return _logits(params, x, cfg, tp, split), aux


def decode_step(params: dict, caches: dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, cache_mode: str = "full"):
    """One-token decode.  tokens [B, 1]; pos the absolute position (a host
    int; frontend positions included).  Writes each unit's new cache
    entries into ``caches`` in place; returns (logits [B, 1, V],
    caches)."""
    check_supported(cfg)
    attn.check_flash(cfg, cache_mode)
    pos = int(pos)
    tp = tp_lib.active(cfg)
    x = _embed_tokens(params, tokens, cfg, tp, False)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    rope = _rope(cfg, positions)
    kinds = _block_kinds(cfg)
    splits = {i: tp_lib.split_of(caches[f"sub{i}"][0])
              for i in range(len(kinds))}
    for u, unit in enumerate(_layers(params["layers"], _num_units(cfg))):
        for i, kind in enumerate(kinds):
            stacked = caches[f"sub{i}"]
            view = type(stacked)(*(a[u] for a in stacked))
            x, new = _sub_block_decode(unit[f"sub{i}"], x, view, pos, cfg,
                                       kind, i, cache_mode, rope, tp,
                                       splits[i])
            if new is not view:              # an SSM state: copy it back
                for dst, src in zip(view, new):
                    dst.copy_(src)
    return _logits(params, x, cfg, tp), caches


def init_cache(cfg: ArchConfig, batch: int, s_cache: int,
               dtype: torch.dtype | None = None,
               device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """Zero-initialized decode cache in the stacked layout [U, B, ...] on
    ``device`` (the card unless the caller asks for the CPU): K/V (int8
    with float32 scales when ``cfg.kv_quant``), MLA's latents (never
    int8) or the SSM state (its ``ssm`` float32)."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    units = _num_units(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros((units, batch) + shape, dtype=dt, device=device)

    def leaf(kind):
        if kind == "attn" and cfg.attention == "mla":
            return attn.KVCache(k=zeros(s_cache, cfg.kv_lora_rank),
                                v=zeros(s_cache, cfg.qk_rope_head_dim))
        if kind == "attn":
            kv = (s_cache, cfg.num_kv_heads, cfg.head_dim)
            if cfg.kv_quant:
                return attn.QuantKVCache(
                    k=zeros(*kv, dt=torch.int8), v=zeros(*kv, dt=torch.int8),
                    k_scale=zeros(*kv[:-1], dt=torch.float32),
                    v_scale=zeros(*kv[:-1], dt=torch.float32))
            return attn.KVCache(k=zeros(*kv), v=zeros(*kv))
        conv = cfg.ssm_conv - 1
        return ssm_lib.SSMState(
            conv_x=zeros(conv, cfg.d_inner), conv_B=zeros(conv, cfg.ssm_state),
            conv_C=zeros(conv, cfg.ssm_state),
            ssm=zeros(cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim,
                      dt=torch.float32))

    return {f"sub{i}": leaf(kind) for i, kind in enumerate(_block_kinds(cfg))}


def cache_length(cfg: ArchConfig, seq_len: int) -> int:
    """Decode-cache length: the window when sliding-window attention is on
    and shorter than the sequence (a ring buffer), else the sequence."""
    if cfg.window is not None and cfg.window < seq_len:
        return cfg.window
    return seq_len


def count_params(params: dict) -> int:
    return sum(count_params(v) if isinstance(v, dict) else v.numel()
               for v in params.values())
