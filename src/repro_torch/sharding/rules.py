"""Sharding rules: parameter-path patterns -> partition specs, plus
shape-aware batch and cache specs.

Counterpart of ``repro/sharding/rules.py``, with its strategy and its
rule table:

  * params: Megatron-style tensor parallelism on the ``model`` axis
    (heads, d_ff, vocab); MoE expert banks sharded expert-dim over
    ``data`` and ff-dim over ``model``; SSM streams sharded on
    d_inner/heads.
  * batch: data parallel over ("pod", "data").
  * every rule is divisibility-guarded: a dimension that does not divide
    by the axis size is replicated.  Backbones with d_model < 1024
    (whisper-tiny, mamba2-130m) skip tensor parallelism.

A spec is a tuple with a ``PartitionSpec``'s entries, one a leading
dimension of the leaf: a mesh axis name, a tuple of names (a dimension
over ("pod", "data")), or None (replicated); ``tuple(P)`` of the
reference's spec equals it.  A mesh is anything with ``axis_names`` and
``shape[name]`` (:class:`~repro_torch.sharding.context.AbstractMesh`, or a
:class:`~repro_torch.sharding.context.Mesh`).  :func:`named` turns specs
into ``DTensor`` placements on a mesh.
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.configs.base import ArchConfig, InputShape

PyTree = Any


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_group(mesh):
    """The process group of ``mesh``'s data axes (a
    :class:`~repro_torch.sharding.context.Mesh`): the ranks a batch is
    split over.  None without a mesh or without data axes."""
    axes = data_axes(mesh) if mesh is not None else ()
    return mesh.group(axes) if axes else None


def tp_on(cfg: ArchConfig, mesh) -> bool:
    """Whether ``mesh`` runs ``cfg`` tensor parallel: a ``model`` axis
    above 1 and :func:`use_tp`."""
    return use_tp(cfg) and mesh.shape.get("model", 1) > 1


def held_specs(cfg: ArchConfig, mesh):
    """What a rank of ``mesh`` holds of each parameter in the port's
    step (:func:`param_specs` of the full shapes, in part): under tensor
    parallelism (:func:`tp_on`) every split over ``model``; under
    ``moe_impl="ep_a2a"`` every split (the expert banks' over ``data``
    too).  None when every leaf is whole on every rank."""
    ep = cfg.is_moe and cfg.moe_impl == "ep_a2a"
    if not (ep or tp_on(cfg, mesh)):
        return None
    from repro_torch.models import api
    specs = param_specs(api.init_params(cfg), cfg, mesh)
    if ep:
        return specs
    data = set(data_axes(mesh))

    def model_only(e):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        return _norm(tuple(a for a in axes if a not in data)) or None

    return _map_specs(lambda spec: tuple(map(model_only, spec)), specs)


def _map_specs(fn, tree):
    """``fn`` over the specs of a spec tree (dicts of specs)."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def spec_axes(spec: tuple) -> tuple[str, ...]:
    """The mesh axes ``spec`` splits a leaf over, in its order."""
    return tuple(a for e in spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e))


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    return math.prod(mesh.shape[a] for a in axes)


def _maybe(mesh, axes, dim: int):
    """axes if dim divides evenly, else None (replicate)."""
    return axes if dim % _axsize(mesh, axes) == 0 else None


def _norm(axes):
    """A spec entry as ``PartitionSpec`` keeps it: one axis in a tuple is
    that axis's name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def use_tp(cfg: ArchConfig) -> bool:
    return cfg.d_model >= 1024


# Rule table: (regex on 'a/b/c' path, fn(path, shape) -> trailing spec).
# The spec is right-aligned: leading (scan/stack) dims are replicated.
def _rules(cfg: ArchConfig, mesh):
    tp = "model" if use_tp(cfg) else None

    def last_dim(path, shape):       # shard the output features
        return (None,) * (len(shape) - 1) + (_maybe(mesh, tp, shape[-1]),)

    def attn_q(path, shape):         # shard on whole q-head boundaries
        ax = tp if cfg.num_heads % _axsize(mesh, tp) == 0 else None
        return (None,) * (len(shape) - 1) + (_maybe(mesh, ax, shape[-1]),)

    def attn_kv(path, shape):        # kv heads < tp: replicate (GQA-TP rule)
        ax = tp if cfg.num_kv_heads % _axsize(mesh, tp) == 0 else None
        return (None,) * (len(shape) - 1) + (_maybe(mesh, ax, shape[-1]),)

    def attn_o(path, shape):         # wo input dim follows the q sharding
        ax = tp if cfg.num_heads % _axsize(mesh, tp) == 0 else None
        if cfg.attention == "mla" and cfg.mla_rank_shard:
            # MLA: the wo input (H*dv) is a pure contraction dim, so the
            # head count need not divide the axis
            ax = tp
        return (None,) * (len(shape) - 2) + (_maybe(mesh, ax, shape[-2]),
                                             None)

    def mla_b(path, shape):
        # [r_lora, H*dims]: whole-head output sharding; when the head count
        # does not divide the axis and mla_rank_shard is set, the input rank
        if cfg.num_heads % _axsize(mesh, tp) == 0:
            return (None,) * (len(shape) - 1) + (_maybe(mesh, tp,
                                                        shape[-1]),)
        if cfg.mla_rank_shard:
            return (None,) * (len(shape) - 2) + (_maybe(mesh, tp,
                                                        shape[-2]), None)
        return (None,) * len(shape)

    def first_of_two(path, shape):   # shard the input features (2nd-last)
        return (None,) * (len(shape) - 2) + (_maybe(mesh, tp, shape[-2]),
                                             None)

    def expert_bank(path, shape):    # [E, d, f] or [E, f, d]
        e_want = (cfg.moe_expert_axis
                  if cfg.moe_expert_axis in mesh.axis_names else None)
        f_want = cfg.moe_ff_axis if cfg.moe_ff_axis in mesh.axis_names \
            else None
        e_ax = _maybe(mesh, e_want, shape[-3])
        f_dim = shape[-2] if path.endswith("wo") else shape[-1]
        f_ax = _maybe(mesh, f_want, f_dim)
        if f_ax == e_ax:
            f_ax = None                  # never reuse a mesh axis in one spec
        if path.endswith("wo"):
            return (None,) * (len(shape) - 3) + (e_ax, f_ax, None)
        return (None,) * (len(shape) - 3) + (e_ax, None, f_ax)

    def vocab_first(path, shape):    # embedding [V, d]
        return (None,) * (len(shape) - 2) + (_maybe(mesh, tp, shape[-2]),
                                             None)

    def replicate(path, shape):
        return (None,) * len(shape)

    return [
        (r"embed/embedding$", vocab_first),
        (r"lm_head/unembedding$", last_dim),
        (r"(attn|self_attn|cross_attn)/wq$", attn_q),
        (r"(attn|self_attn|cross_attn)/(wk|wv)$", attn_kv),
        (r"(attn|self_attn|cross_attn)/wo$", attn_o),
        (r"attn/(wq_b|wk_b|wv_b)$", mla_b),    # MLA latent projections
        (r"attn/(wq_a|wkv_a)$", replicate),
        (r"mlp/wi_(gate|up)$", last_dim),
        (r"mlp/wo$", first_of_two),
        (r"moe/router$", replicate),
        (r"moe/(wi_gate|wi_up|wo)$", expert_bank),
        (r"ssm/in_(z|x)$", last_dim),
        (r"ssm/in_dt$", last_dim),
        (r"ssm/in_(B|C)$", replicate),
        (r"ssm/conv_x(_bias)?$", last_dim),
        (r"ssm/(conv_[BC](_bias)?|A_log|D|dt_bias)$", replicate),
        (r"ssm/out_proj$", first_of_two),
        (r"ssm/norm/scale$", last_dim),
        (r".*", replicate),           # norms, biases, heads, projections
    ]


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, lists, tuples and
    NamedTuples; ``path`` holds dict keys, indices and field names."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def param_specs(params_shape: PyTree, cfg: ArchConfig, mesh) -> PyTree:
    """Spec tree for a parameter (or optimizer-state) tree: leaves with a
    ``shape`` (tensors, meta tensors, numpy arrays)."""
    rules = _rules(cfg, mesh)

    def spec_for(path, leaf):
        for pat, fn in rules:
            if re.search(pat, path):
                return tuple(_norm(e) for e in fn(path, tuple(leaf.shape)))
        raise AssertionError(path)

    return map_with_path(spec_for, params_shape)


# ------------------------------------------------------------- activations
def batch_spec(cfg: ArchConfig, shape: InputShape, mesh) -> dict:
    """Specs for the input batch dict (shape-aware)."""
    dp = data_axes(mesh)
    b_ax = _norm(_maybe(mesh, dp, shape.global_batch))
    specs = {"tokens": (b_ax, None)}
    if shape.kind == "train":
        specs["sample_weight"] = (b_ax,)
    if cfg.frontend == "vision":
        specs["patch_emb"] = (b_ax, None, None)
    if cfg.frontend == "audio":
        specs["frames"] = (b_ax, None, None)
    return specs


def cache_specs(cfg: ArchConfig, mesh, batch: int, s_cache: int):
    """A function from a decode cache tree (scanned [U, B, S, ...] layout)
    to its spec tree.  KV heads shard over ``model`` when divisible;
    otherwise the cache *length* shards over ``model`` (batch 1 also
    pushes the length onto the data axes)."""
    from repro_torch.models.attention import KVCache, QuantKVCache
    from repro_torch.models.ssm import SSMState

    dp = data_axes(mesh)
    tp = "model" if use_tp(cfg) else None
    b_ax = _norm(_maybe(mesh, dp, batch))
    if batch == 1:
        # batch unshardable: spread the cache length over every axis that
        # divides it (data + model)
        cand = dp + ((tp,) if tp else ())
        seq_long = tuple(a for a in cand if s_cache % mesh.shape[a] == 0)
        seq_long = _norm(seq_long) or None

    def kv_spec(leaf_ndim: int, kv_heads: int):
        # [U, B, S, KV, D] (gqa) or [U, B, S, R] (mla latents)
        if batch == 1:
            seq_ax = seq_long
        elif leaf_ndim == 5 and tp and _maybe(mesh, tp, kv_heads):
            return (None, b_ax, None, tp, None)    # heads shard cleanly
        else:
            seq_ax = _maybe(mesh, tp, s_cache)      # fall back: shard length
        if leaf_ndim == 5:
            return (None, b_ax, seq_ax, None, None)
        return (None, b_ax, seq_ax, None)

    def walk(node, key=None):
        if isinstance(node, QuantKVCache):
            base = kv_spec(5, cfg.num_kv_heads)
            scale = base[:-1]              # scales drop the head_dim axis
            return QuantKVCache(base, base, scale, scale)
        if isinstance(node, KVCache):
            if key == "cross":       # encoder memory: short, replicate S
                return KVCache((None, b_ax, None, None, None),
                               (None, b_ax, None, None, None))
            if cfg.attention == "mla":
                return KVCache(kv_spec(4, 0), kv_spec(4, 0))
            return KVCache(kv_spec(5, cfg.num_kv_heads),
                           kv_spec(5, cfg.num_kv_heads))
        if isinstance(node, SSMState):
            h_ax = _maybe(mesh, tp, cfg.ssm_heads)
            di_ax = _maybe(mesh, tp, cfg.d_inner)
            return SSMState(conv_x=(None, b_ax, None, di_ax),
                            conv_B=(None, b_ax, None, None),
                            conv_C=(None, b_ax, None, None),
                            ssm=(None, b_ax, h_ax, None, None))
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        raise TypeError(type(node))

    return walk


def cache_spec_tree(caches_shape: PyTree, cfg: ArchConfig, mesh,
                    batch: int, s_cache: int) -> PyTree:
    return cache_specs(cfg, mesh, batch, s_cache)(caches_shape)


def is_spec(x) -> bool:
    """A spec: a tuple of axis names, tuples of names and Nones (and not
    a NamedTuple of specs)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def placements(mesh, spec: tuple) -> tuple:
    """``spec`` as ``DTensor`` placements on ``mesh``, one a mesh axis:
    ``Shard(d)`` on each axis that tensor dimension d is split over (a
    dimension over two axes is ``Shard(d)`` on both, the major axis
    first, as JAX orders ("pod", "data")), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named(mesh, spec_tree: PyTree) -> PyTree:
    """Each spec of ``spec_tree`` as its ``DTensor`` placements on
    ``mesh`` (:func:`placements`)."""
    if is_spec(spec_tree):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    return type(spec_tree)(named(mesh, v) for v in spec_tree)


def shard_index(mesh, spec: tuple, shape: tuple, coord) -> tuple:
    """The slices of a leaf of ``shape`` that the rank at ``coord`` (a
    dict of axis -> index, or a :class:`~repro_torch.sharding.context.Mesh`
    for this rank) holds under ``spec``: along a dimension over several
    axes, the index flattened major first."""
    out = []
    for d, size in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        if e is None:
            out.append(slice(None))
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        parts = _axsize(mesh, axes)
        if size % parts:
            raise ValueError(f"dim {d} of {shape} does not split over "
                             f"{axes} ({parts})")
        if isinstance(coord, dict):
            idx = 0
            for a in axes:
                idx = idx * mesh.shape[a] + coord[a]
        else:
            idx = coord.coordinate(axes)
        step = size // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)
