"""Model API of the port over all ten architectures: the serve half and the
training half.

Counterpart of ``repro/models/api.py``: init, forward, one decode step,
the decode cache, the prefill/serve step functions the serving CLI runs,
the ignorance-weighted next-token loss and the train step the trainer
runs, each dispatched to ``models/encdec.py`` for the encoder-decoder
(``cfg.cross_attention``) and to ``models/transformer.py`` for the rest.

The loss runs through ``ops.weighted_ce`` (the CUDA forward and backward
kernels on the card, their plain versions on the CPU), where the
reference's ``weighted_next_token_loss`` is an einsum; the two compute the
same function.  The kernel is handed the whole [B, S, V] logits as B * S
rows, with weight 0 wherever a position predicts nothing (each sequence's
last position and, for a vision model, its image prefix): the weighted sum
is the reference's, no copy of the logits is made, and the backward kernel
writes the whole ``dlogits`` with no scatter into a [:, :-1] slice.

Tensor parallelism (a ``model`` axis above 1 in the mesh of
:func:`~repro_torch.sharding.context.mesh_context`, ``sharding/tp.py``):
the params are this rank's shards (``rules.held_specs``), the logits of a
vocab-split head this rank's columns, and the loss the vocab-parallel CE
(``tp.weighted_ce``: the CE kernels' shard modes, the ranks' (lse, gold)
combined), the same on every rank of a model group.  The prefill and
serve steps return whole logits (the ranks' columns gathered).  Under a
mesh (tensor parallel or not) :func:`init_cache` takes the global batch
and returns this rank's shard of the cache (``rules.cache_specs``), and
:func:`pad_prefill_cache` cuts the prefill's caches to it.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.kernels import ops
from repro_torch.models import encdec, transformer
from repro_torch.models.attention import KVCache, QuantKVCache, quantize_kv
from repro_torch.models.ssm import SSMState
from repro_torch.optim.optimizers import Optimizer, tree_leaves, tree_map
from repro_torch.sharding import tp as tp_lib


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.cross_attention


def _model(cfg: ArchConfig):
    return encdec if is_encdec(cfg) else transformer


def init_params(cfg: ArchConfig, gen: torch.Generator | None = None) -> dict:
    return _model(cfg).init_params(cfg, gen)


def forward(params: dict, batch: dict, cfg: ArchConfig):
    return _model(cfg).forward(params, batch, cfg)


def forward_train(params: dict, batch: dict, cfg: ArchConfig):
    return _model(cfg).forward_train(params, batch, cfg)


def decode_step(params: dict, caches: dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, cache_mode: str = "full"):
    return _model(cfg).decode_step(params, caches, tokens, pos, cfg,
                                   cache_mode)


def _world_mesh():
    """The mesh of :func:`~repro_torch.sharding.context.mesh_context` when
    it is over a world (has process groups), else None."""
    from repro_torch.sharding.context import current_mesh
    mesh = current_mesh()
    return mesh if hasattr(mesh, "group") else None


def init_cache(cfg: ArchConfig, batch: int, s_cache: int,
               dtype: torch.dtype | None = None,
               device: torch.device | str = DEFAULT_DEVICE) -> dict:
    """The zero decode cache; under a mesh this rank's shard of the cache
    of the global ``batch`` (``rules.cache_specs``), a split along the
    positions registered (``tp.register_split``)."""
    mesh = _world_mesh()
    if mesh is None:
        return _model(cfg).init_cache(cfg, batch, s_cache, dtype, device)
    from repro_torch.sharding import rules
    whole = _model(cfg).init_cache(cfg, batch, s_cache, dtype, "meta")
    specs = rules.cache_specs(cfg, mesh, batch, s_cache)(whole)

    def zeros(a: torch.Tensor, spec: tuple) -> torch.Tensor:
        shape = [n // rules._axsize(mesh, e) for n, e in zip(a.shape, spec)]
        return torch.zeros(shape, dtype=a.dtype, device=device)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        out = type(node)(*(zeros(a, sp) for a, sp in zip(node, spec)))
        _register(out, spec[0], mesh)
        return out

    return walk(whole, specs)


def _register(leaf, spec: tuple, mesh) -> None:
    """Register a cache leaf whose positions (axis 2 of the stacked
    layout) ``spec`` splits: this rank's chunk of them."""
    axes = spec[2]
    if axes is None:
        return
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    parts = math.prod(mesh.shape[a] for a in axes)
    s0 = mesh.coordinate(axes) * leaf[0].shape[2]
    tp_lib.register_split(leaf[0], tp_lib.CacheSplit(
        axes, mesh.group(axes), parts, s0))


def cache_length(cfg: ArchConfig, seq_len: int) -> int:
    return transformer.cache_length(cfg, seq_len)


def count_params(params: dict) -> int:
    return transformer.count_params(params)


def _walk(caches: dict, kv, quant, key=None):
    """The cache tree with each KVCache leaf under ``key`` mapped by
    ``kv(leaf, key)`` and each QuantKVCache by ``quant``; SSM states pass
    through.  A new leaf keeps the old one's split along the positions
    (``tp.split_of``): it holds the same positions."""
    if isinstance(caches, (KVCache, QuantKVCache)):
        out = (quant(caches) if isinstance(caches, QuantKVCache)
               else kv(caches, key))
        split = tp_lib.split_of(caches[0])
        if split is not None and tp_lib.split_of(out[0]) is None:
            tp_lib.register_split(out[0], split)
        return out
    if isinstance(caches, SSMState):
        return caches
    if isinstance(caches, dict):
        return {k: _walk(v, kv, quant, k) for k, v in caches.items()}
    raise TypeError(type(caches))


def pad_prefill_cache(caches: dict, cfg: ArchConfig, s_cache: int,
                      batch: int | None = None) -> dict:
    """Grow the prefill caches (length = prompt) to decode capacity: K/V
    leaves (and MLA's latents) are zero-padded along the sequence axis
    (axis 2 of the stacked [U, B, S, ...] layout); SSM states are O(1) and
    the encoder-decoder's cross K/V is encoder-length, so both pass
    through.  Under a mesh a leaf that ``rules.cache_specs`` splits along
    its positions is cut to this rank's chunk (and registered); ``batch``
    is the global batch (default: the local one times the data axes'
    size)."""
    def pad_axis2(a: torch.Tensor) -> torch.Tensor:
        if a.shape[2] >= s_cache:
            return a
        widths = [0, 0] * (a.dim() - 3) + [0, s_cache - a.shape[2]]
        return F.pad(a, widths)

    def kv(leaf, key):
        return leaf if key == "cross" else KVCache(*map(pad_axis2, leaf))

    padded = _walk(caches, kv,
                   lambda leaf: QuantKVCache(*map(pad_axis2, leaf)))
    mesh = _world_mesh()
    if mesh is None:
        return padded
    from repro_torch.sharding import rules
    if batch is None:
        b = next(iter(padded.values()))[0].shape[1]
        batch = b * math.prod(mesh.shape[a] for a in rules.data_axes(mesh))
    specs = rules.cache_specs(cfg, mesh, batch, s_cache)(padded)

    def cut(node, spec):
        if isinstance(node, dict):
            return {k: cut(v, spec[k]) for k, v in node.items()}
        if isinstance(node, SSMState) or spec[0][2] is None:
            return node
        mine = rules.shard_index(mesh, (spec[0][2],), (s_cache,), mesh)[0]
        out = type(node)(*(a[:, :, mine].contiguous() for a in node))
        _register(out, spec[0], mesh)
        return out

    return cut(padded, specs)


def quantize_cache(caches: dict, cfg: ArchConfig) -> dict:
    """Convert a prefill cache tree's K/V to int8 (the kv_quant serving
    path).  MLA's latents (already rank-compressed), the cross K/V and
    SSM states are kept as they are, as in the reference."""
    def kv(leaf, key):
        if key == "cross" or cfg.attention == "mla":
            return leaf
        kq, ks = quantize_kv(leaf.k)
        vq, vs = quantize_kv(leaf.v)
        return QuantKVCache(kq, vq, ks, vs)

    return _walk(caches, kv, lambda leaf: leaf)


# -------------------------------------------------------------------- loss
def next_token_rows(logits: torch.Tensor, batch: dict, cfg: ArchConfig):
    """The rows the loss hands the weighted-CE kernel: ``(rows [B * S, V],
    labels [B * S] int32, weights [B * S] float32)``.  ``rows`` is a view
    of the logits; position s of sequence b predicts ``tokens[b, s + 1]``
    with weight ``sample_weight[b] * loss_mask[b, s + 1]``; every other
    position (the last, and a vision model's image prefix) has weight 0
    and label 0."""
    tokens = batch["tokens"]
    b, s_tok = tokens.shape
    v = logits.shape[-1]
    prefix = 0
    if cfg.frontend == "vision" and "patch_emb" in batch:
        prefix = batch["patch_emb"].shape[1]
    if tuple(logits.shape[:2]) != (b, prefix + s_tok):
        raise ValueError(f"logits {tuple(logits.shape)} do not match tokens "
                         f"{tuple(tokens.shape)} (+ {prefix} image "
                         f"positions)")
    dev = logits.device
    labels = torch.zeros((b, prefix + s_tok), dtype=torch.int32, device=dev)
    labels[:, prefix:-1] = tokens[:, 1:]
    w_tok = batch.get("loss_mask")
    w_tok = (torch.ones((b, s_tok - 1), dtype=torch.float32, device=dev)
             if w_tok is None else w_tok[:, 1:].to(torch.float32))
    w = batch.get("sample_weight")
    if w is not None:
        w_tok = w.to(torch.float32)[:, None] * w_tok
    weights = torch.zeros((b, prefix + s_tok), dtype=torch.float32,
                          device=dev)
    weights[:, prefix:-1] = w_tok
    return logits.reshape(-1, v), labels.reshape(-1), weights.reshape(-1)


def weighted_next_token_loss(logits: torch.Tensor, batch: dict,
                             cfg: ArchConfig) -> torch.Tensor:
    """Ignorance-weighted next-token cross-entropy, a float32 scalar.

    ``batch['sample_weight']`` [B] is the ASCII ignorance score w_t of each
    collated sample (sequence), uniform when absent; ``batch['loss_mask']``
    [B, S] masks target tokens.  For VLM archs the frontend positions carry
    no loss.  Returns ``sum(nll * w) / max(sum(w), 1e-9)``; under a mesh
    with data axes (:func:`~repro_torch.sharding.context.mesh_context`)
    the batch is this rank's shard and ``sum(w)`` the global batch's
    (all-reduced, no gradient), so the ranks' losses sum to the global
    one."""
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import current_mesh
    rows, labels, weights = next_token_rows(logits, batch, cfg)
    tp = tp_lib.active(cfg)
    if tp is not None and logits.shape[-1] < cfg.vocab_size:
        nll = tp_lib.weighted_ce(rows, labels, weights, tp)
    else:
        nll = ops.weighted_ce(rows, labels, weights)
    total = torch.sum(weights)
    group = rules.data_group(current_mesh())
    if group is not None:
        total = tp_lib.all_reduce_(total.detach().reshape(1), group)[0]
    return torch.sum(nll) / torch.clamp(total, min=1e-9)


# ---------------------------------------------------------- step functions
def loss_and_grads(params: dict, batch: dict, cfg: ArchConfig,
                   retain_graph: bool = False):
    """One forward and backward of the loss (the weighted next-token loss,
    plus ``router_aux_coef * aux`` for an MoE config, as the reference's
    train step): ``(loss, grads, aux, logits, leaves)``.  ``grads`` is a
    tree like ``params``; ``leaves`` are the detached parameter leaves the
    graph was built on, in ``tree_leaves`` order, and ``logits`` the
    graph's output, so a caller that keeps the graph
    (``retain_graph=True``) can take other gradients of the same
    forward.  Under a mesh with data axes (n ranks) the batch is this
    rank's shard; the MoE layers' aux is the same on the ranks of a data
    group (``models/moe.py``), and this rank's share of it, aux / n,
    enters its loss: loss, aux and gradients are this rank's shares,
    which sum over the data axes to the global batch's."""
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import current_mesh
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    logits, aux = forward_train(tracked, batch, cfg)
    mesh = current_mesh()
    if rules.data_group(mesh) is not None:
        aux = aux / math.prod(mesh.shape[a] for a in rules.data_axes(mesh))
    loss = weighted_next_token_loss(logits, batch, cfg)
    if cfg.is_moe:
        loss = loss + cfg.router_aux_coef * aux
    grads = torch.autograd.grad(loss, leaves, retain_graph=retain_graph)
    it = iter(grads)
    return (loss, tree_map(lambda _: next(it), params), aux.detach(), logits,
            leaves)


def make_train_step(cfg: ArchConfig, optimizer: Optimizer) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    Gradients by ``loss_and_grads``; with ``cfg.microbatches`` m > 1 the
    batch is split in m along axis 0, the gradients are summed and divided
    by m, and loss and aux are averaged, as the reference's ``scan`` does.  Returns new parameter and state
    trees; the metrics are 0-d float32 tensors on the device.

    Under a mesh with data axes
    (:func:`~repro_torch.sharding.context.mesh_context`) the step is data
    parallel: ``batch`` is this rank's shard (with m microbatches, its
    shard of each of the global batch's m, in order), ``params`` this
    rank's parameters (``rules.held_specs``: under ep_a2a its slice of
    the expert banks).  Each gradient is summed with ``all_reduce`` over
    the data axes its leaf is not split over (a leaf split over all of
    them is this rank's own), and loss and aux over all of them, so every
    rank takes the one-device step on the global batch."""
    if cfg.use_flash:
        raise NotImplementedError(
            "make_train_step with use_flash: the flash kernels have no "
            "backward kernel (nor does the reference's Pallas kernel); "
            "training runs the einsum attention, use_flash=False")
    transformer.check_supported(cfg)
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import current_mesh
    held = [None, None]          # the mesh and its held_specs

    def grads_of(params, mb):
        loss, grads, aux = loss_and_grads(params, mb, cfg)[:3]
        return grads, loss.detach(), aux

    def train_step(params, opt_state, batch, step):
        m = cfg.microbatches
        if m <= 1:
            grads, loss, aux = grads_of(params, batch)
        else:
            bsz = batch["tokens"].shape[0]
            if bsz % m:
                raise ValueError(f"batch {bsz} does not split into "
                                 f"{m} microbatches")
            grads, loss, aux = None, 0.0, 0.0
            for i in range(m):
                mb = {k: x.reshape((m, bsz // m) + tuple(x.shape[1:]))[i]
                      for k, x in batch.items()}
                g, l_, a = grads_of(params, mb)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                loss, aux = loss + l_, aux + a
            grads = tree_map(lambda g: g / m, grads)
            loss, aux = loss / m, aux / m
        mesh = current_mesh()
        if rules.data_group(mesh) is not None:
            if held[0] is not mesh:
                held[:] = [mesh, rules.held_specs(cfg, mesh)]
            grads, loss, aux = _all_reduce_step(grads, loss, aux, mesh,
                                                held[1])
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 step)
        return params, opt_state, {"loss": loss, "aux_loss": aux}

    return train_step


def _all_reduce_step(grads: dict, loss, aux, mesh, specs):
    """The ranks' shares summed: each gradient leaf over the data axes
    its ``specs`` entry does not split it over (every data axis where
    ``specs`` is None), loss and aux in one all-reduce over all of
    them."""
    from repro_torch.sharding import rules
    axes = rules.data_axes(mesh)

    def reduce(g, spec=()):
        rest = tuple(a for a in axes if a not in rules.spec_axes(spec))
        if rest:
            g = tp_lib.all_reduce_(g.contiguous(), mesh.group(rest))
        return g
    grads = (tree_map(reduce, grads) if specs is None
             else tree_map(reduce, grads, specs))
    metrics = torch.stack([torch.as_tensor(loss, dtype=torch.float32),
                           torch.as_tensor(aux, dtype=torch.float32)]).to(
        tree_leaves(grads)[0].device)
    tp_lib.all_reduce_(metrics, rules.data_group(mesh))
    return grads, metrics[0], metrics[1]


def _whole_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Logits of the whole vocab: a vocab-split head's columns gathered
    from the ranks."""
    tp = tp_lib.active(cfg)
    if tp is None or logits.shape[-1] == cfg.vocab_size:
        return logits
    return tp_lib.gather(logits, tp, -1)


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch):
        logits, caches, _ = forward(params, batch, cfg)
        return _whole_vocab(logits[:, -1:, :], cfg), caches
    return prefill_step


def make_serve_step(cfg: ArchConfig, cache_mode: str = "full") -> Callable:
    """One decode step: greedy next token given the running cache (which it
    updates in place)."""

    def serve_step(params, caches, tokens, pos):
        logits, caches = decode_step(params, caches, tokens, pos, cfg,
                                     cache_mode)
        logits = _whole_vocab(logits, cfg)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, caches

    return serve_step
