"""Minimal optimizers over trees of tensors.

Counterpart of ``repro/optim/optimizers.py``: the same (init, update)
pure-function convention, over a tree of nested dicts whose leaves are
tensors (the learners' flat dicts, a model's nested parameters), mapped
leaf by leaf as the reference's ``jax.tree.map``.  Moments are
``zeros_like`` the params, so bf16 params keep bf16 moments, as in the
reference.  The bias corrections are computed in float32 tensors, as the
reference computes them, not in Python floats: over hundreds of AdamW
steps the float64 path drifts away from the reference's trajectory.  The
update itself is float32 math for every leaf (the reference's promotion
of a bf16 moment against its float32 correction).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Tree = dict   # nested dicts with tensor leaves


class Optimizer(NamedTuple):
    init: Callable[[Tree], dict]
    update: Callable[[Tree, dict, Tree, int], tuple[Tree, dict]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result keeps the first
    tree's keys and order."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest))
                if isinstance(v, dict) else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    """The leaves in depth-first key order."""
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def _zeros(params: Tree) -> Tree:
    return tree_map(torch.zeros_like, params)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor of ``value`` on ``like``'s device, filled there
    (the float rounded to float32 as ``torch.tensor`` rounds it)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _lr_at(lr, step: int, like: torch.Tensor) -> torch.Tensor:
    value = lr(step) if callable(lr) else lr
    if isinstance(value, torch.Tensor):
        return value.to(dtype=torch.float32, device=like.device)
    return _scalar(float(value), like)


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def sgd(lr: float | Callable[[int], float], momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": _zeros(params)} if momentum else {}

    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step, tree_leaves(params)[0])
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            step_dir = (tree_map(lambda m, g: momentum * m + g, mu, grads)
                        if nesterov else mu)
            new_state = {"mu": mu}
        else:
            step_dir = grads
            new_state = {}
        new_params = tree_map(lambda p, d: p - lr_t * d.to(p.dtype), params,
                              step_dir)
        return new_params, new_state

    return Optimizer(init, update)


def adamw(lr: float | Callable[[int], float], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip_norm: float | None = None) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def update(grads, state, params, step):
        if grad_clip_norm is not None:
            grads = clip_by_global_norm(grads, grad_clip_norm)
        like = tree_leaves(params)[0]
        t = _scalar(float(step), like) + 1.0
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(m_.dtype),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.to(v_.dtype)),
                     state["v"], grads)
        lr_t = _lr_at(lr, step, like)
        bc1 = 1 - torch.pow(_scalar(b1, like), t)
        bc2 = 1 - torch.pow(_scalar(b2, like), t)

        def leaf(p, m_, v_):
            upd = ((m_.to(torch.float32) / bc1)
                   / (torch.sqrt(v_.to(torch.float32) / bc2) + eps))
            if weight_decay:
                upd = upd + weight_decay * p.to(upd.dtype)
            return (p.to(torch.float32) - lr_t * upd).to(p.dtype)

        return tree_map(leaf, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)
