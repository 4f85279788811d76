"""Minimal optimizers over dicts of tensors.

Counterpart of ``repro/optim/optimizers.py``: the same (init, update)
pure-function convention, with fitted params held as dicts of tensors.  The
bias corrections are computed in float32 tensors, as the reference computes
them, not in Python floats: over hundreds of AdamW steps the float64 path
drifts away from the reference's trajectory.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

Params = dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params, int], tuple[Params, dict]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def _zeros(params: Params) -> Params:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _lr_at(lr, step: int, like: torch.Tensor) -> torch.Tensor:
    value = lr(step) if callable(lr) else lr
    return torch.as_tensor(value, dtype=torch.float32, device=like.device)


def global_norm(tree: Params) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def sgd(lr: float | Callable[[int], float], momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": _zeros(params)} if momentum else {}

    def update(grads, state, params, step):
        lr_t = _lr_at(lr, step, next(iter(params.values())))
        if momentum:
            mu = {k: momentum * state["mu"][k] + g for k, g in grads.items()}
            step_dir = ({k: momentum * mu[k] + g for k, g in grads.items()}
                        if nesterov else mu)
            new_state = {"mu": mu}
        else:
            step_dir = grads
            new_state = {}
        new_params = {k: p - lr_t * step_dir[k].to(p.dtype)
                      for k, p in params.items()}
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
        like = next(iter(params.values()))
        t = torch.tensor(float(step), dtype=torch.float32,
                         device=like.device) + 1.0
        m = {k: b1 * state["m"][k] + (1 - b1) * g.to(state["m"][k].dtype)
             for k, g in grads.items()}
        v = {k: b2 * state["v"][k]
             + (1 - b2) * torch.square(g.to(state["v"][k].dtype))
             for k, g in grads.items()}
        lr_t = _lr_at(lr, step, like)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=like.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=like.device), t)
        new_params = {}
        for k, p in params.items():
            upd = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.to(upd.dtype)
            new_params[k] = (p.to(torch.float32) - lr_t * upd).to(p.dtype)
        return new_params, {"m": m, "v": v}

    return Optimizer(init, update)
