"""Weighted multinomial logistic regression, fitted with full-batch AdamW.

Counterpart of ``repro/learners/logistic.py``: zero init, ``steps``
full-batch AdamW steps on the w-weighted cross-entropy, with the gradient
from ``torch.func.grad`` (the reference's ``jax.grad``), so that
``torch.func.vmap`` batches the fit over a fleet of sessions
(``core.compiled.fleet_run``).  The eager learner calls the same core.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.learners.base import Learner, LearnerCore
from repro_torch.optim.optimizers import adamw


def _weighted_ce(params, X, onehot, w, l2):
    logits = X @ params["w"] + params["b"]
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.sum(onehot * logits, dim=-1) - logz
    reg = l2 * torch.sum(torch.square(params["w"]))
    return -torch.sum(w * ll) / torch.clamp(torch.sum(w), min=1e-12) + reg


@dataclass(frozen=True)
class LogisticCore(LearnerCore):
    num_classes: int
    steps: int = 300
    lr: float = 0.1
    l2: float = 1e-4
    device: str = "cuda"

    def init(self, key, shapes):
        del key  # deterministic init (zeros)
        (p,) = shapes
        return {"w": torch.zeros((p, self.num_classes), dtype=torch.float32,
                                 device=self.device),
                "b": torch.zeros((self.num_classes,), dtype=torch.float32,
                                 device=self.device)}

    def fit(self, params, key, X, onehot, w):
        del key  # full-batch fit is deterministic
        opt = adamw(self.lr)
        opt_state = opt.init(params)
        grad_fn = torch.func.grad(_weighted_ce)
        for i in range(self.steps):
            grads = grad_fn(params, X, onehot, w, self.l2)
            with torch.no_grad():
                params, opt_state = opt.update(grads, opt_state, params, i)
        return params

    def logits(self, params, X):
        return X @ params["w"] + params["b"]


@dataclass(frozen=True)
class LogisticRegression(Learner):
    steps: int = 300
    lr: float = 0.1
    l2: float = 1e-4
    device: str = "cuda"

    param_dtypes = {"w": torch.float32, "b": torch.float32}
    functional = True

    def core(self, num_classes: int) -> LogisticCore:
        return LogisticCore(num_classes, self.steps, self.lr, self.l2,
                            self.device)

    def fit(self, key, X, classes, w, num_classes):
        core = self.core(num_classes)
        X, w = self._place(X), self._place(w)
        onehot = torch.nn.functional.one_hot(
            self._place(classes).long(), num_classes).to(torch.float32)
        return core.fit(core.init(key, tuple(X.shape[1:])), key, X, onehot, w)

    def predict(self, params, X):
        X = self._place(X)
        return torch.argmax(X @ params["w"] + params["b"], dim=-1)
