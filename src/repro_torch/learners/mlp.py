"""Weighted 3-layer neural network (the paper's Fashion-MNIST learner,
Section VI-B), fitted with AdamW on the w-weighted cross-entropy.

Counterpart of ``repro/learners/mlp.py``: a pure :class:`MLPCore` and the
eager :class:`MLP` over it.  The params keep the reference's structure, a
list of ``{"w": [d_in, d_out], "b": [d_out]}`` layers, float32.

The draws come from the fit's :class:`~repro_torch.comm.draws.FitDraws`:
layer i's init normals are ``normal(shape, i)`` (the reference's i-th split
of ``split(key)[1]``), and minibatch step i's rows are
``randint((batch_size,), n, i)`` (the reference's ``randint`` under
``fold_in(split(key)[0], i)``).  The init scale ``sqrt(2 / d_in)`` is
rounded to float32 before the square root, as the reference's
``jnp.sqrt(2.0 / d_in)`` rounds it.

The gradient comes from ``torch.func.grad`` (the reference's
``jax.grad``), so that ``torch.func.vmap`` batches the fit over a fleet of
sessions; :meth:`MLPCore.draw` takes a fit's draws before a compiled
session (the init and every minibatch's rows), which then hands them to
``fit`` through the ``key`` slot.

The reference jits the whole fit as one XLA program; here each step runs
op by op, and float32 sums in other orders differ at the last ulp, which
AdamW's normalized steps can amplify.  Run with TF32 off.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.comm.draws import fit_draws
from repro_torch.learners.base import Learner, LearnerCore
from repro_torch.optim.optimizers import adamw


def _init_mlp(draws, dims, device) -> list[dict]:
    params = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        scale = torch.sqrt(torch.tensor(2.0 / d_in, dtype=torch.float32))
        params.append({"w": draws.normal((d_in, d_out), i, device)
                       * scale.to(device),
                       "b": torch.zeros((d_out,), dtype=torch.float32,
                                        device=device)})
    return params


def forward(params: list[dict], X: torch.Tensor) -> torch.Tensor:
    h = X
    for layer in params[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    last = params[-1]
    return h @ last["w"] + last["b"]


def _weighted_ce(tree, X, onehot, w):
    """The loss of the layer tree (the layer list keyed by index)."""
    logits = forward(list(tree.values()), X)
    ll = torch.sum(onehot * logits, dim=-1) - torch.logsumexp(logits, dim=-1)
    return -torch.sum(w * ll) / torch.clamp(torch.sum(w), min=1e-12)


@dataclass(frozen=True)
class MLPCore(LearnerCore):
    num_classes: int
    hidden: tuple[int, ...] = (128, 64)
    steps: int = 400
    lr: float = 3e-3
    batch_size: int | None = None
    device: str = "cuda"

    def init(self, key, shapes):
        dims = (shapes[0],) + tuple(self.hidden) + (self.num_classes,)
        return _init_mlp(fit_draws(key), dims, self.device)

    def draw(self, key, shapes, n: int) -> dict:
        """A fit's draws, taken ahead: the init and, for minibatches, every
        step's rows [steps, batch_size] (``key``: the fit's draws)."""
        draws = fit_draws(key)
        out = {"init": self.init(draws, shapes)}
        bs = self.batch_size or n
        if bs < n:
            out["rows"] = torch.stack([draws.randint((bs,), n, i,
                                                     self.device)
                                       for i in range(self.steps)])
        return out

    def fit(self, params, key, X, onehot, w):
        draws = fit_draws(key)
        opt = adamw(self.lr)
        # the optimizer maps over dicts: the layer list keyed by index
        tree = {str(i): layer for i, layer in enumerate(params)}
        opt_state = opt.init(tree)
        n = X.shape[0]
        bs = self.batch_size or n
        grad_fn = torch.func.grad(_weighted_ce)
        for i in range(self.steps):
            if bs < n:
                idx = draws.randint((bs,), n, i, X.device)
                xb, ob, wb = X[idx], onehot[idx], w[idx]
            else:
                xb, ob, wb = X, onehot, w
            grads = grad_fn(tree, xb, ob, wb)
            with torch.no_grad():
                tree, opt_state = opt.update(grads, opt_state, tree, i)
        return list(tree.values())

    def logits(self, params, X):
        return forward(params, X)


@dataclass(frozen=True)
class MLP(Learner):
    hidden: tuple[int, ...] = (128, 64)   # 3 layers with the output layer
    steps: int = 400
    lr: float = 3e-3
    batch_size: int | None = None         # None: full batch
    device: str = "cuda"

    functional = True

    def core(self, num_classes: int) -> MLPCore:
        return MLPCore(num_classes, tuple(self.hidden), self.steps, self.lr,
                       self.batch_size, self.device)

    def fit(self, key, X, classes, w, num_classes):
        core = self.core(num_classes)
        draws = fit_draws(key)
        X, w = self._place(X), self._place(w)
        onehot = torch.nn.functional.one_hot(
            self._place(classes).long(), num_classes).to(torch.float32)
        return core.fit(core.init(draws, tuple(X.shape[1:])), draws, X,
                        onehot, w)

    def predict(self, params, X):
        return torch.argmax(forward(params, self._place(X)), dim=-1)
