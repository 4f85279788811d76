"""Learner interface: the model class F_0^(m) an agent brings to ASCII.

Counterpart of ``repro/learners/base.py``.  Every learner implements
weighted supervised training (Algorithm 2 / WST): ``fit(key, X, classes, w,
num_classes) -> params`` minimizing the w-weighted training loss, plus
``predict(params, X) -> class indices``.  Learners are stateless frozen
dataclasses; fitted params are dicts of tensors on the learner's
``device``.  The ``key`` argument keeps the reference's signature; where
the reference hands a learner its per-fit subkey, the port hands it the
fit's draws (:class:`~repro_torch.comm.draws.FitDraws`, from the session's
draw source).  The tree and logistic learners never read it; the MLP,
the forest and the neural backbone draw from it.

The reference's ``jitted_fresh_fit`` has no counterpart: PyTorch runs
eagerly, so ``fit`` calls ``core.fit(core.init(...))`` directly.
"""
from __future__ import annotations

import abc

import torch

from repro_torch.device import resolve_device

Params = dict[str, torch.Tensor]


class LearnerCore(abc.ABC):
    """Pure functional learner contract over fixed-shape params:

      * ``init(key, shapes) -> params``    -- fresh params for feature shape
        ``shapes`` (e.g. ``(p,)``);
      * ``fit(params, key, X, onehot, w) -> params`` -- Algorithm 2 / WST;
      * ``logits(params, X) -> [n, K]``    -- class scores;
      * ``predict(params, X) -> [n]``      -- argmax of ``logits``;
      * ``draw(key, shapes, n) -> dict``   -- a fit's draws, taken before a
        compiled session: ``{"init": params}``, and what else ``fit``
        reads from its ``key`` (the MLP's minibatch ``"rows"``).

    ``fit`` takes its gradients from ``torch.func.grad`` and reads no value
    back to the host, so that ``torch.func.vmap`` batches it over a fleet
    of sessions (``core.compiled``).
    """

    def draw(self, key, shapes: tuple[int, ...], n: int) -> dict:
        """The draws of one fit on n rows (``key``: the fit's draws)."""
        return {"init": self.init(key, shapes)}

    @abc.abstractmethod
    def init(self, key, shapes: tuple[int, ...]) -> Params:
        """Fresh fixed-shape params for feature shape ``shapes``."""

    @abc.abstractmethod
    def fit(self, params: Params, key, X: torch.Tensor, onehot: torch.Tensor,
            w: torch.Tensor) -> Params:
        """Weighted supervised training from ``params`` (Algorithm 2)."""

    @abc.abstractmethod
    def logits(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        """Class scores, shape [n, K]."""

    def predict(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits(params, X), dim=-1)


class Learner(abc.ABC):
    """A private model class F_0 held by a single agent.

    Subclasses are frozen dataclasses with a ``device`` field (default
    ``"cuda"``; :meth:`__post_init__` raises when no card is present) and a
    ``param_dtypes`` class attribute naming the dtype of each fitted
    parameter, which :func:`repro_torch.convert.params_from_numpy` applies.
    """

    device: str = "cuda"
    param_dtypes: dict[str, torch.dtype] = {}
    #: True when :meth:`core` returns a functional LearnerCore (the
    #: reference's adapter flag; the tree and the forest are eager-only).
    functional = False

    def __post_init__(self) -> None:
        resolve_device(self.device)

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    def _place(self, X) -> torch.Tensor:
        return torch.as_tensor(X, device=self.torch_device)

    @abc.abstractmethod
    def fit(self, key, X: torch.Tensor, classes: torch.Tensor,
            w: torch.Tensor, num_classes: int) -> Params:
        """Weighted supervised training (Algorithm 2, line 1)."""

    @abc.abstractmethod
    def predict(self, params: Params, X: torch.Tensor) -> torch.Tensor:
        """Hard class predictions, shape [n]."""

    def core(self, num_classes: int) -> LearnerCore | None:
        """The pure functional core of this learner, or None when the
        learner is eager-only (``functional = False``)."""
        return None

    def reward(self, params: Params, X: torch.Tensor,
               classes: torch.Tensor) -> torch.Tensor:
        """Prop. 1 reward r_i = I{g(x_i) = y_i} (Algorithm 2, line 2)."""
        return (self.predict(params, X) == classes).to(torch.float32)

