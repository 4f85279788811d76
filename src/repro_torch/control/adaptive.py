"""Signal-adaptive codec controllers: pick the wire codec's rung per hop
(training) or per score block (serving) from the signal.

Counterpart of ``repro/control/adaptive.py``, whose docstring derives the
policy.  :class:`AdaptiveController` observes one statistic of the hop in
[0, 1] (``"resid"``: the total variation between the outgoing vector and
the receiver's; ``"entropy"``: H(w)/log n; ``"l2"``: the participation
ratio 1/(n·Σp²)), smooths it with an EMA that starts at 1.0, and counts
the descending thresholds the EMA lies below: that count is the ladder
rung (0 the finest codec).  :class:`ServeController` does the same,
without an EMA, for a prediction-time [n, K] block (``"margin"``: 1 minus
the mean top-2 gap of the row-normalized block; ``"entropy"``: the mean
row entropy over log K).

The reference runs both policies through a cached jit
(``jitted_controller``), so its statistics are float32 sums in XLA's
order.  Here each statistic is taken in float64 and rounded to float32
once, as the port already takes alpha and the hop's exponential
(``core/scores.py``): a float32 sum's rounding depends on its order,
which differs between the card's and the CPU's libraries, and an EMA one
ulp off a threshold picks another rung.  Rounded from float64, the card
and the CPU choose the same rungs, within float32 rounding of the
reference's statistic.  The EMA step is float32 arithmetic on the host,
rounded where the reference's compiled ``b * ema + (1 - b) * s`` rounds
(:func:`ema_step`).

Under a bit budget the rung is a floor on the ladder walk
(``BudgetSpec.choose(..., floor=rung)``): the budget may degrade further,
never finer.  The EMA is protocol state: it lives on the transport
(``Transport.ctrl_state``) and crosses a checkpoint in
``SessionState.comm``.

The compiled session (``core.compiled``) runs the same step as tensors
on the device, with no read to the host: :meth:`AdaptiveController.
step_tensor` (:func:`controller_rung`, the reference's name) takes the
statistic in float64 on the device and rounds it, :func:`ema_step_tensor`
rounds where :func:`ema_step` does, and the rung is the count of float32
cuts the EMA lies below, so both backends pick the same rungs bit for
bit.  The compiled serve step takes a block's rung from
:meth:`ServeController.rung_tensor`, which the eager
:meth:`ServeController.rung_for` reads back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.comm.budget import DEFAULT_LADDER
from repro_torch.comm.codecs import Codec

STATS = ("resid", "entropy", "l2")

#: Per-statistic default thresholds for the 4-rung ladder (descending).
DEFAULT_THRESHOLDS = {
    "resid": (0.75, 0.3, 0.03),
    "entropy": (0.99, 0.85, 0.7),
    "l2": (0.99, 0.85, 0.7),
}

SERVE_STATS = ("margin", "entropy")

DEFAULT_SERVE_THRESHOLDS = {
    "margin": (0.8, 0.5, 0.2),
    "entropy": (0.9, 0.6, 0.3),
}

_F64 = torch.float64


def _check_ladder(ladder, thresholds, default: tuple, what: str) -> tuple:
    """Validate a ladder and its cuts (the reference's rules); returns the
    cuts, the defaults when ``thresholds`` is None."""
    if not ladder:
        raise ValueError(f"{what} ladder must hold at least one codec")
    for c in ladder:
        if not isinstance(c, Codec) or c.stateful:
            raise ValueError(f"{what} ladder entries must be stateless "
                             f"Codecs, got {c!r}")
    cuts = tuple(default[:len(ladder) - 1] if thresholds is None
                 else thresholds)
    if len(cuts) != len(ladder) - 1:
        raise ValueError(
            f"need len(ladder) - 1 = {len(ladder) - 1} thresholds (one per "
            f"rung boundary), got {len(cuts)}")
    if list(cuts) != sorted(cuts, reverse=True):
        raise ValueError(f"thresholds must descend (rung 0 is the best "
                         f"codec), got {cuts}")
    return cuts


def ema_step(beta, prev, x) -> np.float32:
    """``beta * prev + (1 - beta) * x`` in float32 as the reference's
    compiled step computes it: ``(1 - beta) * x`` rounded, then the
    product ``beta * prev`` added with one rounding (its compiler
    contracts the two into a fused multiply-add; the float32 product is
    exact in float64)."""
    b = np.float32(beta)
    tail = np.float32((np.float32(1.0) - b) * np.float32(x))
    return np.float32(np.float64(b) * np.float64(np.float32(prev))
                      + np.float64(tail))


def ema_step_tensor(beta, prev: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """:func:`ema_step` on 0-d float32 tensors, on their device: the same
    roundings (``(1 - beta) * x`` in float32, then the exact float32
    product ``beta * prev`` added in float64 and rounded once).  ``beta``
    is a number, or a 0-d float32 tensor (a control sweep's, one a session
    under vmap), which gives the number's bits."""
    if isinstance(beta, torch.Tensor):
        b64 = beta.to(torch.float64)
        tail = x * (1.0 - beta)                 # both rounded in float32
    else:
        b = np.float32(beta)
        b64 = float(b)
        tail = x * float(np.float32(np.float32(1.0) - b))
    return (prev.to(torch.float64) * b64
            + tail.to(torch.float64)).to(torch.float32)


def rung_tensor(value: torch.Tensor, cuts) -> torch.Tensor:
    """:func:`_rung` as a 0-d int64 tensor on ``value``'s device: how many
    float32 cuts the float32 ``value`` lies below, each a strict ``<``.
    ``cuts`` is a tuple of numbers, or a float32 tensor [R - 1] (a control
    sweep's, one row a session under vmap)."""
    if isinstance(cuts, torch.Tensor):
        return (value < cuts).to(torch.int64).sum()
    rung = torch.zeros((), dtype=torch.int64, device=value.device)
    for c in cuts:
        rung = rung + (value < float(np.float32(c))).to(torch.int64)
    return rung


def _rung(value: np.float32, cuts: tuple) -> int:
    """How many cuts (as float32) the float32 ``value`` lies below."""
    return int(sum(value < np.float32(c) for c in cuts))


def _normalized(x: torch.Tensor) -> torch.Tensor:
    x = x.to(_F64)
    return x / torch.clamp(torch.sum(x), min=1e-12)


@dataclass(frozen=True)
class AdaptiveController:
    """Per-hop codec-rung policy over a degradation ladder (stateless
    codecs, finest first); ``thresholds`` one descending cut per rung
    boundary (None: the ``stat``'s defaults), ``beta`` the EMA smoothing."""
    ladder: tuple = DEFAULT_LADDER
    thresholds: tuple | None = None
    beta: float = 0.5
    stat: str = "resid"

    def __post_init__(self):
        if self.stat not in STATS:
            raise ValueError(f"unknown stat {self.stat!r}; expected {STATS}")
        cuts = _check_ladder(self.ladder, self.thresholds,
                             DEFAULT_THRESHOLDS[self.stat], "controller")
        object.__setattr__(self, "thresholds", cuts)
        if not 0.0 <= self.beta < 1.0:
            raise ValueError(f"need 0 <= beta < 1, got {self.beta}")

    def init_state(self) -> np.float32:
        """Fresh EMA: 1.0, a maximal signal until the channel shows
        otherwise (what front-loads precision)."""
        return np.float32(1.0)

    def observe(self, w_prev: torch.Tensor, w_out: torch.Tensor) -> np.float32:
        """The raw per-hop statistic in [0, 1], taken in float64 and
        rounded to float32.  ``w_out`` is the outgoing vector, ``w_prev``
        the one the receiver holds (only ``"resid"`` reads it)."""
        return np.float32(float(self.observe_tensor(w_prev, w_out)))

    def observe_tensor(self, w_prev: torch.Tensor,
                       w_out: torch.Tensor) -> torch.Tensor:
        """:meth:`observe` as a 0-d float32 tensor on the vectors' device,
        read by no host."""
        n = int(w_out.shape[0])
        p = _normalized(w_out)
        if self.stat == "resid":
            s = 0.5 * torch.sum(torch.abs(p - _normalized(w_prev)))
        elif self.stat == "entropy":
            h = -torch.sum(torch.where(
                p > 0, p * torch.log(torch.clamp(p, min=1e-30)),
                torch.zeros((), dtype=_F64, device=p.device)))
            s = h / math.log(max(n, 2))
        else:
            s = 1.0 / (n * torch.clamp(torch.sum(p * p), min=1e-12))
        return s.to(torch.float32)

    def step(self, w_prev: torch.Tensor, w_out: torch.Tensor,
             ema) -> tuple[int, np.float32]:
        """Observe, smooth, pick: ``(rung, new_ema)``."""
        s = self.observe(w_prev, w_out)
        ema = ema_step(self.beta, ema, s)
        return _rung(ema, self.thresholds), ema

    def step_tensor(self, w_prev: torch.Tensor, w_out: torch.Tensor,
                    ema: torch.Tensor, cuts=None,
                    beta=None) -> tuple[torch.Tensor, torch.Tensor]:
        """:meth:`step` as tensors on the device: ``(rung int64, new_ema
        float32)``, both 0-d, the bits :meth:`step` gives.  ``cuts`` [R - 1]
        and ``beta`` (float32 tensors) override ``thresholds`` and
        ``beta``: a control sweep's operands
        (``core.compiled.control_sweep_run``)."""
        ema = ema_step_tensor(self.beta if beta is None else beta, ema,
                              self.observe_tensor(w_prev, w_out))
        return rung_tensor(ema, self.thresholds if cuts is None
                           else cuts), ema


def controller_rung(controller: AdaptiveController, w_prev: torch.Tensor,
                    w_out: torch.Tensor, ema: torch.Tensor):
    """The reference's functional entry point: one controller step as
    tensors (:meth:`AdaptiveController.step_tensor`)."""
    return controller.step_tensor(w_prev, w_out, ema)


@dataclass(frozen=True)
class ServeController:
    """Per-block codec-rung policy for prediction-time score blocks:
    stateless, one uncertainty statistic of the raw (pre-noise) block
    through descending thresholds."""
    ladder: tuple = DEFAULT_LADDER
    thresholds: tuple | None = None
    stat: str = "margin"

    def __post_init__(self):
        if self.stat not in SERVE_STATS:
            raise ValueError(f"unknown serve stat {self.stat!r}; expected "
                             f"{SERVE_STATS}")
        cuts = _check_ladder(self.ladder, self.thresholds,
                             DEFAULT_SERVE_THRESHOLDS[self.stat],
                             "serve-controller")
        object.__setattr__(self, "thresholds", cuts)

    def observe(self, block: torch.Tensor) -> np.float32:
        """The block's uncertainty statistic in [0, 1], taken in float64
        and rounded to float32 (:meth:`observe_tensor`, read back)."""
        return np.float32(float(self.observe_tensor(block)))

    def observe_tensor(self, block: torch.Tensor) -> torch.Tensor:
        """:meth:`observe` as a 0-d float32 tensor on the block's device,
        read by no host: each row shifted to nonnegative and normalized,
        then 1 - the mean top-2 gap or the mean entropy over log K, in
        float64, rounded once."""
        k = int(block.shape[-1])
        b = block.to(_F64)
        b = b - torch.min(b, dim=-1, keepdim=True).values
        p = b / torch.clamp(torch.sum(b, dim=-1, keepdim=True), min=1e-12)
        if self.stat == "margin":
            if k > 1:
                top2 = torch.topk(p, 2, dim=-1).values
                gap = top2[..., 0] - top2[..., 1]
            else:
                gap = torch.ones(p.shape[:-1], dtype=_F64, device=p.device)
            return (1.0 - torch.mean(gap)).to(torch.float32)
        h = -torch.sum(torch.where(
            p > 0, p * torch.log(torch.clamp(p, min=1e-30)),
            torch.zeros((), dtype=_F64, device=p.device)), dim=-1)
        return (torch.mean(h) / math.log(max(k, 2))).to(torch.float32)

    def rung_tensor(self, block: torch.Tensor) -> torch.Tensor:
        """:meth:`rung_for` as a 0-d int64 tensor on the block's device
        (the compiled serve step's rung, the reference's
        ``jitted_serve_controller``)."""
        return rung_tensor(self.observe_tensor(block), self.thresholds)

    def rung_for(self, block: torch.Tensor) -> int:
        """The ladder rung for one outgoing block: :meth:`rung_tensor`
        read back, so the eager and the compiled serve choose the same
        rung by construction."""
        return int(self.rung_tensor(block))
