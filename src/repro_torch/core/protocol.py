"""ASCII protocol: Algorithm 1 (two-agent), its M-agent extension
(Section IV), and the baselines -- the back-compat front door.

Counterpart of ``repro/core/protocol.py``: ``fit`` maps the legacy
``ASCIIConfig`` (variant strings, cv_fraction, a raw ``TransportLog``) onto
the engine in :mod:`repro_torch.core.engine` on ``device``.  Variants:
``ascii`` (upstream side information, eqs. 11/13), ``simple`` (own-loss
alphas), ``random`` (random agent order each round) and ``async``
(stale-read rounds merged at a barrier).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.engine import (Component, FittedASCII,
                                     InProcessTransport, MeteredTransport,
                                     Protocol, SessionConfig, Transport,
                                     endpoints_for, holdout_split, key_data,
                                     variant_setup)
from repro_torch.core.transport import TransportLog
from repro_torch.learners.base import Learner

__all__ = ["ASCIIConfig", "Component", "FittedASCII", "EnsembleAdaBoost",
           "fit", "fit_single_agent_adaboost", "fit_ensemble_adaboost"]


@dataclass(frozen=True)
class ASCIIConfig:
    num_classes: int
    max_rounds: int = 20
    variant: str = "ascii"              # ascii | simple | random | async
    stop_on_negative_alpha: bool = True
    # the paper's second stop criterion (Section III-C): hold out a fraction
    # of the collated rows, stop when A's out-sample error stops improving
    # for `cv_patience` consecutive rounds; 0.0 disables
    cv_fraction: float = 0.0
    cv_patience: int = 2
    alpha_cap: float = 20.0
    exact_reweight: bool = False        # beyond-paper exact exp-loss reweight
    seed: int = 0

    def session_config(self, upstream: bool) -> SessionConfig:
        return SessionConfig(num_classes=self.num_classes,
                             max_rounds=self.max_rounds,
                             upstream=upstream,
                             stop_on_negative_alpha=self.stop_on_negative_alpha,
                             cv_patience=self.cv_patience,
                             alpha_cap=self.alpha_cap,
                             exact_reweight=self.exact_reweight)


def fit(key, Xs: Sequence[torch.Tensor], classes: torch.Tensor,
        learners: Sequence[Learner], cfg: ASCIIConfig,
        transport: TransportLog | Transport | None = None,
        device: str | torch.device = "cuda", draws=None) -> FittedASCII:
    """Run the ASCII training protocol (Algorithm 1 / Section IV) on
    ``device``.  Accepts a raw ``TransportLog`` (wrapped into a
    MeteredTransport) or any engine ``Transport``; ``draws`` is the
    session's draw source (``Protocol(draws=)``; default
    ``ChannelDraws``)."""
    if len(learners) != len(Xs):
        raise ValueError(f"{len(learners)} learners for {len(Xs)} blocks")
    validation = None
    if cfg.cv_fraction > 0.0:
        Xs, classes, Xs_val, c_val = holdout_split(Xs, classes,
                                                   cfg.cv_fraction)
        validation = (Xs_val, c_val)
    scheduler, upstream = variant_setup(cfg.variant, cfg.seed)
    if transport is None:
        engine_transport: Transport = InProcessTransport()
    elif isinstance(transport, TransportLog):
        engine_transport = MeteredTransport(log=transport)
    else:
        engine_transport = transport
    engine = Protocol(cfg.session_config(upstream), scheduler=scheduler,
                      transport=engine_transport, device=device, draws=draws)
    return engine.fit(key, endpoints_for(learners, Xs), classes,
                      validation=validation)


def fit_single_agent_adaboost(key, X: torch.Tensor, classes: torch.Tensor,
                              learner: Learner, cfg: ASCIIConfig,
                              device: str | torch.device = "cuda",
                              draws=None) -> FittedASCII:
    """SAMME on one agent's data: ASCII degenerates to multi-class AdaBoost
    when M = 1 (the paper's 'Single' baseline in Fig. 3)."""
    return fit(key, [X], classes, [learner], cfg, device=device, draws=draws)


def fit_ensemble_adaboost(key, Xs: Sequence[torch.Tensor],
                          classes: torch.Tensor,
                          learners: Sequence[Learner], cfg: ASCIIConfig,
                          device: str | torch.device = "cuda"
                          ) -> "EnsembleAdaBoost":
    """Method 3 (Ensemble-AdaBoost): no interchange; each agent runs its own
    AdaBoost and prediction is a majority vote across agents.  Member m's
    session key is the key data with m appended (the reference splits its
    key once a member), so random learners draw apart."""
    base = key_data(key)
    fitted = [fit_single_agent_adaboost(
                  np.append(base, np.uint32(m)).astype(np.uint32), X,
                  classes, learner, cfg, device=device)
              for m, (X, learner) in enumerate(zip(Xs, learners))]
    return EnsembleAdaBoost(fitted, cfg.num_classes)


@dataclass
class EnsembleAdaBoost:
    members: list[FittedASCII]
    num_classes: int

    def predict(self, Xs: Sequence[torch.Tensor],
                max_round: int | None = None) -> torch.Tensor:
        votes = [m.predict([X], max_round) for m, X in zip(self.members, Xs)]
        hist = sum(torch.nn.functional.one_hot(v.long(), self.num_classes)
                   for v in votes)
        return torch.argmax(hist, dim=-1)
