"""Deployment-reality scenario knobs: who shows up, with what data, when.

Counterpart of ``repro/scenarios/scenario.py``.  A :class:`Scenario` is a
frozen, hashable bundle of deployment pathologies layered over any
protocol variant (ASCII, FedAvg, Assisted Learning) without touching the
round rules:

  * **subsample**: only a seeded fraction of the roster takes part in a
    round (FedAvg's C; the subsampled-RDP accountant's rate);
  * **straggle**: per-(round, agent) transient misses;
  * **dropout**: permanent churn, each round an agent survives with
    probability 1 - dropout;
  * **partition / skew**: non-IID horizontal shards
    (:mod:`repro_torch.data.partition`): each agent fits only on its
    shard's rows, while collation, rewards and prediction stay global;
  * **clock_skew**: agent m of the ASCII async barrier reads the broadcast
    of ``clock_skew[m]`` barriers ago.

The schedules are numpy, a pure function of (scenario, rounds, roster
size): the participation mask equals the reference's bit for bit, on
fresh runs, resumes and the one-program FedAvg alike.  The shard masks
are float32 tensors on the session's device.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.partition import (dirichlet_label_partition,
                                        quantity_partition)

PARTITIONS = ("iid", "dirichlet", "quantity")


@dataclass(frozen=True)
class Scenario:
    """One named bundle of deployment-reality knobs (see the module note).
    Frozen and hashable: it keys the cached schedules."""
    name: str = "clean"
    subsample: float | None = None      # fraction of roster per round
    dropout: float = 0.0                # per-round permanent-departure prob
    straggle: float = 0.0               # per-(round, agent) miss prob
    partition: str = "iid"              # iid | dirichlet | quantity
    skew: float = 0.5                   # dirichlet alpha / quantity exponent
    clock_skew: tuple = ()              # per-agent barrier lag (ASCII async)
    seed: int = 0

    def __post_init__(self):
        if self.subsample is not None and not (0.0 < self.subsample <= 1.0):
            raise ValueError(
                f"subsample must be in (0, 1], got {self.subsample}")
        if not (0.0 <= self.dropout < 1.0):
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")
        if not (0.0 <= self.straggle < 1.0):
            raise ValueError(
                f"straggle must be in [0, 1), got {self.straggle}")
        if self.partition not in PARTITIONS:
            raise ValueError(f"unknown partition {self.partition!r}; "
                             f"expected {PARTITIONS}")
        if any(int(s) < 0 for s in self.clock_skew):
            raise ValueError(f"clock_skew lags must be >= 0, "
                             f"got {self.clock_skew}")
        object.__setattr__(self, "clock_skew",
                           tuple(int(s) for s in self.clock_skew))

    @property
    def trivial(self) -> bool:
        """True when every knob is at its neutral value."""
        return (self.subsample is None and self.dropout == 0.0
                and self.straggle == 0.0 and self.partition == "iid"
                and not any(self.clock_skew))

    @property
    def has_churn(self) -> bool:
        return (self.subsample is not None or self.dropout > 0.0
                or self.straggle > 0.0)

    def validate(self, num_agents: int, scheduler, variant) -> None:
        """Reject incoherent combinations up front: a run that is empty
        every round, or a skew on a scheduler that cannot express it."""
        if self.subsample is not None \
                and int(round(self.subsample * num_agents)) < 1:
            raise ValueError(
                f"subsample={self.subsample} of {num_agents} agents rounds "
                f"to an empty round every round; raise subsample to at "
                f"least {0.5 / num_agents:.3f} or enlarge the roster")
        if any(self.clock_skew):
            if not getattr(scheduler, "stale", False):
                raise ValueError(
                    "clock_skew models agents reading stale barrier "
                    "broadcasts; it needs the async scheduler "
                    "(AsyncStaleScheduler / --variant async), not a "
                    "sequential chain where every hop is synchronous")
            if getattr(variant, "name", "ascii") != "ascii":
                raise ValueError(
                    "clock_skew is defined on the ASCII async barrier; "
                    f"protocol variant {getattr(variant, 'name', '?')!r} "
                    f"does not run one")
            if len(self.clock_skew) != num_agents:
                raise ValueError(
                    f"clock_skew names {len(self.clock_skew)} agents but "
                    f"the roster has {num_agents}")

    def participation(self, rounds: int, num_agents: int) -> np.ndarray:
        """The [rounds, num_agents] bool participation mask: dropout first
        (permanent), stragglers second (transient), subsampling last
        (among whoever is left)."""
        return _participation(self, int(rounds), int(num_agents)).copy()

    def shard_weights(self, classes, num_agents: int,
                      device=None) -> torch.Tensor | None:
        """[num_agents, n] float32 fit-weight masks of the non-IID
        partition on ``device`` (``classes``' device by default), or None
        under IID."""
        if self.partition == "iid":
            return None
        if device is None:
            device = (classes.device if isinstance(classes, torch.Tensor)
                      else "cpu")
        if isinstance(classes, torch.Tensor):
            classes = classes.detach().cpu().numpy()
        classes = np.asarray(classes)
        n = int(classes.shape[0])
        if self.partition == "dirichlet":
            shards = dirichlet_label_partition(self.seed, classes,
                                               num_agents, alpha=self.skew)
        else:
            shards = quantity_partition(self.seed, n, num_agents,
                                        skew=self.skew)
        masks = np.zeros((num_agents, n), np.float32)
        for m, idx in enumerate(shards):
            masks[m, idx] = 1.0
        return torch.from_numpy(masks).to(device)


@functools.lru_cache(maxsize=256)
def _participation(scenario: Scenario, rounds: int,
                   num_agents: int) -> np.ndarray:
    rng = np.random.default_rng(scenario.seed)
    mask = np.ones((rounds, num_agents), bool)
    # the draw order is fixed (dropout, straggle, subsample) whichever knobs
    # are on, so adding a knob never reshuffles another's draws
    if scenario.dropout > 0.0:
        # per-agent geometric departure round
        u = rng.random((rounds, num_agents))
        for m in range(num_agents):
            gone = np.flatnonzero(u[:, m] < scenario.dropout)
            if gone.size:
                mask[gone[0]:, m] = False
    if scenario.straggle > 0.0:
        mask &= rng.random((rounds, num_agents)) >= scenario.straggle
    if scenario.subsample is not None:
        want = max(1, int(round(scenario.subsample * num_agents)))
        for t in range(rounds):
            avail = np.flatnonzero(mask[t])
            if avail.size > want:
                keep = rng.choice(avail, size=want, replace=False)
                mask[t] = False
                mask[t, keep] = True
    mask.setflags(write=False)
    return mask


#: Named presets the CLI and chip_smoke share.
PRESETS = {
    "clean": Scenario("clean"),
    "noniid": Scenario("noniid", partition="dirichlet", skew=0.3, seed=1),
    "churn": Scenario("churn", straggle=0.25, dropout=0.05, seed=2),
    "subsample": Scenario("subsample", subsample=0.5, seed=3),
}
