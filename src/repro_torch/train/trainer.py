"""The training loop: the weighted train step (the WST engine for neural
ASCII agents and the standalone LM trainer), metrics and periodic
checkpoints.

Counterpart of ``repro/train/trainer.py``.  The step runs eagerly (the
reference jits it); the weighted-CE kernels carry its loss on the card.
Mesh shardings are not ported (ROADMAP Queue 1, multi-device): passing
``mesh`` or ``in_shardings`` raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train import checkpoint as ckpt_lib


@dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0                 # 0 = disabled
    ckpt_dir: str = ""                  # required when ckpt_every > 0


@dataclass
class Trainer:
    cfg: ArchConfig
    optimizer: Optimizer
    tcfg: TrainerConfig = field(default_factory=TrainerConfig)
    in_shardings: Any = None
    mesh: Any = None

    def __post_init__(self) -> None:
        if self.mesh is not None or self.in_shardings is not None:
            raise NotImplementedError(
                "Trainer: mesh shardings are not ported yet (ROADMAP "
                "Queue 1, multi-device); the port trains on one device")
        if self.tcfg.ckpt_every and not self.tcfg.ckpt_dir:
            raise ValueError("TrainerConfig.ckpt_every needs a ckpt_dir")

    def init(self, gen: torch.Generator):
        """Parameters drawn from ``gen`` on its device, and their optimizer
        state."""
        params = api.init_params(self.cfg, gen)
        return params, self.optimizer.init(params)

    def run(self, gen: torch.Generator, data: Iterator[dict],
            params: dict | None = None, opt_state: dict | None = None,
            on_metrics: Callable[[int, dict], None] | None = None):
        """``tcfg.steps`` train steps on batches from ``data``; logs (host
        floats, which wait for the device) every ``log_every`` steps and at
        the last, checkpoints every ``ckpt_every``.  Returns (params,
        opt_state, history)."""
        if params is None:
            params, opt_state = self.init(gen)
        step_fn = api.make_train_step(self.cfg, self.optimizer)
        history = []
        t0 = time.time()
        for step in range(self.tcfg.steps):
            batch = next(data)
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            if (step % self.tcfg.log_every == 0
                    or step == self.tcfg.steps - 1):
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, wall=time.time() - t0)
                history.append(m)
                if on_metrics:
                    on_metrics(step, m)
            if (self.tcfg.ckpt_every and step
                    and step % self.tcfg.ckpt_every == 0):
                ckpt_lib.save(self.tcfg.ckpt_dir, step,
                              {"params": params, "opt": opt_state})
        return params, opt_state, history
