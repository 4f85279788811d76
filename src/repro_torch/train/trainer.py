"""The training loop: the weighted train step (the WST engine for neural
ASCII agents and the standalone LM trainer), metrics and periodic
checkpoints.

Counterpart of ``repro/train/trainer.py``.  The step runs eagerly (the
reference jits it); the weighted-CE kernels carry its loss on the card.

``mesh`` (a :class:`repro_torch.sharding.context.Mesh`) makes the trainer
data parallel over the mesh's data axes (``rules.data_axes``): every rank
draws the same global batches, takes its rows of each (``rules
.batch_spec``; with m microbatches its rows of each of the m) and runs
the step under ``mesh_context``, where losses, router statistics and
gradients are all-reduced, so each step is the one-device step on the
global batch.  A batch whose size the data axes do not divide is
replicated, as its spec says: every rank runs the one-device step on all
of it.  A ``model`` axis above 1 makes the step tensor parallel as well
(``sharding/tp.py``; ``rules.use_tp`` configs): the ranks of a model
group take the same rows, each holding its shard of the parameters.  A
rank holds its parameters as ``rules.held_specs`` says (its model-axis
splits; under ``moe_impl="ep_a2a"`` its slice of the expert banks over
``data``: ``shard_params``; ``run(params=)`` takes them so); checkpoints
hold the full tree, gathered on every rank and written by rank 0.
``in_shardings`` (the batch's specs) is checked against ``batch_spec``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import api
from repro_torch.optim.optimizers import Optimizer
from repro_torch.sharding import ep, rules
from repro_torch.optim.optimizers import tree_map
from repro_torch.sharding.context import SubMesh, mesh_context
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
        if self.in_shardings is not None and self.mesh is None:
            raise ValueError("Trainer: in_shardings needs a mesh")
        if self.tcfg.ckpt_every and not self.tcfg.ckpt_dir:
            raise ValueError("TrainerConfig.ckpt_every needs a ckpt_dir")

    # ------------------------------------------------------ data parallel
    def _held(self):
        """``rules.held_specs`` on the mesh (made once): None where every
        rank holds every leaf whole."""
        if "_specs" not in self.__dict__:
            self._specs = None if self.mesh is None else rules.held_specs(
                self.cfg, self.mesh)
        return self._specs

    def shard_params(self, params: dict) -> dict:
        """This rank's parameters from full ones, each leaf cut to its
        ``rules.shard_index`` under ``rules.held_specs``."""
        specs = self._held()
        if specs is None:
            return params
        return tree_map(lambda leaf, spec: leaf[rules.shard_index(
            self.mesh, spec, tuple(leaf.shape), self.mesh)].contiguous(),
            params, specs)

    def gather_params(self, params: dict) -> dict:
        """The full parameters (or a tree like them) from every rank's
        ``shard_params``: each split leaf all-gathered over the axes of
        its spec.  Every rank calls it, and every rank gets the full
        tree."""
        specs = self._held()
        if specs is None:
            return params
        return tree_map(lambda leaf, spec: _gather(self.mesh, spec, leaf),
                        params, specs)

    def _rows(self, batch: dict) -> tuple[dict, bool]:
        """This rank's rows of the global ``batch`` and whether it was
        split: per ``batch_spec``, from each of the ``cfg.microbatches``
        microbatches in turn; a batch whose size the data axes do not
        divide stays whole on every rank, as the spec replicates it."""
        tokens = batch["tokens"]
        spec = rules.batch_spec(self.cfg, InputShape(
            "train", int(tokens.shape[1]), int(tokens.shape[0]), "train"),
            self.mesh)
        if self.in_shardings is not None and dict(self.in_shardings) != spec:
            raise ValueError(f"Trainer: in_shardings {self.in_shardings} "
                             f"are not the batch's specs {spec}")
        axes = rules.data_axes(self.mesh)
        if spec["tokens"][0] is None:
            ep.check_batch(self.cfg, self.mesh, int(tokens.shape[0]))
            return batch, False
        m = max(self.cfg.microbatches, 1)
        bsz = tokens.shape[0]
        parts = math.prod(self.mesh.shape[a] for a in axes)
        if bsz % (m * parts):
            raise ValueError(f"batch {bsz} does not split into {m} "
                             f"microbatches over {parts} data shards")
        rows = bsz // (m * parts)
        lo = self.mesh.coordinate(axes) * rows
        return {key: x.reshape((m, bsz // m) + tuple(x.shape[1:]))[
            :, lo:lo + rows].reshape((m * rows,) + tuple(x.shape[1:]))
            for key, x in batch.items()}, True

    def init(self, gen: torch.Generator):
        """Parameters drawn from ``gen`` on its device (this rank's shards
        of them under a mesh: the same draws on every rank), and their
        optimizer state."""
        params = self.shard_params(api.init_params(self.cfg, gen))
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
        tp = self.mesh is not None and rules.tp_on(self.cfg, self.mesh)
        if self.mesh is not None and not (rules.data_axes(self.mesh) or tp):
            raise ValueError(f"Trainer: the mesh {self.mesh.shape} has no "
                             f"data axis")
        step_fn = api.make_train_step(self.cfg, self.optimizer)
        history = []
        t0 = time.time()
        for step in range(self.tcfg.steps):
            batch, mesh = next(data), self.mesh
            if mesh is not None:
                batch, split = self._rows(batch)
                if not split:       # every data rank runs the whole batch
                    mesh = SubMesh(mesh, ("model",)) if tp else None
            with mesh_context(mesh):
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch, step)
            if (step % self.tcfg.log_every == 0
                    or step == self.tcfg.steps - 1):
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, wall=time.time() - t0)
                history.append(m)
                if on_metrics:
                    on_metrics(step, m)
            if (self.tcfg.ckpt_every and step
                    and step % self.tcfg.ckpt_every == 0):
                tree = {"params": self.gather_params(params),
                        "opt": {k: self.gather_params(v)
                                for k, v in opt_state.items()}}
                if self._writes():
                    ckpt_lib.save(self.tcfg.ckpt_dir, step, tree)
        return params, opt_state, history

    def _writes(self) -> bool:
        """Whether this rank writes checkpoints: rank 0 of a world, or
        the only process."""
        import torch.distributed as dist
        return self.mesh is None or not dist.is_initialized() \
            or dist.get_rank() == 0


def _gather(mesh, spec: tuple, leaf: torch.Tensor) -> torch.Tensor:
    """``leaf`` put back together from the ranks' shards under ``spec``:
    along each split dimension, the shards of the ranks along its axes
    (their group's ranks in coordinate order) concatenated."""
    import torch.distributed as dist
    for d, e in enumerate(spec):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        parts = math.prod(mesh.shape[a] for a in axes)
        if parts > 1:
            out = [torch.empty_like(leaf) for _ in range(parts)]
            dist.all_gather(out, leaf.contiguous(), group=mesh.group(axes))
            leaf = torch.cat(out, d)
    return leaf
