"""End-to-end LM training CLI with the ignorance-weighted (WST) loss, on
the card by default.

Counterpart of ``repro/launch/train.py``, with its flags (``--arch --preset
--reduced --steps --batch --seq --lr --ckpt_dir``), its ``100m`` preset,
its schedule (``cosine_with_warmup(lr, max(steps // 20, 5), steps)``) and
optimizer (``adamw(sched, weight_decay=0.01, grad_clip_norm=1.0)``), and
its printed lines.  The port adds ``--device`` (default ``cuda``, which
raises without a card) and ``--seed``:

  # the 100m preset (87.5 M params), a few hundred steps on token streams:
  PYTHONPATH=src python -m repro_torch.launch.train --preset 100m --steps 300

  # qwen3-0.6b at full width on the card (the reference CLI's default arch):
  PYTHONPATH=src python -m repro_torch.launch.train --steps 20

  # any architecture at reduced (smoke) size on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch jamba-v0.1-52b --reduced --steps 20 --batch 4 --seq 128

Weights are drawn from a ``torch.Generator`` seeded with ``--seed`` on the
run's device, batches from one seeded with ``--seed + 1`` on the host, so
the numbers differ from the reference CLI's.  A frontend's stub inputs
(internvl2's ``patch_emb``, prepended to the ``--seq`` text tokens, and
whisper's ``frames``) come with every batch from a generator seeded with
``--seed + 2`` on the run's device: the reference CLI feeds tokens alone,
which its encoder-decoder cannot train on.  An MoE's logged loss includes
``router_aux_coef * aux``, as the reference's step.  Besides the
reference's lines it prints the step time (median after the first step;
each step timed up to a device synchronize), tokens/s at that time, and
the peak device memory (on the card).
"""
from __future__ import annotations

import argparse
import statistics
import time
from dataclasses import dataclass
from typing import Iterator

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import lm_batches, with_frontend
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine_with_warmup
from repro_torch.train.trainer import Trainer, TrainerConfig

PRESETS = {
    # 87,507,968 params: train a ~100M model for a few hundred steps
    "100m": ArchConfig(
        name="lm-100m", arch_type="dense", num_layers=10, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32000, qk_norm=True, act="silu", dtype="float32"),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS),
                    help="assigned architecture id (default qwen3-0.6b)")
    ap.add_argument("--preset", default=None, choices=list(PRESETS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt_dir", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


@dataclass
class TrainRun:
    cfg: ArchConfig
    params: dict
    history: list               # the trainer's logged metrics
    step_s: list                # every step's seconds, device-synchronized
    peak_bytes: int | None      # peak device memory (None on the CPU)
    lines: list


def config_of(args: argparse.Namespace) -> ArchConfig:
    if args.preset:
        return PRESETS[args.preset]
    cfg = ARCHS[args.arch or "qwen3-0.6b"]
    return cfg.reduced() if args.reduced else cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _StepClock:
    """The batch iterator, timed: each ``next`` first waits for the device,
    so the times between calls (and to :meth:`stop`) are the steps'."""

    def __init__(self, data: Iterator[dict], device: torch.device) -> None:
        self.data, self.device, self.marks = data, device, []

    def __next__(self) -> dict:
        self.stop()
        return next(self.data)

    def stop(self) -> None:
        _sync(self.device)
        self.marks.append(time.perf_counter())

    def step_seconds(self) -> list:
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def run(args: argparse.Namespace) -> TrainRun:
    """Train ``--steps`` steps; returns the run's config, final params,
    history, step times and printed lines."""
    device = resolve_device(args.device)
    cfg = config_of(args)
    sched = cosine_with_warmup(args.lr, max(args.steps // 20, 5), args.steps)
    opt = adamw(sched, weight_decay=0.01, grad_clip_norm=1.0)
    trainer = Trainer(cfg, opt, TrainerConfig(
        steps=args.steps, log_every=max(args.steps // 20, 1),
        ckpt_every=(args.steps // 2 if args.ckpt_dir else 0),
        ckpt_dir=args.ckpt_dir))
    data = with_frontend(
        lm_batches(torch.Generator().manual_seed(args.seed + 1),
                   vocab_size=cfg.vocab_size, batch=args.batch,
                   seq_len=args.seq, device=device),
        cfg, torch.Generator(device=device).manual_seed(args.seed + 2))
    lines = []

    def say(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params, opt_state = trainer.init(
        torch.Generator(device=device).manual_seed(args.seed))
    say(f"arch={cfg.name} params={api.count_params(params):,} "
        f"steps={args.steps} batch={args.batch} seq={args.seq}")

    def log(step, m):
        say(f"step {step:5d}  loss {m['loss']:.4f}  wall {m['wall']:.1f}s")

    clock = _StepClock(data, device)
    params, _, history = trainer.run(None, clock, params, opt_state,
                                     on_metrics=log)
    clock.stop()
    first, last = history[0]["loss"], history[-1]["loss"]
    say(f"loss: {first:.4f} -> {last:.4f} "
        f"({'improved' if last < first else 'NOT improved'})")
    step_s = clock.step_seconds()
    median = statistics.median(step_s[1:] or step_s)
    say(f"step time: {median * 1e3:.2f} ms (median after the first step; "
        f"first {step_s[0] * 1e3:.1f} ms) on {device}")
    say(f"tokens/s: {args.batch * args.seq / median:.1f}")
    peak = None
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        say(f"peak device memory: {peak / 2 ** 30:.3f} GiB")
    return TrainRun(cfg, params, history, step_s, peak, lines)


def main(argv: list | None = None) -> TrainRun:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
