"""Learning-rate schedules.

Counterpart of ``repro/optim/schedules.py``.  Each schedule maps a step (a
Python int, or a tensor) to a 0-d float32 tensor on the CPU, computed in
float32 as the reference computes it: AdamW amplifies an ulp of the rate
(ROADMAP Queue 3), so float64 Python arithmetic would drift from the
reference's trajectory.  The optimizers move the rate to the parameters'
device.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(device="cpu", dtype=torch.float32)


def _cos(x: torch.Tensor) -> torch.Tensor:
    """cos of a float32 angle, taken in float64 and rounded: the same bits
    on every device, and nearer the reference's float32 cos than a float32
    one."""
    return torch.cos(x.double()).float()


def constant(value: float) -> Schedule:
    return lambda step: torch.tensor(value, dtype=torch.float32)


def cosine_with_warmup(peak: float, warmup_steps: int, total_steps: int,
                       floor: float = 0.0) -> Schedule:
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + _cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def linear_decay(peak: float, warmup_steps: int,
                 total_steps: int) -> Schedule:
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(step < warmup_steps, warm, peak * (1.0 - prog))
    return fn
