"""The kernel wrappers' shared host path: where a tensor lies, the current
card and stream, the launch status.

A wrapper runs on every hop or layer, and at the main path's sizes its host
time is larger than its kernel's device time, so these read PyTorch's state
the way its own launchers do and build no Python object on the way.
"""
from __future__ import annotations

import contextlib

import torch


def on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    return True


def current(device: torch.device):
    """A context in which ``device`` is the current card; none when it
    already is, which saves the switch's host time on every call."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raw_stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, read as PyTorch's own
    launchers read it: without building a ``torch.cuda.Stream`` object for
    its ``cuda_stream`` on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check_status(fn: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{fn} launch failed with cudaError_t {status}")
