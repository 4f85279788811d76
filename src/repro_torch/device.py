"""Device resolution shared by the port's entry points.

Entry points default to ``"cuda"`` and raise when no card is present; they
never drop to the CPU on their own.  Callers that want the CPU (the tests)
pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``, raising when it names CUDA and no card is
    visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
