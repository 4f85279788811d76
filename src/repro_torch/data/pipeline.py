"""Host-side input pipeline: deterministic shuffled batching with epoch
reshuffling, and the synthetic LM batches of the training CLI.

Counterpart of ``repro/data/pipeline.py``.  ``batched_indices`` is numpy
and copied as it is, so its batches equal the reference's index for index;
``lm_batches`` draws from a ``torch.Generator`` (so its tokens differ from
the reference's threefry draws) and yields batches on the run's device.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.data.synthetic import token_stream
from repro_torch.device import resolve_device


def batched_indices(n: int, batch_size: int, seed: int,
                    drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """Infinite shuffled index batches (reshuffled each epoch)."""
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        end = (n // batch_size) * batch_size if drop_remainder else n
        for i in range(0, end, batch_size):
            yield perm[i:i + batch_size]


def lm_batches(gen: torch.Generator, *, vocab_size: int, batch: int,
               seq_len: int, copy_prob: float = 0.35,
               device: str | torch.device = "cuda") -> Iterator[dict]:
    """Infinite synthetic LM batches ``{"tokens" [B, S] int32,
    "sample_weight" [B] float32 (uniform)}`` on ``device``, the tokens
    drawn from ``gen`` (see ``synthetic.token_stream``)."""
    dev = resolve_device(device)
    while True:
        tokens = token_stream(gen, vocab_size=vocab_size, batch=batch,
                              seq_len=seq_len, copy_prob=copy_prob,
                              device=dev)
        yield {"tokens": tokens,
               "sample_weight": torch.ones((batch,), dtype=torch.float32,
                                           device=dev)}


def frontend_inputs(cfg, batch: int, gen: torch.Generator) -> dict:
    """The modality frontends' stub inputs, standard normal in
    ``cfg.dtype`` on ``gen``'s device: ``patch_emb`` [B,
    num_frontend_tokens, d] (vision) or ``frames`` [B, encoder_seq, d]
    (audio); nothing for a text-only arch.  The reference's serve CLI
    draws them from a key of their own."""
    shape = {"vision": ("patch_emb", cfg.num_frontend_tokens),
             "audio": ("frames", cfg.encoder_seq)}.get(cfg.frontend)
    if shape is None:
        return {}
    name, n = shape
    x = torch.randn((batch, n, cfg.d_model), generator=gen,
                    device=gen.device)
    return {name: x.to(getattr(torch, cfg.dtype))}


def with_frontend(data: Iterator[dict], cfg, gen: torch.Generator
                  ) -> Iterator[dict]:
    """``data``'s batches, each with fresh frontend inputs from ``gen``
    (:func:`frontend_inputs`; a text-only arch's batches unchanged)."""
    for b in data:
        yield {**b, **frontend_inputs(cfg, b["tokens"].shape[0], gen)}
