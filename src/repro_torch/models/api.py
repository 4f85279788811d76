"""Model API of the port, the serve half.

Counterpart of ``repro/models/api.py``: init, forward, one decode step,
the decode cache, and the prefill/serve step functions the serving CLI
runs.  The training half (``weighted_next_token_loss``, ``make_train_step``)
comes with the training slice; the encoder-decoder with a later one.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.attention import KVCache, QuantKVCache, quantize_kv


def init_params(cfg: ArchConfig, gen: torch.Generator | None = None) -> dict:
    return transformer.init_params(cfg, gen)


def forward(params: dict, batch: dict, cfg: ArchConfig):
    return transformer.forward(params, batch, cfg)


def decode_step(params: dict, caches: dict, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, cache_mode: str = "full"):
    return transformer.decode_step(params, caches, tokens, pos, cfg,
                                   cache_mode)


def init_cache(cfg: ArchConfig, batch: int, s_cache: int,
               dtype: torch.dtype | None = None,
               device: torch.device | str = "cpu") -> dict:
    return transformer.init_cache(cfg, batch, s_cache, dtype, device)


def cache_length(cfg: ArchConfig, seq_len: int) -> int:
    return transformer.cache_length(cfg, seq_len)


def count_params(params: dict) -> int:
    return transformer.count_params(params)


def pad_prefill_cache(caches: dict, cfg: ArchConfig, s_cache: int) -> dict:
    """Grow the prefill caches (length = prompt) to decode capacity: every
    leaf is zero-padded along the sequence axis (axis 2 of the stacked
    [L, B, S, ...] layout)."""
    def pad_axis2(a: torch.Tensor) -> torch.Tensor:
        if a.shape[2] >= s_cache:
            return a
        widths = [0, 0] * (a.dim() - 3) + [0, s_cache - a.shape[2]]
        return F.pad(a, widths)

    return {name: type(leaf)(*(pad_axis2(a) for a in leaf))
            for name, leaf in caches.items()}


def quantize_cache(caches: dict, cfg: ArchConfig) -> dict:
    """Convert a prefill KVCache tree to int8 (the kv_quant serving path)."""
    out = {}
    for name, leaf in caches.items():
        if not isinstance(leaf, KVCache):
            raise TypeError(f"{name}: expected a KVCache, got {type(leaf)}")
        kq, ks = quantize_kv(leaf.k)
        vq, vs = quantize_kv(leaf.v)
        out[name] = QuantKVCache(kq, vq, ks, vs)
    return out


# ---------------------------------------------------------- step functions
def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch):
        logits, caches, _ = forward(params, batch, cfg)
        return logits[:, -1:, :], caches
    return prefill_step


def make_serve_step(cfg: ArchConfig, cache_mode: str = "full") -> Callable:
    """One decode step: greedy next token given the running cache (which it
    updates in place)."""

    def serve_step(params, caches, tokens, pos):
        logits, caches = decode_step(params, caches, tokens, pos, cfg,
                                     cache_mode)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, caches

    return serve_step
