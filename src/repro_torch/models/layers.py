"""Shared model layers: RMSNorm, RoPE, embeddings, gated MLP.

Counterpart of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors with the reference's leaf names, so a JAX parameter tree converts
leaf for leaf (``repro_torch.convert.model_params_from_numpy``).  The
port's own initializers draw from an explicit ``torch.Generator``; they
give other numbers than the reference's ``jax.random`` for the same seed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _randn(gen: torch.Generator | None, shape: tuple,
           device: torch.device | str) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device)


def he_init(gen: torch.Generator | None, shape: tuple, dtype: torch.dtype,
            fan_in: int | None = None, *, lead: tuple = (),
            device: torch.device | str = "meta") -> torch.Tensor:
    """N(0, 2 / fan_in) (fan_in defaults to shape[0]) of ``lead + shape``:
    ``lead = (L,)`` stacks L layers.  ``gen`` None draws nothing (the meta
    device: shapes only)."""
    fan_in = fan_in or shape[0]
    x = _randn(gen, lead + tuple(shape), device)
    return (x * math.sqrt(2.0 / fan_in)).to(dtype)


def normal_init(gen: torch.Generator | None, shape: tuple, dtype: torch.dtype,
                *, device: torch.device | str = "meta",
                std: float = 0.02) -> torch.Tensor:
    """The embedding and LM-head init: N(0, std^2)."""
    return (_randn(gen, tuple(shape), device) * std).to(dtype)


# ---------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, dtype: torch.dtype, *, lead: tuple = (),
                 device: torch.device | str = "meta") -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * params["scale"].to(torch.float32)).to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """[D/2] float32, computed in float64 on ``device`` and rounded once,
    so the card's and the CPU's frequencies are the same bits (and no
    host-to-device copy waits on the card in the decode loop)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=device) / head_dim
    return (1.0 / theta ** exps).to(torch.float32)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [..., S, 1, D/2] of the angles ``positions * freqs``.
    The angles are float32 products, as in the reference; their cosines
    and sines are taken in float64 and rounded, the same bits on the card
    and the CPU.  A model computes them once a step for all its layers."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].to(torch.float32) * freqs   # [..., S, D/2]
    return (torch.cos(angles.double()).float()[..., None, :],
            torch.sin(angles.double()).float()[..., None, :])


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, D] rotated by the tables of :func:`rope_tables`; the
    head is split in halves (not interleaved)."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


# ------------------------------------------------------------- Embeddings
def embed(params: dict, tokens: torch.Tensor,
          scale: bool = False) -> torch.Tensor:
    x = params["embedding"][tokens]
    if scale:   # sqrt(d) rounded to x's dtype, as the reference multiplies
        x = x * float(torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype))
    return x


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in the model dtype, against the tied embedding."""
    return x @ params["embedding"].T


def lm_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["unembedding"]


# ------------------------------------------------------ Gated MLP (dense)
def mlp_init(gen: torch.Generator | None, d: int, d_ff: int,
             dtype: torch.dtype, *, lead: tuple = (),
             device: torch.device | str = "meta") -> dict:
    kw = dict(lead=lead, device=device)
    return {"wi_gate": he_init(gen, (d, d_ff), dtype, **kw),
            "wi_up": he_init(gen, (d, d_ff), dtype, **kw),
            "wo": he_init(gen, (d_ff, d), dtype, fan_in=d_ff, **kw)}


def activation(act: str, x: torch.Tensor) -> torch.Tensor:
    """The gated FFNs' activation: silu, else gelu (jax.nn.gelu is the
    tanh approximation by default)."""
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(params: dict, x: torch.Tensor, act: str, tp=None,
              split: bool = False, whole: bool = False) -> torch.Tensor:
    """The gated MLP.  Under tensor parallelism (``tp``, a
    ``sharding.tp.TP``) ``wi_gate``/``wi_up`` are this rank's columns of
    d_ff and ``wo`` its rows, the partial products summed over ``model``
    (``whole``: every rank holds the whole MLP); ``split``: x is the
    rank's chunk of S (sequence parallelism)."""
    from repro_torch.sharding import tp as tp_lib
    x = tp_lib.enter(x, tp, split, whole)
    gate = x @ params["wi_gate"]
    up = x @ params["wi_up"]
    return tp_lib.leave((activation(act, gate) * up) @ params["wo"], tp,
                        split, whole)
