"""Sequence classifier head over a backbone: mean-pooled final hidden
states -> K-class logits.

Counterpart of ``repro/models/classifier.py``; what turns an assigned
architecture into an ASCII agent's model class (``learners/neural.py``).
The backbone is the port's decoder-only transformer (dense, MoE, SSM,
hybrid, MLA, vision): its units' forward with the MoE aux loss carried and
not added, as the reference's ``scan`` of ``_unit_forward``.  The
encoder-decoder is refused (:func:`check_backbone`).  The head
``cls_head.w`` [d_model, K] is stored in ``cfg.dtype`` and applied in
float32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.layers import he_init


def check_backbone(cfg: ArchConfig) -> None:
    """A classifier's backbone is a decoder-only stack: an encoder-decoder
    config would lose its encoder and cross-attention, so it raises."""
    if cfg.cross_attention:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is no classifier backbone "
            f"(its units need the encoder's frames); use a decoder-only "
            f"architecture")


def init_params(cfg: ArchConfig, num_classes: int,
                gen: torch.Generator | None = None) -> dict:
    """The backbone's params (``transformer.init_params``) and a he-init
    ``cls_head``, drawn from ``gen`` on its device (None: shapes on the
    meta device)."""
    check_backbone(cfg)
    params = transformer.init_params(cfg, gen)
    device = "meta" if gen is None else gen.device
    params["cls_head"] = {"w": he_init(gen, (cfg.d_model, num_classes),
                                       transformer.DTYPES[cfg.dtype],
                                       device=device)}
    return params


def pooled_logits(params: dict, h: torch.Tensor) -> torch.Tensor:
    """Class logits [B, K] of final hidden states h [B, S, d]: the mean over
    the sequence, then the head, in float32."""
    pooled = torch.mean(h, dim=1)
    return pooled.to(torch.float32) @ params["cls_head"]["w"].to(
        torch.float32)


def apply(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """batch {"tokens": [B, S]} (+ "patch_emb") -> class logits [B, K]."""
    check_backbone(cfg)
    x = transformer.embed_inputs(params, batch, cfg)
    return pooled_logits(params, transformer.hidden_states(params, x, cfg))
