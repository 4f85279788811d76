"""--arch <id> registry for every assigned architecture (plus the paper's
own experiment configs, which are learner-level and live in repro/data)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, INPUT_SHAPES, InputShape
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as granite_moe_1b_a400m
from repro_torch.configs.whisper_tiny import CONFIG as whisper_tiny
from repro_torch.configs.h2o_danube_3_4b import CONFIG as h2o_danube_3_4b
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as qwen3_moe_235b_a22b
from repro_torch.configs.mamba2_130m import CONFIG as mamba2_130m
from repro_torch.configs.gemma_7b import CONFIG as gemma_7b
from repro_torch.configs.jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from repro_torch.configs.internvl2_2b import CONFIG as internvl2_2b
from repro_torch.configs.qwen3_0_6b import CONFIG as qwen3_0_6b
from repro_torch.configs.minicpm3_4b import CONFIG as minicpm3_4b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    granite_moe_1b_a400m,
    whisper_tiny,
    h2o_danube_3_4b,
    qwen3_moe_235b_a22b,
    mamba2_130m,
    gemma_7b,
    jamba_v0_1_52b,
    internvl2_2b,
    qwen3_0_6b,
    minicpm3_4b,
]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown --arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


# (arch, shape) pairs that are skipped, with the DESIGN.md §4 rationale.
SKIPS: dict[tuple[str, str], str] = {
    ("whisper-tiny", "long_500k"):
        "enc-dec with a 448-position decoder; no sub-quadratic variant claimed",
}


def long_context_overrides(cfg: ArchConfig) -> ArchConfig:
    """long_500k pathway: SSM/hybrid run natively; full-attention archs get
    the sliding-window variant (DESIGN.md §4)."""
    if cfg.ssm_state and not cfg.layer_pattern and cfg.attention == "none":
        return cfg                              # pure SSM: O(1)-state decode
    if cfg.window is None or cfg.window > 8192:
        cfg = cfg.with_overrides(window=4096)   # SWA carve-out
    return cfg
