"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887]"""
from repro_torch.configs.base import ArchConfig

# One Jamba block = 8 layers, attention at index 4 (1:7 ratio), MoE replaces
# the MLP on every other layer (odd indices).  32 layers = 4 scanned blocks.
_PATTERN = ("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm")

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_every=2,              # MoE on every other layer
    layer_pattern=_PATTERN,
    ssm_state=16,             # Jamba uses Mamba-1 d_state=16
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    act="silu",
)
