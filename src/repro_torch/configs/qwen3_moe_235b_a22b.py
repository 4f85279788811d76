"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, qk-norm GQA.
[hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                # per-expert hidden (the assigned d_ff)
    vocab_size=151936,
    qk_norm=True,
    num_experts=128,
    top_k=8,
    moe_d_ff=1536,
    act="silu",
    tie_embeddings=False,
)
