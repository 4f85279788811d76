"""minicpm3-4b [dense] — multi-head latent attention (MLA) with compressed
KV cache. [hf:openbmb/MiniCPM3-4B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    arch_type="dense",
    source="hf:openbmb/MiniCPM3-4B",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,          # MLA: per-head latents, GQA kv==heads
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_rope_head_dim=32,
    qk_nope_head_dim=64,
    v_head_dim=64,
    act="silu",
)
