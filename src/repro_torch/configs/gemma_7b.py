"""gemma-7b [dense] — GeGLU, head_dim=256, 16 kv heads (MQA is on the 2b).
[arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    arch_type="dense",
    source="arXiv:2403.08295",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu",               # GeGLU
    embed_scale=True,
    tie_embeddings=True,
)
