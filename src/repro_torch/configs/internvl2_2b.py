"""internvl2-2b [vlm] — InternLM2-1.8B language backbone; the InternViT
vision encoder + projector is a stub (input_specs provides patch
embeddings). [arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    act="silu",
    frontend="vision",
    num_frontend_tokens=256,  # one image tile worth of patch embeddings
)
