"""whisper-tiny [audio] — enc-dec transformer backbone; the mel+conv
frontend is a stub (input_specs provides frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=4,             # decoder layers
    encoder_layers=4,
    encoder_seq=1500,         # conv-downsampled mel frames (30 s @ 50 Hz)
    cross_attention=True,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    frontend="audio",
    rope_theta=10_000.0,      # backbone uses RoPE in lieu of learned pos
)
