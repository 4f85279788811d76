"""Architecture + input-shape configuration system.

The port's copy of ``repro/configs/base.py``, kept as data so that ``--arch``
names and ``reduced()`` match the JAX package's.  Every assigned
architecture is a frozen ArchConfig in its own module under
``repro_torch/configs``; ``registry.py`` maps ``--arch <id>`` to it.
``reduced()`` derives the CPU smoke-test variant (<=2 layers,
d_model<=512, <=4 experts).  The port's models run all ten
(``repro_torch.models.api``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""                    # paper / model-card citation

    # attention flavour
    attention: str = "gqa"              # gqa | mla | none
    qk_norm: bool = False
    window: int | None = None           # sliding-window size (SWA)
    rope_theta: float = 10_000.0
    logit_softcap: float | None = None

    # MLA (MiniCPM3 / DeepSeek-style multi-head latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # feed-forward
    act: str = "silu"                   # silu (SwiGLU) | gelu (GeGLU)

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                   # per-expert hidden dim
    moe_every: int = 1                  # MoE block every k-th layer
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid interleave (Jamba): layer-kind pattern unit, scanned repeats
    layer_pattern: tuple[str, ...] = ()  # e.g. ("ssm","ssm","ssm","attn",...)

    # encoder-decoder (Whisper backbone)
    encoder_layers: int = 0
    encoder_seq: int = 0                # frame positions from the frontend stub
    cross_attention: bool = False

    # modality frontend stub
    frontend: str | None = None         # audio | vision
    num_frontend_tokens: int = 0        # tokens the stub prepends (vision)

    # embeddings / misc
    tie_embeddings: bool = True
    embed_scale: bool = False           # gemma-style sqrt(d) embedding scale
    norm_eps: float = 1e-6
    max_position: int = 1_048_576

    # numerics / perf knobs (§Perf levers)
    dtype: str = "bfloat16"
    remat: str = "none"                 # none | block
    scan_layers: bool = True            # False: unrolled (cost extraction)
    attn_impl: str = "einsum"           # einsum | chunked (online-softmax)
    attn_chunk: int = 2048              # query-chunk for attn_impl=chunked
    moe_impl: str = "gmm"               # dense | gmm | ep_a2a
    moe_expert_axis: str = "data"       # mesh axis sharding the expert dim
    moe_ff_axis: str = "model"          # mesh axis sharding expert d_ff
    microbatches: int = 1               # grad-accumulation splits (§Perf)
    kv_quant: bool = False              # int8 KV cache (GQA decode, §Perf)
    mla_rank_shard: bool = False        # shard MLA b-mats on contraction dims
                                        # (capacity-for-bandwidth trade, §Perf)
    seq_parallel: bool = False          # Megatron-SP: shard S over model in
                                        # the norm/residual regions (§Perf)
    use_flash: bool = False             # CUDA flash attention / decode

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:           # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def with_overrides(self, **kw) -> "ArchConfig":
        return replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        head_dim = min(self.head_dim, 64) if self.head_dim else 0
        scale = d_model / self.d_model
        kw = dict(
            num_layers=min(self.num_layers, 2),
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=max(64, min(self.d_ff, 512)),
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
        )
        if self.is_moe:
            kw.update(num_experts=min(self.num_experts, 4),
                      top_k=min(self.top_k, 2),
                      moe_d_ff=max(32, min(self.moe_d_ff, 128)))
        if self.attention == "mla":
            kw.update(q_lora_rank=min(self.q_lora_rank, 64) or 0,
                      kv_lora_rank=min(self.kv_lora_rank, 32),
                      qk_rope_head_dim=min(self.qk_rope_head_dim, 16),
                      qk_nope_head_dim=min(self.qk_nope_head_dim, 16),
                      v_head_dim=min(self.v_head_dim, 16))
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32,
                      ssm_chunk=32)
        if self.layer_pattern:
            kw.update(num_layers=len(self.layer_pattern))  # one pattern unit
        if self.encoder_layers:
            kw.update(encoder_layers=min(self.encoder_layers, 2),
                      encoder_seq=min(self.encoder_seq, 64) or 64)
        if self.num_frontend_tokens:
            kw.update(num_frontend_tokens=min(self.num_frontend_tokens, 16))
        del scale
        return self.with_overrides(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                           # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
