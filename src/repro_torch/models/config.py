"""Architecture config — a superset dataclass covering the six assigned
architecture families (dense / moe / ssm / hybrid / vlm / audio)."""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sliding_window: int = 0           # 0 = full causal attention
    attn_chunk: int = 1024            # online-softmax KV chunk (jnp path)
    remat: bool = True                # checkpoint layer blocks in training
    dtype: str = "bfloat16"

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    first_dense_layers: int = 0       # leading layers use a dense FFN
    moe_d_ff: int = 0                 # per-expert hidden (0 -> d_ff)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: tuple = ()         # e.g. ("rec", "rec", "attn")
    local_window: int = 2048
    lru_width: int = 0                # 0 -> d_model

    # --- VLM (cross-attention image layers) ---
    cross_attn_every: int = 0         # every Nth layer is a cross-attn layer
    num_image_tokens: int = 0

    # --- audio enc-dec (Whisper) ---
    encoder_layers: int = 0
    audio_frames: int = 1500          # post-conv-frontend frames (stubbed)

    # citation for the assigned config
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.num_heads))

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (assignment spec:
        <=2 layers, d_model<=512, <=4 experts)."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            vocab_size=min(self.vocab_size, 512),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=64 if self.num_heads else 0,
            attn_chunk=128,
            remat=False,
        )
        if self.num_experts:
            small.update(num_experts=4, experts_per_token=2,
                         moe_d_ff=min(self.expert_d_ff, 128),
                         first_dense_layers=min(self.first_dense_layers, 1))
        if self.ssm_state:
            small.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=32)
        if self.block_pattern:
            small.update(block_pattern=("rec", "attn"), local_window=64,
                         lru_width=min(self.lru_dim, 256))
        if self.cross_attn_every:
            small.update(cross_attn_every=2, num_image_tokens=16)
        if self.encoder_layers:
            small.update(encoder_layers=2, audio_frames=32)
        if self.sliding_window:
            small.update(sliding_window=64)
        small.update(overrides)
        small["name"] = self.name + "-smoke"
        return replace(self, **small)
