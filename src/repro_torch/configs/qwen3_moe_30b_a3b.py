"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].
48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    vocab_size=151936,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    moe_d_ff=768,
    num_experts=128,
    experts_per_token=8,
    moe_capacity_factor=1.25,
    rope_theta=1e6,
    source="[hf:Qwen/Qwen3-30B-A3B]",
)
