"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table)
[arXiv:2501.kimi2]. 61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048
vocab=163840, MoE 384 experts top-8, first layer dense."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    vocab_size=163840,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,          # the single leading dense layer (~8 experts worth)
    moe_d_ff=2048,       # per-expert hidden (assignment d_ff=2048)
    num_experts=384,
    experts_per_token=8,
    first_dense_layers=1,
    moe_capacity_factor=1.25,
    rope_theta=5e6,
    source="[arXiv:2501.kimi2] Kimi K2 paper table",
)
