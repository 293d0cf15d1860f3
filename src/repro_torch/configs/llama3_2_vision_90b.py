"""llama-3.2-vision-90b [vlm] — cross-attention image layers every 5th
layer [hf:meta-llama/Llama-3.2-11B-Vision, 90B scaling]. 100L d_model=8192
64H (GQA kv=8) d_ff=28672 vocab=128256. The ViT tower is a stub: the
language model consumes precomputed patch embeddings (input_specs)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    vocab_size=128256,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    cross_attn_every=5,
    num_image_tokens=1601,
    rope_theta=5e5,
    source="[hf:meta-llama/Llama-3.2-11B-Vision] 90B variant",
)
