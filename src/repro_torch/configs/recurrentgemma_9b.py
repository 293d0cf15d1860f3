"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec
[arXiv:2402.19427]. 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000, local window 2048."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    vocab_size=256000,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=4096,
    conv_kernel=4,
    tie_embeddings=True,
    source="[arXiv:2402.19427] RecurrentGemma-9B",
)
