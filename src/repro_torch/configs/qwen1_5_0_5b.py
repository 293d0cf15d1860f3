"""qwen1.5-0.5b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B].
24L d_model=1024 16H (MHA kv=16) d_ff=2816 vocab=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=1024,
    vocab_size=151936,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    qkv_bias=True,
    rope_theta=1e6,
    source="[hf:Qwen/Qwen1.5-0.5B]",
)
