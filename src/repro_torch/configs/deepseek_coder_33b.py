"""deepseek-coder-33b [dense] — llama-arch [arXiv:2401.14196].
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    vocab_size=32256,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    rope_theta=1e5,
    source="[arXiv:2401.14196] DeepSeek-Coder 33B",
)
