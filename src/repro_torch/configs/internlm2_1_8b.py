"""internlm2-1.8b [dense] — GQA [arXiv:2403.17297].
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    vocab_size=92544,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    rope_theta=1e6,
    source="[arXiv:2403.17297] InternLM2 1.8B",
)
