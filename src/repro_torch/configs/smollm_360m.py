"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-360M].
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    num_layers=32,
    d_model=960,
    vocab_size=49152,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    tie_embeddings=True,
    source="[hf:HuggingFaceTB/SmolLM-135M] scaled per assignment",
)
