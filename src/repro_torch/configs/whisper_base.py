"""whisper-base [audio] — encoder-decoder, conv/mel frontend stubbed
[arXiv:2212.04356]. 6L decoder (+6L encoder) d_model=512 8H (kv=8)
d_ff=2048 vocab=51865; encoder consumes precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,
    encoder_layers=6,
    d_model=512,
    vocab_size=51865,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    audio_frames=1500,
    source="[arXiv:2212.04356] Whisper base",
)
