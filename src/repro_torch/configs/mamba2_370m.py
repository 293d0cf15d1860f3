"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].
48L d_model=1024, attn-free, ssm_state=128, vocab=50280."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    num_layers=48,
    d_model=1024,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    conv_kernel=4,
    tie_embeddings=True,
    source="[arXiv:2405.21060] Mamba-2 370m table",
)
