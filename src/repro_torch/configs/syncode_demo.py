"""syncode-demo — the paper's own experiments run against small LMs; this
is the CPU-runnable config used by examples/ and benchmarks/ (random-init;
see DESIGN.md deviations)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="syncode-demo",
    arch_type="dense",
    num_layers=4,
    d_model=256,
    vocab_size=2048,
    num_heads=8,
    num_kv_heads=4,
    head_dim=32,
    d_ff=1024,
    attn_chunk=256,
    remat=False,
    source="paper demo substrate (SynCode §5 uses small open models)",
)
