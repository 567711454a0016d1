"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783].
Port of ``repro/configs/llama3_8b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783",
)

# Sliding-window variant (the reference's long-context config override).
CONFIG_SW = CONFIG.replace(name="llama3-8b-sw8k", sliding_window=8192)
