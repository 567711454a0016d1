"""llama3-70b — the paper's own analysis/eval model (Table 2/3)
[arXiv:2407.21783]. Port of ``repro/configs/llama3_70b.py``; not in the
assigned 10-arch pool."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    source="arXiv:2407.21783 / paper Table 2",
)
