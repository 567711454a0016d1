"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8 (paper-table
scale entry) [arXiv:2501.kimi2]. Port of
``repro/configs/kimi_k2_1t_a32b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=2048,  # per-expert dim
    moe_d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    rope_theta=50000.0,
    source="arXiv:2501.kimi2",
)
