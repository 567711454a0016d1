"""qwen3-moe-30b-a3b — MoE, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].
Port of ``repro/configs/qwen3_moe_30b_a3b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,   # listed d_ff is the per-expert dim
    moe_d_ff=768,
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    qk_norm=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)
