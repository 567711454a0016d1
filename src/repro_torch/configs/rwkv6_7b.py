"""rwkv6-7b — Finch: attention-free, data-dependent decay [arXiv:2404.05892].
Port of ``repro/configs/rwkv6_7b.py``. No KV cache and no attention
operator: the recurrent state (one (P, P) fp32 matrix per head and layer)
is what decoding carries."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,       # d_model / rwkv_head_dim
    num_kv_heads=64,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    source="arXiv:2404.05892",
)
