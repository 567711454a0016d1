"""zamba2-1.2b — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242]. 38 mamba2 layers; one weight-shared attention+MLP block
applied every `shared_attn_period` layers (6 invocations + 2 tail layers).
Port of ``repro/configs/zamba2_1_2b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,  # MHA in the shared block
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_period=6,
    source="arXiv:2411.15242",
)
