"""gemma2-27b — dense, alternating local(4096)/global attention, logit
softcaps, sandwich norms, tied embeddings [arXiv:2408.00118].
Port of ``repro/configs/gemma2_27b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    local_global=True,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_norms=True,
    tie_embeddings=True,
    source="arXiv:2408.00118",
)
