"""glm4-9b — dense, RoPE, extreme GQA (kv=2) [hf:THUDM/glm-4-9b].
Port of ``repro/configs/glm4_9b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10000.0,
    source="hf:THUDM/glm-4-9b",
)

# StreamingLLM-style long-context variant (paper §7 sparse attention): 4
# sink tokens + an 8k window.
CONFIG_SINKS = CONFIG.replace(name="glm4-9b-sinks", sliding_window=8192,
                              attention_sinks=4)
