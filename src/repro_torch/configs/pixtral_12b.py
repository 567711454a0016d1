"""pixtral-12b — VLM: pixtral-ViT frontend (stubbed to patch embeddings) +
mistral-nemo-style decoder backbone [hf:mistralai/Pixtral-12B-2409].
Port of ``repro/configs/pixtral_12b.py``."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    modality="vision",
    frontend_tokens=1024,  # max patch embeddings prepended (stub frontend)
    source="hf:mistralai/Pixtral-12B-2409",
)
