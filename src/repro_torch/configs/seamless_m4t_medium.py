"""seamless-m4t-medium — encoder-decoder, multimodal speech/text
[arXiv:2308.11596]. Port of ``repro/configs/seamless_m4t_medium.py``,
served by ``models/transformer.py``'s dense-cache entry points (not by
``LLMEngine``, as in the reference). The audio frontend is stubbed: the
encoder consumes precomputed (B, S_enc, d) frame embeddings."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    is_encoder_decoder=True,
    encoder_layers=12,
    num_layers=12,  # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    modality="audio_frames",
    source="arXiv:2308.11596",
)
