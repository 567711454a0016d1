"""Input-shape definitions and reduced (smoke) config derivation. Port of
``repro/configs/base.py`` (``InputShape``, ``INPUT_SHAPES``, ``reduced``;
the reference's ShapeDtypeStruct helpers serve JAX lowering only)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant of the same family: 2 layers, d_model<=512,
    <=4 experts, tiny vocab, fp32."""
    kw = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads else 0,
        head_dim=64,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        dtype=torch.float32,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=2,
                  moe_d_ff=min(cfg.moe_d_ff, 128))
    if cfg.family == "hybrid":
        kw.update(num_layers=5, shared_attn_period=2, num_heads=4,
                  num_kv_heads=4, ssm_state=16, ssm_head_dim=32)
    if cfg.family == "ssm":
        kw.update(rwkv_head_dim=32)
    if cfg.family == "audio":
        kw.update(encoder_layers=2)
    if cfg.local_global:
        kw.update(num_layers=2, sliding_window=64)
    if cfg.modality == "vision":
        kw.update(frontend_tokens=16)
    kw.update(overrides)
    return cfg.replace(**kw)
