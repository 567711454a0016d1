"""Input-shape definitions, the entry points' input stand-ins and reduced
(smoke) config derivation. Port of ``repro/configs/base.py``
(``InputShape``, ``INPUT_SHAPES``, ``frontend_len``, ``input_specs``,
``reduced``). Where the reference builds ``jax.ShapeDtypeStruct`` stand-ins,
:func:`input_specs` returns tensors on the meta device: the same keys,
shapes and dtypes, and nothing allocated."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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

# Modality frontend stub sizes: pixtral gets ``frontend_tokens`` patch
# embeddings prepended; seamless consumes (B, S_enc, d) frame embeddings in
# the encoder.
VLM_PATCHES_FRACTION = 0.25  # of seq_len, capped at frontend_tokens


def frontend_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.modality != "vision":
        return 0
    return min(cfg.frontend_tokens,
               max(16, int(seq_len * VLM_PATCHES_FRACTION)))


def input_specs(cfg: ModelConfig, shape_name: str,
                max_seq: Optional[int] = None) -> Dict:
    """Meta-tensor stand-ins for every model input of the entry point:

    train   -> {"batch": ...}            (train_step's batch)
    prefill -> {"batch": ...}            (prefill_step's batch)
    decode  -> {"tokens": ..., "cache": ...}  (serve_step: ONE new token
               against a cache of ``max_seq or seq_len`` rows)

    An audio model's batch holds S frame embeddings and S // 8 (at least
    32) decoder tokens; its decode cache adds the cross K/V "ck"/"cv" over
    S_enc = max(32, S // 8) encoded frames. A vision model's batch holds
    :func:`frontend_len` patch embeddings and the rest as tokens."""
    from repro_torch.models import transformer

    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if shp.kind in ("train", "prefill"):
        if cfg.family == "audio":
            S_dec = max(32, S // 8)
            batch = {"frames": meta((B, S, cfg.d_model), cfg.dtype),
                     "tokens": meta((B, S_dec))}
            if shp.kind == "train":
                batch["labels"] = meta((B, S_dec))
        elif cfg.modality == "vision":
            F = frontend_len(cfg, S)
            batch = {"frontend": meta((B, F, cfg.d_model), cfg.dtype),
                     "tokens": meta((B, S - F))}
            if shp.kind == "train":
                batch["labels"] = meta((B, S - F))
        else:
            batch = {"tokens": meta((B, S))}
            if shp.kind == "train":
                batch["labels"] = meta((B, S))
        return {"batch": batch}

    cache = transformer.init_cache(cfg, B, max_seq or S, device="meta")
    if cfg.family == "audio":
        S_enc = max(32, S // 8)
        kv = (cfg.num_layers, B, cfg.num_kv_heads, S_enc,
              cfg.resolved_head_dim)
        cache["ck"] = meta(kv, cfg.dtype)
        cache["cv"] = meta(kv, cfg.dtype)
    return {"tokens": meta((B,)), "cache": cache}


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
