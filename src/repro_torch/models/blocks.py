"""Transformer blocks. Port of ``repro/models/blocks.py`` for the dense
family (llama / gemma2 / vlm stacks): pre-norm attention + SwiGLU FFN, with
gemma2's post-norms. ``mode`` is "prefill" or "decode" (paged)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.attention import (attention_decode_step_paged,
                                          attention_forward, init_attention)
from repro_torch.models.common import ModelConfig, rms_norm
from repro_torch.models.ffn import ffn_forward, init_ffn


def init_dense_block(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    zeros = dict(dtype=cfg.dtype, device=device)
    p = {
        "norm1": torch.zeros((cfg.d_model,), **zeros),
        "norm2": torch.zeros((cfg.d_model,), **zeros),
        "attn": init_attention(gen, cfg, device),
        "ffn": init_ffn(gen, cfg, device),
    }
    if cfg.post_norms:
        p["norm_post_attn"] = torch.zeros((cfg.d_model,), **zeros)
        p["norm_post_ffn"] = torch.zeros((cfg.d_model,), **zeros)
    return p


def dense_block(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, is_local: bool = False,
                paged_prefix: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]] = None,
                paged_prefix_scales: Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """Returns (x, new_cache_entries). ``mode="decode"`` reads the paged
    pool in ``cache`` ({"k_pool", "v_pool", "block_tables", "len"}, plus
    "k_scale"/"v_scale" for an int8 pool) and returns {"k_new", "v_new"};
    ``mode="prefill"`` returns this layer's {"k", "v"} (B, S, Hkv, hd),
    attending over ``paged_prefix`` (and its ``paged_prefix_scales``) when
    given (chunked prefill, see ``attention_forward``)."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if mode == "decode":
        attn, k_new, v_new = attention_decode_step_paged(
            params["attn"], cfg, h, cache["k_pool"], cache["v_pool"],
            cache["block_tables"], cache["len"], is_local=is_local,
            k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
        new_cache = {"k_new": k_new, "v_new": v_new}
    elif mode == "prefill":
        attn, k, v = attention_forward(params["attn"], cfg, h, positions,
                                       is_local=is_local,
                                       paged_prefix=paged_prefix,
                                       paged_prefix_scales=paged_prefix_scales)
        new_cache = {"k": k, "v": v}
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode'; got {mode!r}")
    if cfg.post_norms:
        attn = rms_norm(attn, params["norm_post_attn"], cfg.norm_eps)
    x = x + attn

    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    f = ffn_forward(params["ffn"], h)
    if cfg.post_norms:
        f = rms_norm(f, params["norm_post_ffn"], cfg.norm_eps)
    return x + f, new_cache
