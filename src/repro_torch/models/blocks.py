"""Transformer blocks. Port of ``repro/models/blocks.py`` for the dense
family (llama / gemma2 / vlm stacks: pre-norm attention + SwiGLU FFN, with
gemma2's post-norms; the moe family's blocks put ``models/moe.py`` in the
FFN's place), the RWKV6 block (rwkv6), the Mamba2 block (zamba2's
backbone) and seamless's encoder block and decoder block with
cross-attention (family ``audio``). ``mode`` is "train" (full sequence,
no cache), "prefill" (full sequence, returns the cache or state) or
"decode" (one token)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import ssm
from repro_torch.models.attention import (attention_decode_step,
                                          attention_decode_step_paged,
                                          attention_forward,
                                          blockwise_attention,
                                          decode_cross_attention,
                                          init_attention, out_project,
                                          qkv_project)
from repro_torch.models.common import ModelConfig, rms_norm
from repro_torch.models.ffn import ffn_forward, init_ffn
from repro_torch.models.moe import init_moe, moe_forward


def init_dense_block(gen: torch.Generator, cfg: ModelConfig, device,
                     use_moe: bool = False) -> Dict:
    zeros = dict(dtype=cfg.dtype, device=device)
    p = {
        "norm1": torch.zeros((cfg.d_model,), **zeros),
        "norm2": torch.zeros((cfg.d_model,), **zeros),
        "attn": init_attention(gen, cfg, device),
    }
    if use_moe:
        p["moe"] = init_moe(gen, cfg, device)
    else:
        p["ffn"] = init_ffn(gen, cfg, device)
    if cfg.post_norms:
        p["norm_post_attn"] = torch.zeros((cfg.d_model,), **zeros)
        p["norm_post_ffn"] = torch.zeros((cfg.d_model,), **zeros)
    return p


def dense_block(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                mode: str, positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, is_local: bool = False,
                moe_group_size: int = 256,
                prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                paged_prefix: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]] = None,
                paged_prefix_scales: Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict, Any]:
    """Returns (x, new_cache_entries, aux_loss). ``mode="decode"`` reads
    either the
    paged pool in ``cache`` ({"k_pool", "v_pool", "block_tables", "len"},
    plus "k_scale"/"v_scale" for an int8 pool) or a dense head-major cache
    ({"k", "v", "len"}, (B, Hkv, S, hd), plus "k_scale"/"v_scale"
    (B, Hkv, S) for an int8 cache) and returns {"k_new", "v_new"};
    ``mode="prefill"`` returns this layer's {"k", "v"} (B, S, Hkv, hd),
    attending over ``paged_prefix`` (and its ``paged_prefix_scales``) when
    given (chunked prefill) or over the head-major ``prefix_kv`` (the
    suffix prefill; see ``attention_forward``); ``mode="train"``
    returns no cache. A moe block's FFN is ``moe_forward`` over routing
    groups of ``moe_group_size`` tokens; ``aux_loss`` is its router's
    load-balance loss (fp32 scalar; 0.0 for an FFN block), which
    ``loss_fn`` weighs into the training loss."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    new_cache: Dict = {}
    if mode == "decode":
        if "k_pool" in cache:   # paged: attend over the block pool in place
            attn, k_new, v_new = attention_decode_step_paged(
                params["attn"], cfg, h, cache["k_pool"], cache["v_pool"],
                cache["block_tables"], cache["len"], is_local=is_local,
                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
        else:
            attn, k_new, v_new = attention_decode_step(
                params["attn"], cfg, h, cache["k"], cache["v"], cache["len"],
                is_local=is_local, k_scale=cache.get("k_scale"),
                v_scale=cache.get("v_scale"))
        new_cache = {"k_new": k_new, "v_new": v_new}
    elif mode in ("prefill", "train"):
        attn, k, v = attention_forward(params["attn"], cfg, h, positions,
                                       is_local=is_local,
                                       prefix_kv=prefix_kv,
                                       paged_prefix=paged_prefix,
                                       paged_prefix_scales=paged_prefix_scales)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    else:
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode'; got "
                         f"{mode!r}")
    if cfg.post_norms:
        attn = rms_norm(attn, params["norm_post_attn"], cfg.norm_eps)
    x = x + attn

    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    if "moe" in params:
        f, aux = moe_forward(params["moe"], cfg, h,
                             group_size=moe_group_size)
    else:
        f = ffn_forward(params["ffn"], h)
        aux = 0.0                  # a constant: no kernel on serving paths
    if cfg.post_norms:
        f = rms_norm(f, params["norm_post_ffn"], cfg.norm_eps)
    return x + f, new_cache, aux


# ---------------------------------------------------------------------------
# RWKV6 block
# ---------------------------------------------------------------------------
def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    zeros = dict(dtype=cfg.dtype, device=device)
    return {
        "norm1": torch.zeros((cfg.d_model,), **zeros),
        "norm2": torch.zeros((cfg.d_model,), **zeros),
        "tmix": ssm.init_rwkv_time_mix(gen, cfg, device),
        "cmix": ssm.init_rwkv_channel_mix(gen, cfg, device),
    }


def rwkv_block(params: Dict, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
               state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Returns (x, state). ``prefill`` returns the decode state after x
    ({"S", "x_tm", "x_cm"}); ``decode`` takes and returns it."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    if mode == "decode":
        tm, tstate = ssm.rwkv_time_mix_decode(params["tmix"], cfg, h, state)
    elif mode == "prefill":
        tm, tstate = ssm.rwkv_time_mix_forward(params["tmix"], cfg, h,
                                               final_state=True)
    else:
        tm = ssm.rwkv_time_mix_forward(params["tmix"], cfg, h)
        tstate = {"x_tm": h[:, -1]}
    x = x + tm
    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    last = state["x_cm"] if mode == "decode" else torch.zeros_like(h[:, 0])
    cm, _ = ssm.rwkv_channel_mix_forward(params["cmix"], cfg, h, last)
    new_state = dict(tstate)
    # a prefill's state is a copy: a view of h would keep all S rows alive
    new_state["x_cm"] = h[:, -1].clone() if mode == "prefill" else h[:, -1]
    return x + cm, new_state


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 hybrid)
# ---------------------------------------------------------------------------
def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    return {
        "norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device),
        "mamba": ssm.init_mamba(gen, cfg, device),
    }


def mamba_block(params: Dict, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
                state: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Returns (x, state). ``prefill`` returns the decode state after x
    ({"h", "conv"}); ``decode`` takes and returns it; ``train`` returns
    {}."""
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    if mode == "decode":
        y, new_state = ssm.mamba_decode_step(params["mamba"], cfg, h, state)
    elif mode == "prefill":
        y, new_state = ssm.mamba_forward(params["mamba"], cfg, h,
                                         final_state=True)
    else:
        y, new_state = ssm.mamba_forward(params["mamba"], cfg, h), {}
    return x + y, new_state


# ---------------------------------------------------------------------------
# Encoder block (bidirectional) + decoder block w/ cross-attention (seamless)
# ---------------------------------------------------------------------------
def init_encoder_block(gen: torch.Generator, cfg: ModelConfig,
                       device) -> Dict:
    zeros = dict(dtype=cfg.dtype, device=device)
    return {
        "norm1": torch.zeros((cfg.d_model,), **zeros),
        "norm2": torch.zeros((cfg.d_model,), **zeros),
        "attn": init_attention(gen, cfg, device),
        "ffn": init_ffn(gen, cfg, device),
    }


def encoder_block(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Bidirectional self-attention + SwiGLU over the (B, S_enc, d)
    frames: the plain blockwise path, as the reference's jnp one (no
    Pallas kernel serves it there either)."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    q, k, v = qkv_project(params["attn"], cfg, h, positions)
    out = blockwise_attention(q, k, v, causal=False, q_positions=positions)
    x = x + out_project(params["attn"], out)
    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    return x + ffn_forward(params["ffn"], h)


def init_decoder_block(gen: torch.Generator, cfg: ModelConfig,
                       device) -> Dict:
    zeros = dict(dtype=cfg.dtype, device=device)
    return {
        "norm1": torch.zeros((cfg.d_model,), **zeros),
        "norm2": torch.zeros((cfg.d_model,), **zeros),
        "norm3": torch.zeros((cfg.d_model,), **zeros),
        "attn": init_attention(gen, cfg, device),
        "cross": init_attention(gen, cfg, device),
        "ffn": init_ffn(gen, cfg, device),
    }


def decoder_block(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  enc_kv: Tuple[torch.Tensor, torch.Tensor], *, mode: str,
                  positions: Optional[torch.Tensor] = None,
                  cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
    """Causal self-attention, cross-attention over the encoder's K/V, then
    SwiGLU. ``enc_kv``: this layer's encoder (k, v), seq-major (B, S_enc,
    Hkv, hd) for "train"/"prefill", HEAD-MAJOR (B, Hkv, S_enc, hd) from the
    cache for "decode". At decode the self-attention reads the dense cache
    ({"k", "v", "len"}) through ``attention_decode_step`` and the
    cross-attention attends over every encoder row through
    ``decode_cross_attention``: the dense decode kernel twice a layer on
    the card. Returns (x, {"k_new", "v_new"} at decode, {"k", "v"} (B, S,
    Hkv, hd) at prefill)."""
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    new_cache: Dict = {}
    if mode == "decode":
        attn, k_new, v_new = attention_decode_step(
            params["attn"], cfg, h, cache["k"], cache["v"], cache["len"])
        new_cache = {"k_new": k_new, "v_new": v_new}
    elif mode in ("prefill", "train"):
        attn, k, v = attention_forward(params["attn"], cfg, h, positions)
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    else:
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode'; got "
                         f"{mode!r}")
    x = x + attn
    # cross attention (encoder K/V are fixed — computed once per request)
    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, params["cross"]["wq"])
    ek, ev = enc_kv
    if mode == "decode":
        out = decode_cross_attention(q[:, 0], ek, ev)[:, None]
    else:
        out = blockwise_attention(q, ek, ev, causal=False)
    x = x + out_project(params["cross"], out)
    h = rms_norm(x, params["norm3"], cfg.norm_eps)
    return x + ffn_forward(params["ffn"], h), new_cache


def encoder_cross_kv(params: Dict, cfg: ModelConfig, enc_out: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder output into this decoder layer's cross K/V,
    seq-major (B, S_enc, Hkv, hd)."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["cross"]["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["cross"]["wv"])
    return k, v
