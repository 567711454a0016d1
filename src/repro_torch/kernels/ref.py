"""Dense oracles the kernels' plain twins are held against.
Port of ``repro/kernels/ref.py`` (the bf16/fp32 decode references; the int8
and recurrent-scan oracles arrive with their kernels)."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k_cache, v_cache, cache_len, *,
                         sliding_window: int = 0, attention_sinks: int = 0,
                         logit_softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Hkv, G, hd); caches: HEAD-MAJOR (B, Hkv, S, hd); cache_len:
    (B,). Returns (B, Hkv, G, hd). fp32 math throughout."""
    B, Hkv, G, hd = q.shape
    S = k_cache.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhgk,bhsk->bhgs", q.float() * scale, k_cache.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    clen = cache_len.long()[:, None]
    valid = pos < clen
    if sliding_window > 0:
        in_window = pos >= clen - sliding_window
        if attention_sinks > 0:
            in_window |= pos < attention_sinks
        valid &= in_window
    s = torch.where(valid[:, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsk->bhgk", p, v_cache.float())
    return out.to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, cache_len, *,
                               sliding_window: int = 0,
                               attention_sinks: int = 0,
                               logit_softcap: float = 0.0) -> torch.Tensor:
    """Oracle for the paged flash-decode kernel: gather the dense head-major
    view through the block table, then the dense oracle math."""
    from repro_torch.kernels.paged_decode_attention import paged_gather_dense

    kc, vc = paged_gather_dense(k_pool, v_pool, block_tables)
    return decode_attention_ref(q, kc, vc, cache_len,
                                sliding_window=sliding_window,
                                attention_sinks=attention_sinks,
                                logit_softcap=logit_softcap)
