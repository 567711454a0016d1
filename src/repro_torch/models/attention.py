"""GQA attention: blockwise (flash-style) prefill path, the paged chunk
prefill path, the single-token decode paths over the paged pool and over a
dense head-major cache, and the single-token cross-attention of an
encoder-decoder.
Port of ``repro/models/attention.py``.

The blockwise path carries running ``(max, denom, acc)`` statistics across
KV blocks — the partial-softmax combine identity of paper §4.2.2
(``core/combine.py``) that the paged kernels use on the card. Supports
causal masking, sliding windows, attention sinks and logit soft-capping.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import combine as C
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ops
from repro_torch.kernels.paged_prefill_attention import \
    paged_prefill_chunk_attention
from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       is_placed, on_local_shards,
                                       rms_norm)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   dtype=None) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.dtype
    hd = cfg.resolved_head_dim
    params = {
        "wq": dense_init(gen, (cfg.d_model, cfg.num_heads, hd), dtype, device),
        "wk": dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd), dtype,
                         device),
        "wv": dense_init(gen, (cfg.d_model, cfg.num_kv_heads, hd), dtype,
                         device),
        "wo": dense_init(gen, (cfg.num_heads, hd, cfg.d_model), dtype, device),
    }
    if cfg.qk_norm:
        params["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        params["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return params


def qkv_project(params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,hd), k/v (B,S,Hkv,hd) with RoPE applied."""
    q = _heads_project(x, params["wq"])
    k = _heads_project(x, params["wk"])
    v = _heads_project(x, params["wv"])
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd). A placed projection
    runs column-parallel on each rank's shards: the weight keeps its split
    of the heads (or head_dim) and has its FSDP split of d gathered, x
    keeps its batch split and has whole rows, and the result is split as
    both (DTensor's own rule may split the fused H·hd columns where the
    heads cannot split, which the (H, hd) view then cannot express)."""
    if not is_placed(w):
        return torch.einsum("bsd,dhk->bshk", x, w)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    w_pl = [p if isinstance(p, Shard) and p.dim in (1, 2) else Replicate()
            for p in w.placements]
    x_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 and
            not isinstance(w_pl[i], Shard) else Replicate()
            for i, p in enumerate(x.placements)]
    o_pl = [Shard(0) if isinstance(xp, Shard) else
            Shard(wp.dim + 1) if isinstance(wp, Shard) else Replicate()
            for xp, wp in zip(x_pl, w_pl)]
    # a rank's gradients cover its own heads (x's) or rows (w's): pending
    # sums over the mesh dims that split the other operand
    xg_pl = [xp if isinstance(xp, Shard) else
             Partial() if isinstance(wp, Shard) else Replicate()
             for xp, wp in zip(x_pl, w_pl)]
    wg_pl = [wp if isinstance(wp, Shard) else
             Partial() if isinstance(xp, Shard) else Replicate()
             for xp, wp in zip(x_pl, w_pl)]
    return local_map(lambda x_, w_: torch.einsum("bsd,dhk->bshk", x_, w_),
                     out_placements=o_pl, in_placements=(x_pl, w_pl),
                     in_grad_placements=(xg_pl, wg_pl), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def out_project(params, attn_out: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", attn_out, params["wo"])


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention over a full sequence
# ---------------------------------------------------------------------------
def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sliding_window: int = 0,
    attention_sinks: int = 0,
    logit_softcap: float = 0.0,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    block_size: int = 512,
) -> torch.Tensor:
    """Memory-O(S·block) attention, a loop over KV blocks.

    q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd). Returns (B, Sq, H, hd).
    The one-shot prefill path (the reference has no Pallas kernel here
    either); each block's partial merges by the running-softmax rule.
    Placed operands (DTensors) attend on each rank's batch rows and heads
    (``on_local_shards``)."""
    if is_placed(q):
        kw = dict(causal=causal, sliding_window=sliding_window,
                  attention_sinks=attention_sinks,
                  logit_softcap=logit_softcap, block_size=block_size)
        if q_positions is None:
            q_positions = torch.arange(q.shape[1], device=q.device)[None]
        if kv_positions is None:
            kv_positions = torch.arange(k.shape[1], device=k.device)[None]
        return on_local_shards(
            lambda q_, k_, v_, qp, kp: blockwise_attention(
                q_, k_, v_, q_positions=qp, kv_positions=kp, **kw),
            (q, k, v), (q_positions, kv_positions))
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    group = H // k.shape[2]
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device)[None].expand(B, Sq)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=q.device)[None].expand(B, Skv)
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().transpose(1, 2) * scale                # (B, H, Sq, hd)
    qpos = q_positions[:, None, :, None]
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for j0 in range(0, Skv, block_size):
        kb = k[:, j0:j0 + block_size].float().repeat_interleave(group, dim=2)
        vb = v[:, j0:j0 + block_size].float().repeat_interleave(group, dim=2)
        posb = kv_positions[:, None, None, j0:j0 + block_size]
        s = torch.einsum("bhqk,bjhk->bhqj", qf, kb)
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        valid = posb >= 0
        if causal:
            valid = valid & (posb <= qpos)
        if sliding_window > 0:
            in_window = posb > qpos - sliding_window
            if attention_sinks > 0:
                in_window = in_window | (posb < attention_sinks)
            valid = valid & in_window
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqj,bjhk->bhqk", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                 # (B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Single-token decode over a dense head-major cache / the paged pool
# ---------------------------------------------------------------------------
def decode_attention_partial(q, k_cache, v_cache, cache_len, *,
                             k_scale=None, v_scale=None,
                             sliding_window: int = 0,
                             attention_sinks: int = 0,
                             logit_softcap: float = 0.0,
                             row_offset: int = 0) -> C.Partial:
    """Partial attention over the cached prefix (reference ``:175``).

    q: (B, H, hd) (RoPE applied); caches: HEAD-MAJOR (B, Hkv, S, hd);
    cache_len: (B,) = number of tokens stored (the new token is NOT there);
    k_scale/v_scale: the fp32 (B, Hkv, S) per-token scales of an int8
    cache; row_offset: the global position of the cache's first row (a
    slice of a sequence-split cache). Window masks are computed w.r.t.
    total length cache_len + 1.
    The dense decode kernel (bf16 or int8 entry) on the card, its plain
    twin on the CPU."""
    return ops.decode_partial(q, k_cache, v_cache, cache_len,
                              k_scale=k_scale, v_scale=v_scale,
                              sliding_window=sliding_window,
                              attention_sinks=attention_sinks,
                              logit_softcap=logit_softcap,
                              row_offset=row_offset)


def decode_attention_combine(q, k_cache, v_cache, cache_len, k_new, v_new,
                             *, sliding_window: int = 0,
                             attention_sinks: int = 0,
                             logit_softcap: float = 0.0,
                             k_scale=None, v_scale=None) -> torch.Tensor:
    """Full decode attention = combine(prefix partial, new-token partial)
    (reference ``:378``). k_new/v_new: (B, Hkv, hd) — the current token's
    keys/values, full precision (an int8 cache quantizes them only when
    it stores them); k_scale/v_scale: an int8 cache's scales. A placed
    cache is attended on each rank's shard (:func:`_placed_decode`)."""
    kw = dict(sliding_window=sliding_window, attention_sinks=attention_sinks,
              logit_softcap=logit_softcap)
    if is_placed(k_cache):
        return _placed_decode(q, k_cache, v_cache, cache_len, k_new, v_new,
                              k_scale, v_scale, **kw)
    return _decode_combine(q, k_cache, v_cache, cache_len, k_new, v_new,
                           k_scale=k_scale, v_scale=v_scale, **kw)


def _decode_combine(q, k_cache, v_cache, cache_len, k_new, v_new, *,
                    k_scale=None, v_scale=None, row_offset: int = 0,
                    reduce=None, **kw) -> torch.Tensor:
    p_prev = decode_attention_partial(q, k_cache, v_cache, cache_len,
                                      k_scale=k_scale, v_scale=v_scale,
                                      row_offset=row_offset, **kw)
    if reduce is not None:
        p_prev = reduce(p_prev)
    if k_new is None:                    # cross-attention: no new token
        return C.finalize(p_prev).to(q.dtype)
    p_new = _new_token_partial(q, k_new, v_new,
                               logit_softcap=kw["logit_softcap"])
    return C.finalize(C.combine(p_prev, p_new)).to(q.dtype)


def _placed_decode(q, k_cache, v_cache, cache_len, k_new, v_new, k_scale,
                   v_scale, **kw) -> torch.Tensor:
    """:func:`decode_attention_combine` over a placed (B, Hkv, S, hd) cache,
    computed on each rank's shard where it lies: the cache and its scales
    are never redistributed. Over a mesh dim that splits the batch or the
    kv heads, each rank attends its own rows or heads (q, the new token's
    K/V and the lengths follow the cache); over one that splits S (the seq
    partition), each rank's prefix partial covers its slice, the lengths
    and sinks taken relative to it (``row_offset``), and only the (a, s,
    m) triple crosses ranks (``psum_combine``) before the new token joins
    (``k_new=None``: no new token, the cross-attention's case). The result
    is placed as q's batch and heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.core.combine import psum_combine
    mesh = k_cache.device_mesh
    kpl = list(k_cache.placements)
    if any(not (p.is_replicate() or isinstance(p, Shard) and p.dim < 3)
           for p in kpl):
        raise ValueError(f"a placed decode cache is split over batch, kv "
                         f"heads or sequence; got {tuple(kpl)}")
    seq = [i for i, p in enumerate(kpl) if isinstance(p, Shard) and p.dim == 2]
    names = mesh.mesh_dim_names
    q_pl = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
            for p in kpl]
    len_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in kpl]

    def placed(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    def reduce(p):
        for i in seq:
            p = psum_combine(p, mesh, names[i])
        return p

    news = () if k_new is None else (placed(k_new), placed(v_new))
    scales = () if k_scale is None else (k_scale, v_scale)

    def local(q_, k_, v_, len_, *rest):
        kn_, vn_ = rest[:len(news)] if news else (None, None)
        sc = rest[len(news):]
        lo = 0
        for i in seq:                 # the slice's rank over the seq dims
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
        return _decode_combine(
            q_, k_, v_, len_, kn_, vn_, k_scale=sc[0] if sc else None,
            v_scale=sc[1] if sc else None, row_offset=lo * k_.shape[2],
            reduce=reduce, **kw)

    return local_map(
        local, out_placements=q_pl,
        in_placements=(q_pl, kpl, kpl, len_pl) + (q_pl,) * len(news) +
        (kpl,) * len(scales), device_mesh=mesh, redistribute_inputs=True)(
            placed(q), k_cache, v_cache, placed(cache_len), *news, *scales)


def _new_token_partial(q, k_new, v_new, *,
                       logit_softcap: float = 0.0) -> C.Partial:
    """The freshly projected token's 1-token §4.2.2 partial (B, H, ·)."""
    B, H, hd = q.shape
    Hkv = k_new.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, hd)
    p_new = C.partial_attention(qg, k_new[:, :, None, None],
                                v_new[:, :, None, None],
                                logit_softcap=logit_softcap)
    return C.Partial(a=p_new.a.reshape(B, H, hd),
                     s=p_new.s.reshape(B, H), m=p_new.m.reshape(B, H))


def decode_cross_attention(q, k_enc, v_enc) -> torch.Tensor:
    """One-token cross-attention over a HEAD-MAJOR encoder K/V (B, Hkv,
    S_enc, hd) whose rows are all live: q (B, H, hd) (no RoPE) -> (B, H,
    hd) in q's dtype. The dense decode kernel on the card (cache_len =
    S_enc for every sequence), its plain twin on the CPU. The reference
    runs its jnp partial and ``finalize`` here (``blocks.py:266``); the
    twin equals that at fp32 (a designed divergence: a CUDA tensor
    launches a kernel)."""
    B, H, hd = q.shape
    Hkv = k_enc.shape[1]
    full = torch.full((B,), k_enc.shape[2], dtype=torch.int32,
                      device=q.device)
    if is_placed(k_enc):
        return _placed_decode(q, k_enc, v_enc, full, None, None, None, None,
                              sliding_window=0, attention_sinks=0,
                              logit_softcap=0.0)
    o = _da.decode_attention(q.reshape(B, Hkv, H // Hkv, hd).contiguous(),
                             k_enc, v_enc, full)
    return o.reshape(B, H, hd)


def paged_decode_attention_partial_pos(q, k_pool, v_pool, block_tables,
                                       block_positions, cache_len, *,
                                       k_scale=None, v_scale=None,
                                       sliding_window: int = 0,
                                       attention_sinks: int = 0,
                                       logit_softcap: float = 0.0
                                       ) -> C.Partial:
    """Positions-aware paged partial for BLOCK-SHARDED tables (serving
    contract: window anchored to cache_len + 1): one worker's table holds
    a non-contiguous subset of a sequence's blocks, ``block_positions``
    (B, nb) each slot's global base position (POS_PAD on slots it does not
    own). The pool is read in place (the paged decode kernel on the card);
    int8 pools pass their scale pools."""
    return ops.paged_decode_partial_pos(
        q, k_pool, v_pool, block_tables, block_positions, cache_len,
        k_scale=k_scale, v_scale=v_scale, sliding_window=sliding_window,
        attention_sinks=attention_sinks, logit_softcap=logit_softcap)


def paged_decode_attention_combine(q, k_pool, v_pool, block_tables,
                                   cache_len, k_new, v_new, *,
                                   k_scale=None, v_scale=None,
                                   sliding_window: int = 0,
                                   attention_sinks: int = 0,
                                   logit_softcap: float = 0.0
                                   ) -> torch.Tensor:
    """Full paged decode attention = combine(pool partial, new-token
    partial). The pool is read in place through the block table (the paged
    decode kernel on the card) — one pass over the live KV plus the new
    token's k_new/v_new (B, Hkv, hd). int8 pools pass their scale pools
    (Hkv, num_blocks, bs); the new token's partial stays full precision
    (it is quantized only when the pool stores it)."""
    p_prev = ops.paged_decode_partial(
        q, k_pool, v_pool, block_tables, cache_len, k_scale=k_scale,
        v_scale=v_scale, sliding_window=sliding_window,
        attention_sinks=attention_sinks, logit_softcap=logit_softcap)
    p_new = _new_token_partial(q, k_new, v_new, logit_softcap=logit_softcap)
    return C.finalize(C.combine(p_prev, p_new)).to(q.dtype)


# ---------------------------------------------------------------------------
# Full layer entry points
# ---------------------------------------------------------------------------
def attention_forward(params, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, is_local: bool = False,
                      block_size: int = 512,
                      prefix_kv: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                      paged_prefix: Optional[Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]] = None,
                      paged_prefix_scales: Optional[Tuple[torch.Tensor,
                                                          torch.Tensor]] = None):
    """Full-sequence attention (prefill). x: (B, S, d). Returns
    (y, k, v) with k/v (B, S, Hkv, hd) for the tokens of ``x``.

    ``prefix_kv``: HEAD-MAJOR (B, Hkv, P, hd) K/V of an already-cached
    prompt prefix (the prefix-sharing suffix prefill, reference ``:442``):
    ``x`` then holds only the suffix at global ``positions`` P + i and its
    queries attend over concat(prefix, suffix) keys by the same blockwise
    path as a full prefill, so windows, sinks and softcaps follow. The
    returned k/v cover the suffix only.

    ``paged_prefix``: this layer's ``(k_pool, v_pool, block_table)`` —
    head-major pool slices plus the sequence's first ``nb`` block ids
    (P = nb·bs tokens already in the pool); ``x`` then holds one prefill
    chunk at global ``positions`` P + i and its queries attend over the
    prefix read in place plus the chunk itself (the chunk-prefill kernel on
    the card). Requires B == 1, the serving prefill shape.
    ``paged_prefix_scales``: the layer's ``(k_scale, v_scale)`` pools when
    the pool is int8 (the int8 chunk kernel on the card)."""
    q, k, v = qkv_project(params, cfg, x, positions)
    window = cfg.sliding_window if (is_local or not cfg.local_global) else 0
    sinks = cfg.attention_sinks if window else 0
    if paged_prefix is not None:
        if x.shape[0] != 1:
            raise ValueError("paged_prefix serves the per-request prefill "
                             f"shape (B == 1); got B={x.shape[0]}")
        kp_pool, vp_pool, table = paged_prefix
        ks_pool, vs_pool = paged_prefix_scales or (None, None)
        out = paged_prefill_chunk_attention(
            q[0].contiguous(), kp_pool, vp_pool, table, k[0].contiguous(),
            v[0].contiguous(), k_scale=ks_pool, v_scale=vs_pool,
            sliding_window=int(window),
            attention_sinks=sinks, logit_softcap=cfg.attn_logit_softcap)[None]
        return out_project(params, out), k, v
    k_all, v_all = k, v
    if prefix_kv is not None:        # head-major -> seq-major for blockwise
        pk, pv = prefix_kv
        k_all = torch.cat([pk.transpose(1, 2), k], dim=1)
        v_all = torch.cat([pv.transpose(1, 2), v], dim=1)
    out = blockwise_attention(
        q, k_all, v_all, causal=True, sliding_window=int(window),
        attention_sinks=sinks, logit_softcap=cfg.attn_logit_softcap,
        q_positions=positions, block_size=block_size)
    return out_project(params, out), k, v


def attention_decode_step(params, cfg: ModelConfig, x: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          cache_len: torch.Tensor, *, is_local: bool = False,
                          k_scale=None, v_scale=None):
    """One-token decode over a dense head-major cache (reference ``:506``).
    x: (B, 1, d); caches (B, Hkv, S, hd); cache_len = tokens ALREADY
    stored; k_scale/v_scale: the (B, Hkv, S) scales of an int8 cache.
    Returns (y, k_new, v_new) with k_new/v_new (B, Hkv, hd) — the caller
    owns KV placement (``transformer.apply_decode_updates``)."""
    positions = cache_len[:, None]  # new token position, 0-based
    q, k, v = qkv_project(params, cfg, x, positions)
    window = cfg.sliding_window if (is_local or not cfg.local_global) else 0
    out = decode_attention_combine(
        q[:, 0], k_cache, v_cache, cache_len, k[:, 0], v[:, 0],
        sliding_window=int(window),
        attention_sinks=cfg.attention_sinks if window else 0,
        logit_softcap=cfg.attn_logit_softcap, k_scale=k_scale,
        v_scale=v_scale)
    y = out_project(params, out[:, None])
    return y, k[:, 0], v[:, 0]


def attention_decode_step_paged(params, cfg: ModelConfig, x: torch.Tensor,
                                k_pool: torch.Tensor, v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                cache_len: torch.Tensor, *,
                                is_local: bool = False,
                                k_scale=None, v_scale=None):
    """One-token decode straight over the paged block pool. x: (B, 1, d);
    pools HEAD-MAJOR (Hkv, num_blocks, block_size, hd); block_tables
    (B, nb); cache_len = tokens ALREADY stored; k_scale/v_scale: the
    layer's scale pools when the pool is int8. Returns (y, k_new, v_new) —
    KV placement stays the memory pool's job (serving/kvcache.py)."""
    positions = cache_len[:, None]  # new token position, 0-based
    q, k, v = qkv_project(params, cfg, x, positions)
    window = cfg.sliding_window if (is_local or not cfg.local_global) else 0
    out = paged_decode_attention_combine(
        q[:, 0], k_pool, v_pool, block_tables, cache_len, k[:, 0], v[:, 0],
        k_scale=k_scale, v_scale=v_scale, sliding_window=int(window),
        attention_sinks=cfg.attention_sinks if window else 0,
        logit_softcap=cfg.attn_logit_softcap)
    y = out_project(params, out[:, None])
    return y, k[:, 0], v[:, 0]
