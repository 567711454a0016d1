"""Model assembly: embedding -> layer stack -> head, for the dense family.
Port of ``repro/models/transformer.py`` (dense/vlm stacks):

    init_params(seed, cfg, device=...)                      -> params
    params_from_jax(np_tree, cfg, device)                   -> params
    prefill(params, cfg, batch, max_seq, device=...)        -> (logits, cache)
    prefill_chunk(params, cfg, batch, k_pool, v_pool, prefix_blocks, ...,
                  k_scale_pool=None, v_scale_pool=None)
    decode_step_paged(params, cfg, tokens, k_pool, v_pool, block_tables,
                      cache_len, ..., k_scale_pool=None,
                      v_scale_pool=None)                    -> (logits, updates)

Per-layer parameters are stacked on axis 0 exactly as in the reference
pytree; a Python loop over layers replaces ``lax.scan``. Each function takes
``device`` (default ``"cuda"``) and moves its integer inputs there; on a
machine without a GPU a call that does not pass ``device="cpu"`` raises.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import blocks
from repro_torch.models.common import (ModelConfig, Params, dense_init,
                                       resolve_device, rms_norm, softcap)

DENSE_FAMILIES = ("dense", "vlm")


def _check_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in DENSE_FAMILIES:
        raise NotImplementedError(
            f"{what} is ported for the dense/vlm families; got "
            f"family={cfg.family!r}")


def _tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(layers: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters out of the stacked tree (views, no copy)."""
    return _tree_map(lambda a: a[i], layers)


def _is_local(cfg: ModelConfig, i: int) -> bool:
    return cfg.local_global and i % 2 == 0


def _int_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.int32, device=device)


# ===========================================================================
# Init
# ===========================================================================
def init_params(seed: int, cfg: ModelConfig, *, device="cuda") -> Params:
    """Random weights from ``seed`` with the reference's init rules
    (truncated-normal fan-in ``dense_init``, zero norm weights), drawn by a
    ``torch.Generator`` on ``device``. Layers are filled one at a time into
    preallocated stacked tensors, so peak memory is the model plus one
    layer's fp32 draw."""
    _check_family(cfg, "init_params")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: Params = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), cfg.dtype,
                            dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                       cfg.dtype, dev)
    blk = blocks.init_dense_block(gen, cfg, dev)
    layers = _tree_map(lambda a: torch.empty((cfg.num_layers, *a.shape),
                                             dtype=a.dtype, device=dev), blk)
    for i in range(cfg.num_layers):
        if i:
            blk = blocks.init_dense_block(gen, cfg, dev)
        for dst, src in _leaf_pairs(layers, blk):
            dst[i].copy_(src)
    params["layers"] = layers
    return params


def _leaf_pairs(a: Dict, b: Dict):
    """(a_leaf, b_leaf) pairs of two dicts of the same structure."""
    for k, v in b.items():
        if isinstance(v, dict):
            yield from _leaf_pairs(a[k], v)
        else:
            yield a[k], v


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device) -> Params:
    """The reference ``init_params`` pytree (stacked layers on axis 0, leaves
    converted to numpy arrays) as the port's parameters, value for value.
    bfloat16 leaves cross as their 16-bit patterns."""
    _check_family(cfg, "params_from_jax")
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a.copy()).to(dev)
    return _tree_map(conv, np_tree)


# ===========================================================================
# Embedding / head
# ===========================================================================
def _embed_tokens(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    tok = params["embed"][tokens.long()]
    if cfg.tie_embeddings:
        scale = torch.sqrt(torch.tensor(float(cfg.d_model)))
        tok = tok * scale.to(device=tok.device, dtype=tok.dtype)
    return tok


def _embed(params: Params, cfg: ModelConfig, batch: Dict,
           device) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (x, positions, n_frontend)."""
    tok = _embed_tokens(params, cfg, _int_tensor(batch["tokens"], device))
    n_front = 0
    if cfg.modality in ("vision", "audio_embeds") and "frontend" in batch:
        front = torch.as_tensor(batch["frontend"], device=device).to(tok.dtype)
        tok = torch.cat([front, tok], dim=1)
        n_front = front.shape[1]
    B, S = tok.shape[:2]
    positions = torch.arange(S, device=device)[None].expand(B, S)
    return tok, positions, n_front


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["embed"].t())
    else:
        logits = torch.matmul(x, params["lm_head"])
    return softcap(logits, cfg.final_logit_softcap)


def _hm(kv: torch.Tensor) -> torch.Tensor:
    """Stacked (L, B, S, Hkv, hd) -> head-major (L, B, Hkv, S, hd)."""
    return kv.transpose(2, 3).contiguous()


# ===========================================================================
# Prefill
# ===========================================================================
def prefill(params: Params, cfg: ModelConfig, batch: Dict, max_seq: int, *,
            device="cuda") -> Tuple[torch.Tensor, Dict]:
    """Run the prompt one-shot (plain blockwise attention), return
    (last-position logits, cache) with head-major K/V (L, B, Hkv, max_seq,
    hd) and len."""
    _check_family(cfg, "prefill")
    dev = resolve_device(device)
    x, positions, _ = _embed(params, cfg, batch, dev)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, c = blocks.dense_block(_layer(params["layers"], i), cfg, x,
                                  mode="prefill", positions=positions,
                                  is_local=_is_local(cfg, i))
        ks.append(c["k"])
        vs.append(c["v"])
    S = x.shape[1]
    k, v = _hm(torch.stack(ks)), _hm(torch.stack(vs))
    if max_seq != S:
        pad = max(max_seq - S, 0)
        k = torch.nn.functional.pad(k[..., :max_seq, :], (0, 0, 0, pad))
        v = torch.nn.functional.pad(v[..., :max_seq, :], (0, 0, 0, pad))
    cache = {"k": k, "v": v,
             "len": torch.full((x.shape[0],), S, dtype=torch.int32,
                               device=dev)}
    return _head(params, cfg, x[:, -1]), cache


def prefill_chunk(params: Params, cfg: ModelConfig, batch: Dict,
                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                  prefix_blocks, *, k_scale_pool=None, v_scale_pool=None,
                  device="cuda") -> Tuple[torch.Tensor, Dict]:
    """Chunked paged prefill: run ONE block-aligned chunk of a prompt, its
    queries attending over the already-written pool blocks plus the in-chunk
    causal mask (the chunk-prefill kernel on the card).

    batch["tokens"]: (1, C); k_pool/v_pool: HEAD-MAJOR (L, Hkv, num_blocks,
    bs, hd) — the PagedKVCache pools by reference; prefix_blocks: (nb,)
    pool ids of the sequence's first nb blocks, all fully written
    (P = nb·bs; nb = 0 is the first chunk of a fresh prompt);
    k_scale_pool/v_scale_pool: (L, Hkv, num_blocks, bs) fp32 scale pools of
    an int8 pool (the int8 chunk kernel on the card). Returns
    (last-position logits, {"k", "v", "len"}) with CHUNK-ONLY head-major
    K/V (L, 1, Hkv, C, hd) and len = P + C."""
    _check_family(cfg, "chunked paged prefill")
    dev = resolve_device(device)
    tokens = _int_tensor(batch["tokens"], dev)
    if tokens.shape[0] != 1:
        raise ValueError("chunked paged prefill is per-request (B == 1); "
                         f"got B={tokens.shape[0]}")
    table = _int_tensor(prefix_blocks, dev).reshape(-1)
    P = table.shape[0] * k_pool.shape[3]
    x, positions, _ = _embed(params, cfg, {"tokens": tokens}, dev)
    positions = positions + P           # chunk tokens sit at P + i
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, c = blocks.dense_block(_layer(params["layers"], i), cfg, x,
                                  mode="prefill", positions=positions,
                                  is_local=_is_local(cfg, i),
                                  paged_prefix=(k_pool[i], v_pool[i], table),
                                  paged_prefix_scales=None
                                  if k_scale_pool is None else
                                  (k_scale_pool[i], v_scale_pool[i]))
        ks.append(c["k"])
        vs.append(c["v"])
    cache = {"k": _hm(torch.stack(ks)), "v": _hm(torch.stack(vs)),
             "len": torch.full((1,), P + x.shape[1], dtype=torch.int32,
                               device=dev)}
    return _head(params, cfg, x[:, -1]), cache


# ===========================================================================
# Decode step (the paper's target phase)
# ===========================================================================
def decode_step_paged(params: Params, cfg: ModelConfig, tokens,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      block_tables, cache_len, *, k_scale_pool=None,
                      v_scale_pool=None,
                      device="cuda") -> Tuple[torch.Tensor, Dict]:
    """One decoding iteration straight over the paged KV block pool (the
    paged decode kernel on the card, no per-step dense gather).

    tokens: (B,) int; k_pool/v_pool: HEAD-MAJOR (L, Hkv, num_blocks,
    block_size, hd); block_tables: (B, nb) int; cache_len: (B,) tokens
    ALREADY stored; k_scale_pool/v_scale_pool: (L, Hkv, num_blocks, bs)
    fp32 scale pools of an int8 pool (the int8 decode kernel on the card).
    Returns (logits, updates) with k_new/v_new (L, B, Hkv, hd) — placement
    stays the memory pool's job (PagedKVCache.write_tokens).
    """
    _check_family(cfg, "paged decode")
    dev = resolve_device(device)
    tok = _int_tensor(tokens, dev)
    tables = _int_tensor(block_tables, dev)
    lens = _int_tensor(cache_len, dev)
    x = _embed_tokens(params, cfg, tok[:, None])
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lc = {"k_pool": k_pool[i], "v_pool": v_pool[i],
              "block_tables": tables, "len": lens}
        if k_scale_pool is not None:
            lc.update(k_scale=k_scale_pool[i], v_scale=v_scale_pool[i])
        x, c = blocks.dense_block(_layer(params["layers"], i), cfg, x,
                                  mode="decode", cache=lc,
                                  is_local=_is_local(cfg, i))
        ks.append(c["k_new"])
        vs.append(c["v_new"])
    updates = {"k_new": torch.stack(ks), "v_new": torch.stack(vs),
               "len": lens + 1}
    return _head(params, cfg, x[:, 0]), updates
