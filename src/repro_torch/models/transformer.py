"""Model assembly: embedding -> layer stack -> head.
Port of ``repro/models/transformer.py`` for the dense/vlm/moe stacks, rwkv6
(family ``ssm``), zamba2 (family ``hybrid``) and seamless-m4t-medium's
encoder-decoder (family ``audio``):

    init_params(seed, cfg, device=...)                      -> params
    params_from_jax(np_tree, cfg, device)                   -> params
    forward(params, cfg, batch, device=...)                 -> (logits, aux)
    loss_fn(params, cfg, batch, device=...)                 -> (loss, metrics)
    init_cache(cfg, batch, max_seq, device=...)             -> cache
    prefill(params, cfg, batch, max_seq, device=..., length=None)
                                                            -> (logits, cache)
    prefill_suffix(params, cfg, batch, k_prefix, v_prefix, device=...,
                   length=None)                             (dense/vlm/moe)
    decode_step(params, cfg, tokens, cache, device=...)     -> (logits, updates)
    apply_decode_updates(cache, updates)                    -> cache
    prefill_chunk(params, cfg, batch, k_pool, v_pool, prefix_blocks, ...,
                  k_scale_pool=None, v_scale_pool=None, length=None)
                                                            (dense/vlm/moe)
    decode_step_paged(params, cfg, tokens, k_pool, v_pool, block_tables,
                      cache_len, ..., k_scale_pool=None,
                      v_scale_pool=None)                    -> (logits, updates)

Per-layer parameters are stacked on axis 0 exactly as in the reference
pytree (zamba2's mamba layers on (n_super, period) axes; seamless's
encoder layers in ``params["enc_layers"]``, its decoder layers in
``params["layers"]``); a Python loop over layers replaces ``lax.scan``.
``params["layers"]`` may instead be a LIST of per-layer trees (zamba2: a
list over superblocks of lists of mamba layers, and ``params["tail"]`` a
list), the reference's listed layout
(``transformer.py:132``): ``forward``, ``prefill`` and ``decode_step`` then
return per-layer lists of cache entries, as the reference's
``_decode_step_listed`` does. Each function takes ``device`` (default
``"cuda"``) and moves its integer inputs there; on a machine without a GPU
a call that does not pass ``device="cpu"`` raises. With ``kv_cache_bits ==
8`` the dense/vlm cache is int8 with fp32 per-token scales ("k_scale",
"v_scale", (L, B, Hkv, S)), read by the dense decode kernel's int8 entry;
the paged entry points serve int8 pools.

An audio model's ``batch`` also holds "frames": (B, S_enc, d) frame
embeddings (the stubbed audio frontend) that the encoder consumes; its
cache adds the decoder layers' cross K/V "ck"/"cv" (L, B, Hkv, S_enc, hd),
filled by ``prefill`` and only read after it. Its decode step launches the
dense decode kernel twice a layer (self- and cross-attention). Like the
reference, ``LLMEngine`` and the paged entry points do not serve it.

The three prefill entry points also run on PADDED operands, the static
buffers of the engine's compiled prefill programs (``serving/compiled.py``):
``length`` is then a (B,) int device tensor of real rows, pad tokens sit
after them (causal masking keeps them out of every real row's attention),
the logits are the last real row's, picked by a device index, and the
cache's ``len`` counts real rows. Without ``length`` nothing changes. A
moe model refuses padded operands: pad rows would join its routing groups
and change the experts' capacity (``models/moe.py``), so its programs run
at exact lengths. ``decode_step`` and ``decode_step_paged`` take the
reference's ``moe_group_size``; the prefill entry points route in groups
of 256 tokens, as the reference's do.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import functools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.models import blocks, kv_quant, ssm
from repro_torch.models.common import (ModelConfig, Params,
                                       constrain_activation as _constrain,
                                       cross_entropy_loss, dense_init,
                                       embed_lookup,
                                       resolve_device, rms_norm, softcap)
from repro_torch.tree import tree_leaves, tree_map

# the KV-cache stacks: the paged entry points and LLMEngine serve these
DENSE_FAMILIES = ("dense", "vlm", "moe")
# families the dense-cache entry points (init_params, forward, init_cache,
# prefill, decode_step) serve
SERVE_FAMILIES = DENSE_FAMILIES + ("ssm", "hybrid", "audio")


def _check_family(cfg: ModelConfig, what: str,
                  families: Tuple[str, ...] = DENSE_FAMILIES) -> None:
    if cfg.family not in families:
        raise NotImplementedError(
            f"{what} is ported for the families {families}; got "
            f"family={cfg.family!r}")


def _is_listed(params: Params) -> bool:
    return isinstance(params["layers"], (list, tuple))


def _per_layer(items, listed: bool):
    """Per-layer cache entries: the listed layout's list, or stacked."""
    return list(items) if listed else torch.stack(list(items))


def _layer(layers, i: int):
    """Layer ``i``'s parameters: the list's entry (listed layout), or
    views into the stacked tree (no copy)."""
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return tree_map(lambda a: a[i], layers)


def _is_local(cfg: ModelConfig, i: int) -> bool:
    return cfg.local_global and i % 2 == 0


def _check_unpadded(cfg: ModelConfig, length) -> None:
    """A moe model refuses padded prefill operands (module docstring)."""
    if length is not None and cfg.family == "moe":
        raise ValueError("a moe model's prefill takes no padded operands: "
                         "pad rows would join its routing groups and change "
                         "the experts' capacity")


def _int_tensor(x, device) -> torch.Tensor:
    """``x`` as an int32 tensor on ``device``; one that already is (a
    placed one included) is used as it is."""
    if torch.is_tensor(x) and x.dtype == torch.int32 and x.device == device:
        return x
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.int32, device=device)


def _zamba_split(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(superblocks, mamba layers per superblock, tail mamba layers)."""
    period = cfg.shared_attn_period
    n_super = cfg.num_layers // period
    return n_super, period, cfg.num_layers - n_super * period


# ===========================================================================
# Init
# ===========================================================================
def init_params(seed: int, cfg: ModelConfig, *, device="cuda") -> Params:
    """Random weights from ``seed`` with the reference's init rules
    (truncated-normal fan-in ``dense_init``, zero norm weights), drawn by a
    ``torch.Generator`` on ``device``. Layers are filled one at a time into
    preallocated stacked tensors, so peak memory is the model plus one
    layer's fp32 draw. On the meta device the tree holds shapes and dtypes
    only (no generator: nothing is drawn), as ``jax.eval_shape`` gives."""
    _check_family(cfg, "init_params", SERVE_FAMILIES)
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
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
    if cfg.family == "ssm":          # rwkv6
        params["layers"] = _stacked_init(gen, cfg, dev, (cfg.num_layers,),
                                         blocks.init_rwkv_block)
    elif cfg.family == "hybrid":     # zamba2
        n_super, period, tail = _zamba_split(cfg)
        params["layers"] = _stacked_init(gen, cfg, dev, (n_super, period),
                                         blocks.init_mamba_block)
        if tail:
            params["tail"] = _stacked_init(gen, cfg, dev, (tail,),
                                           blocks.init_mamba_block)
        params["shared_attn"] = blocks.init_dense_block(gen, cfg, dev)
    elif cfg.family == "audio":      # seamless enc-dec
        params["enc_layers"] = _stacked_init(gen, cfg, dev,
                                             (cfg.encoder_layers,),
                                             blocks.init_encoder_block)
        params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                         device=dev)
        params["layers"] = _stacked_init(gen, cfg, dev, (cfg.num_layers,),
                                         blocks.init_decoder_block)
    else:
        params["layers"] = _stacked_init(
            gen, cfg, dev, (cfg.num_layers,),
            functools.partial(blocks.init_dense_block,
                              use_moe=cfg.family == "moe"))
    return params


def _stacked_init(gen, cfg: ModelConfig, dev, lead: Tuple[int, ...],
                  init_fn) -> Dict:
    """Stack ``prod(lead)`` layers drawn by ``init_fn`` on the ``lead``
    axes, drawing and copying one layer at a time (one layer is viewed
    with its lead axes, not copied)."""
    n = int(np.prod(lead))
    blk = init_fn(gen, cfg, dev)
    if n == 1:
        return tree_map(lambda a: a.view(*lead, *a.shape), blk)
    layers = tree_map(lambda a: torch.empty((*lead, *a.shape),
                                             dtype=a.dtype, device=dev), blk)
    if dev.type == "meta":                   # shapes only: nothing to copy
        return layers
    flat = tree_map(lambda a: a.view(n, *a.shape[len(lead):]), layers)
    for i in range(n):
        if i:
            blk = init_fn(gen, cfg, dev)
        for dst, src in zip(tree_leaves(flat), tree_leaves(blk)):
            dst[i].copy_(src)
    return layers


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig,
                    device) -> Params:
    """The reference ``init_params`` pytree (stacked layers on axis 0, or
    the listed layout's lists of per-layer trees; leaves converted to numpy
    arrays) as the port's parameters, value for value and structure for
    structure. bfloat16 leaves cross as their 16-bit patterns."""
    _check_family(cfg, "params_from_jax", SERVE_FAMILIES)
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a.copy()).to(dev)
    return tree_map(conv, np_tree)


# ===========================================================================
# Embedding / head
# ===========================================================================
def _embed_tokens(params: Params, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    tok = embed_lookup(params["embed"], tokens)
    if cfg.tie_embeddings:
        # sqrt(d) rounded to the model dtype on the host: a Python scalar,
        # so a captured decode step copies nothing host -> device here
        scale = torch.sqrt(torch.tensor(float(cfg.d_model)))
        tok = tok * scale.to(tok.dtype).item()
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


def _last_rows(x: torch.Tensor, length) -> torch.Tensor:
    """Each sequence's last real row of x (B, S, d): row S - 1, or, for
    padded rows, row ``length - 1`` picked on the device (no host sync, so
    a captured graph can run it)."""
    if length is None:
        return x[:, -1]
    idx = (length.long() - 1).view(-1, 1, 1).expand(x.shape[0], 1,
                                                    x.shape[2])
    return x.gather(1, idx)[:, 0]


def _cache_len(x: torch.Tensor, length, start: int) -> torch.Tensor:
    """The cache's ``len``: ``start`` plus the real rows of x (B, S, d)."""
    if length is None:
        return torch.full((x.shape[0],), start + x.shape[1],
                          dtype=torch.int32, device=x.device)
    return (length + start).to(torch.int32).expand(x.shape[0])


def _pad_seq(kv: torch.Tensor, max_seq: int) -> torch.Tensor:
    """Pad with zeros or trim the sequence axis (-2) to ``max_seq``."""
    S = kv.shape[-2]
    if S >= max_seq:
        return kv[..., :max_seq, :].contiguous()
    return F.pad(kv, (0, 0, 0, max_seq - S))


# ===========================================================================
# Layer stacks (full sequence: mode "train" or "prefill")
# ===========================================================================
def _maybe_remat(fn: Callable, cfg: ModelConfig, mode: str) -> Callable:
    """``fn`` under activation checkpointing when ``cfg.remat`` and ``mode
    == "train"`` (reference ``:39``) and autograd records: its activations
    are dropped after the forward and recomputed in the backward. Memory
    changes, values do not."""
    if not (cfg.remat and mode == "train" and torch.is_grad_enabled()):
        return fn
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _dense_stack(params, cfg: ModelConfig, x, positions, *, mode: str,
                 moe_group_size: int = 256):
    """Returns (x, aux, [per-layer {"k", "v"}] when prefilling); aux is
    the sum over layers of the moe router's aux loss (fp32; the constant
    0.0 without moe layers, so the serving paths launch nothing for it).
    Each layer is one remat unit."""
    caches = []
    aux = 0.0
    for i in range(cfg.num_layers):
        def run(p_, h_, _loc=_is_local(cfg, i)):
            return blocks.dense_block(p_, cfg, h_, mode=mode,
                                      positions=positions, is_local=_loc,
                                      moe_group_size=moe_group_size)

        x, c, a = _maybe_remat(run, cfg, mode)(_layer(params["layers"], i), x)
        x = _constrain(x)
        caches.append(c)
        aux = aux + a
    return x, aux, caches


def _rwkv_stack(params, cfg: ModelConfig, x, *, mode: str):
    """Returns (x, [per-layer state]). Each layer is one remat unit."""
    run = _maybe_remat(
        lambda p_, h_: blocks.rwkv_block(p_, cfg, h_, mode=mode), cfg, mode)
    states = []
    for i in range(cfg.num_layers):
        x, st = run(_layer(params["layers"], i), x)
        x = _constrain(x)
        states.append(st)
    return x, states


def _zamba_stack(params, cfg: ModelConfig, x, positions, *, mode: str):
    """The shared attention block, then ``period`` mamba layers, per
    superblock (one remat unit, as in the reference); then the tail mamba
    layers (not rematerialised). Returns (x, [per-superblock attention
    cache], [per-superblock [per-layer mamba state]], [per-tail-layer
    mamba state])."""
    n_super, period, tail = _zamba_split(cfg)

    def superblock(shared, sup, h):
        h, c, _ = blocks.dense_block(shared, cfg, h, mode=mode,
                                     positions=positions)
        states = []
        for mi in range(period):
            h, st = blocks.mamba_block(_layer(sup, mi), cfg, h, mode=mode)
            states.append(st)
        return h, c, states

    run = _maybe_remat(superblock, cfg, mode)
    attn_caches, mstates, tail_states = [], [], []
    for si in range(n_super):
        x, c, states = run(params["shared_attn"],
                           _layer(params["layers"], si), x)
        x = _constrain(x)
        attn_caches.append(c)
        mstates.append(states)
    for ti in range(tail):
        x, st = blocks.mamba_block(_layer(params["tail"], ti), cfg, x,
                                   mode=mode)
        tail_states.append(st)
    return x, attn_caches, mstates, tail_states


def _encdec_stacks(params, cfg: ModelConfig, batch: Dict, *, mode: str,
                   device):
    """The encoder over batch["frames"] (B, S_enc, d), its final norm, then
    the decoder over batch["tokens"], each layer's cross K/V projected
    from the encoder output. Returns (x, [per-layer cache]); at prefill a
    layer's cache also holds its cross K/V "ck"/"cv" (B, S_enc, Hkv,
    hd). Each encoder layer and each decoder layer (with its cross K/V
    projection) is one remat unit."""
    frames = torch.as_tensor(batch["frames"]).to(device=device,
                                                  dtype=cfg.dtype)
    B, S_enc, _ = frames.shape
    enc_pos = torch.arange(S_enc, device=device)[None].expand(B, S_enc)
    enc_run = _maybe_remat(
        lambda p_, h_: blocks.encoder_block(p_, cfg, h_, enc_pos), cfg, mode)
    enc_out = frames
    for i in range(cfg.encoder_layers):
        enc_out = _constrain(enc_run(_layer(params["enc_layers"], i),
                                     enc_out))
    enc_out = rms_norm(enc_out, params["enc_norm"], cfg.norm_eps)
    # the reference's decoder embeds without the tied-embedding scale
    x = embed_lookup(params["embed"], _int_tensor(batch["tokens"], device))
    S_dec = x.shape[1]
    dec_pos = torch.arange(S_dec, device=device)[None].expand(B, S_dec)

    def run(p_, h_):
        ekv = blocks.encoder_cross_kv(p_, cfg, enc_out)
        h_, c = blocks.decoder_block(p_, cfg, h_, ekv, mode=mode,
                                     positions=dec_pos)
        if mode == "prefill":
            c = dict(c, ck=ekv[0], cv=ekv[1])
        return h_, c

    dec_run = _maybe_remat(run, cfg, mode)
    caches = []
    for i in range(cfg.num_layers):
        x, c = dec_run(_layer(params["layers"], i), x)
        x = _constrain(x)
        caches.append(c)
    return x, caches


# ===========================================================================
# Full-sequence forward
# ===========================================================================
def forward(params: Params, cfg: ModelConfig, batch: Dict, *,
            device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (B, S, vocab) and the aux loss: the moe
    router's load-balance loss summed over layers (fp32 scalar; zero for
    every other family), as the reference returns them. With
    ``cfg.remat`` and autograd recording, each layer (zamba2: each
    superblock) is recomputed in the backward (``_maybe_remat``)."""
    _check_family(cfg, "forward", SERVE_FAMILIES)
    dev = resolve_device(device)
    aux = 0.0
    if cfg.family == "audio":
        x, _ = _encdec_stacks(params, cfg, batch, mode="train", device=dev)
    else:
        x, positions, n_front = _embed(params, cfg, batch, dev)
        if cfg.family == "ssm":
            x, _ = _rwkv_stack(params, cfg, x, mode="train")
        elif cfg.family == "hybrid":
            x = _zamba_stack(params, cfg, x, positions, mode="train")[0]
        else:
            x, aux, _ = _dense_stack(params, cfg, x, positions, mode="train")
            x = x[:, n_front:]
    if not torch.is_tensor(aux):             # no moe layer: the constant 0
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    return _head(params, cfg, x), aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict, *,
            device="cuda") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss (reference ``:338``): ``ce + router_aux_weight ·
    aux`` and {"ce", "aux"}. ``batch`` may hold "labels" (default: the
    next token, 0 past the end) and a "mask" over positions."""
    dev = resolve_device(device)
    logits, aux = forward(params, cfg, batch, device=dev)
    labels = batch.get("labels")
    if labels is None:
        labels = F.pad(_int_tensor(batch["tokens"], dev)[:, 1:], (0, 1))
    labels = _int_tensor(labels, dev)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
    ce = cross_entropy_loss(logits, labels, mask)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


# ===========================================================================
# KV cache / recurrent state
# ===========================================================================
def _int8_cache(cfg: ModelConfig) -> bool:
    """The dense/vlm cache is int8 with per-token scales (the reference
    quantizes only the KV-cache dense stacks)."""
    return cfg.family in DENSE_FAMILIES and cfg.kv_cache_bits == 8


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> Dict:
    """Zero-filled decode cache: head-major K/V (L, B, Hkv, max_seq, hd) for
    the dense family (int8 with fp32 "k_scale"/"v_scale" (L, B, Hkv,
    max_seq) when ``kv_cache_bits == 8``); the rwkv state {"S", "x_tm",
    "x_cm"} stacked over layers; zamba2's shared-attention K/V (n_super, B,
    Hkv, max_seq, hd), mamba states "h" (n_super, period, B, H, P, N) fp32
    and "conv" (n_super, period, B, K-1, conv_ch), plus
    "tail_h"/"tail_conv"; an audio model's decoder K/V and its empty cross
    K/V "ck"/"cv" (L, B, Hkv, 0, hd), sized by the encoder at prefill."""
    _check_family(cfg, "init_cache", SERVE_FAMILIES)
    dev = resolve_device(device)
    hd = cfg.resolved_head_dim
    L = cfg.num_layers
    f32 = dict(dtype=torch.float32, device=dev)
    model = dict(dtype=cfg.dtype, device=dev)
    cache: Dict[str, Any] = {"len": torch.zeros((batch,), dtype=torch.int32,
                                                device=dev)}
    if cfg.family == "ssm":
        H, P = ssm.rwkv_dims(cfg)
        cache["S"] = torch.zeros((L, batch, H, P, P), **f32)
        cache["x_tm"] = torch.zeros((L, batch, cfg.d_model), **model)
        cache["x_cm"] = torch.zeros((L, batch, cfg.d_model), **model)
    elif cfg.family == "hybrid":
        n_super, period, tail = _zamba_split(cfg)
        d_inner, H, P, N = ssm.mamba_dims(cfg)
        conv = (cfg.ssm_conv - 1, d_inner + 2 * N)
        cache["k"] = torch.zeros(
            (n_super, batch, cfg.num_kv_heads, max_seq, hd), **model)
        cache["v"] = torch.zeros_like(cache["k"])
        cache["h"] = torch.zeros((n_super, period, batch, H, P, N), **f32)
        cache["conv"] = torch.zeros((n_super, period, batch, *conv), **model)
        if tail:
            cache["tail_h"] = torch.zeros((tail, batch, H, P, N), **f32)
            cache["tail_conv"] = torch.zeros((tail, batch, *conv), **model)
    elif cfg.family == "audio":
        cache["k"] = torch.zeros((L, batch, cfg.num_kv_heads, max_seq, hd),
                                 **model)
        cache["v"] = torch.zeros_like(cache["k"])
        cache["ck"] = torch.zeros((L, batch, cfg.num_kv_heads, 0, hd),
                                  **model)
        cache["cv"] = torch.zeros_like(cache["ck"])
    else:
        kv = dict(dtype=torch.int8, device=dev) if _int8_cache(cfg) \
            else model
        cache["k"] = torch.zeros((L, batch, cfg.num_kv_heads, max_seq, hd),
                                 **kv)
        cache["v"] = torch.zeros_like(cache["k"])
        if _int8_cache(cfg):     # per-token, per-kv-head scales (paper §7)
            cache["k_scale"] = torch.zeros(
                (L, batch, cfg.num_kv_heads, max_seq), **f32)
            cache["v_scale"] = torch.zeros_like(cache["k_scale"])
    return cache


# ===========================================================================
# Prefill
# ===========================================================================
def prefill(params: Params, cfg: ModelConfig, batch: Dict, max_seq: int, *,
            device="cuda", length=None) -> Tuple[torch.Tensor, Dict]:
    """Run a batch of equal-length prompts one-shot, return (last-position
    logits, cache) with the keys of :func:`init_cache` filled and len = S
    (listed parameters: per-layer lists, as the reference's listed
    prefill). An int8 dense cache is quantized per token from the padded
    head-major K/V, as the reference does. Attention is the plain
    blockwise path; the recurrent layers run the scan kernels on the card,
    and their final state is the closed form. ``length`` (dense/vlm): (B,)
    real rows of padded prompts (module docstring). An audio model runs
    its encoder over batch["frames"] and fills "ck"/"cv" head-major (L, B,
    Hkv, S_enc, hd) beside the decoder's K/V."""
    _check_family(cfg, "prefill", SERVE_FAMILIES)
    if length is not None:
        _check_family(cfg, "prefill of padded prompts")
        _check_unpadded(cfg, length)
    dev = resolve_device(device)
    listed = _is_listed(params)
    cache: Dict[str, Any] = {}

    def kv_slabs(entries, key):
        """Per-layer (B, S, Hkv, hd) K or V, head-major and padded to
        max_seq (an int8 cache: quantized, scales beside)."""
        slabs = [_pad_seq(c[key].transpose(1, 2), max_seq) for c in entries]
        if _int8_cache(cfg):
            slabs, scales = zip(*map(kv_quant.quantize_kv, slabs))
            cache[f"{key}_scale"] = _per_layer(scales, listed)
        cache[key] = _per_layer(slabs, listed)

    if cfg.family == "audio":
        x, caches = _encdec_stacks(params, cfg, batch, mode="prefill",
                                   device=dev)
        for key in ("k", "v"):
            kv_slabs(caches, key)
        for key in ("ck", "cv"):
            cache[key] = _per_layer(
                (c[key].transpose(1, 2).contiguous() for c in caches), listed)
        cache["len"] = _cache_len(x, None, 0)
        return _head(params, cfg, x[:, -1]), cache
    x, positions, _ = _embed(params, cfg, batch, dev)
    if cfg.family == "ssm":
        x, states = _rwkv_stack(params, cfg, x, mode="prefill")
        for key in ("S", "x_tm", "x_cm"):
            cache[key] = _per_layer((st[key] for st in states), listed)
    elif cfg.family == "hybrid":
        x, attn, mstates, tail_states = _zamba_stack(params, cfg, x,
                                                     positions, mode="prefill")
        for key in ("k", "v"):
            kv_slabs(attn, key)
        for key in ("h", "conv"):
            cache[key] = _per_layer(
                (_per_layer((st[key] for st in sup), listed)
                 for sup in mstates), listed)
            if tail_states:
                cache[f"tail_{key}"] = _per_layer(
                    (st[key] for st in tail_states), listed)
    else:
        x, _, kv = _dense_stack(params, cfg, x, positions, mode="prefill")
        for key in ("k", "v"):
            kv_slabs(kv, key)
    cache["len"] = _cache_len(x, length, 0)
    return _head(params, cfg, _last_rows(x, length)), cache


def prefill_suffix(params: Params, cfg: ModelConfig, batch: Dict,
                   k_prefix: torch.Tensor, v_prefix: torch.Tensor, *,
                   device="cuda", length=None) -> Tuple[torch.Tensor, Dict]:
    """Prefix-cached prefill (reference ``transformer.py:485``): run only a
    prompt's unshared SUFFIX, the shared prefix's KV supplied from the
    paged pool — the prefix-sharing engine's prefill-skip path.

    batch["tokens"]: (B, S_suf) suffix tokens; k_prefix/v_prefix:
    HEAD-MAJOR (L, B, Hkv, P, hd), what ``PagedKVCache.gather_prefix``
    returns with a batch axis. Suffix queries sit at global positions
    P + i and attend over concat(prefix, suffix) by the blockwise path of
    :func:`prefill`, so windows, sinks, softcaps and post-norms follow.
    Returns (last-position logits, {"k", "v", "len"}) with SUFFIX-ONLY
    head-major K/V (L, B, Hkv, S_suf, hd) and len = P + S_suf; ``length``:
    (B,) real rows of a padded suffix (module docstring)."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError("prefix-cached prefill serves KV-cache dense "
                         f"stacks; got family={cfg.family}")
    _check_family(cfg, "prefix-cached prefill")
    _check_unpadded(cfg, length)
    dev = resolve_device(device)
    P = k_prefix.shape[3]
    x, positions, _ = _embed(params, cfg, batch, dev)
    positions = positions + P           # suffix tokens sit at P + i
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, c, _ = blocks.dense_block(_layer(params["layers"], i), cfg, x,
                                     mode="prefill", positions=positions,
                                     is_local=_is_local(cfg, i),
                                     prefix_kv=(k_prefix[i], v_prefix[i]))
        ks.append(c["k"])
        vs.append(c["v"])
    cache = {"k": _hm(torch.stack(ks)), "v": _hm(torch.stack(vs)),
             "len": _cache_len(x, length, P)}
    return _head(params, cfg, _last_rows(x, length)), cache


def prefill_chunk(params: Params, cfg: ModelConfig, batch: Dict,
                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                  prefix_blocks, *, k_scale_pool=None, v_scale_pool=None,
                  device="cuda", length=None) -> Tuple[torch.Tensor, Dict]:
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
    K/V (L, 1, Hkv, C, hd) and len = P + C; ``length``: (1,) real rows of
    a padded chunk (module docstring). P comes from the table's shape, the
    chunk kernel's host scalar."""
    _check_family(cfg, "chunked paged prefill")
    _check_unpadded(cfg, length)
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
        x, c, _ = blocks.dense_block(_layer(params["layers"], i), cfg, x,
                                     mode="prefill", positions=positions,
                                     is_local=_is_local(cfg, i),
                                     paged_prefix=(k_pool[i], v_pool[i],
                                                   table),
                                     paged_prefix_scales=None
                                     if k_scale_pool is None else
                                     (k_scale_pool[i], v_scale_pool[i]))
        ks.append(c["k"])
        vs.append(c["v"])
    cache = {"k": _hm(torch.stack(ks)), "v": _hm(torch.stack(vs)),
             "len": _cache_len(x, length, P)}
    return _head(params, cfg, _last_rows(x, length)), cache


# ===========================================================================
# Decode step (the paper's target phase)
# ===========================================================================
def decode_step_paged(params: Params, cfg: ModelConfig, tokens,
                      k_pool: torch.Tensor, v_pool: torch.Tensor,
                      block_tables, cache_len, *, k_scale_pool=None,
                      v_scale_pool=None, moe_group_size: int = 256,
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
    if _is_listed(params):
        raise ValueError("paged decode requires stacked layer params "
                         "(the listed layout serves the dense cache)")
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
        x, c, _ = blocks.dense_block(_layer(params["layers"], i), cfg, x,
                                     mode="decode", cache=lc,
                                     is_local=_is_local(cfg, i),
                                     moe_group_size=moe_group_size)
        ks.append(c["k_new"])
        vs.append(c["v_new"])
    updates = {"k_new": torch.stack(ks), "v_new": torch.stack(vs),
               "len": lens + 1}
    return _head(params, cfg, x[:, 0]), updates


# ===========================================================================
# Decode step over a dense cache / recurrent state
# ===========================================================================
def decode_step(params: Params, cfg: ModelConfig, tokens, cache: Dict, *,
                moe_group_size: int = 256,
                device="cuda") -> Tuple[torch.Tensor, Dict]:
    """One decoding iteration. tokens: (B,) int — the freshly sampled token.

    cache["len"] = tokens ALREADY stored (the new token is not in the
    cache); attention is combine(prefix partial, new-token partial) per
    §4.2.2, the prefix partial from the dense decode kernel on the card
    (its int8 entry over an int8 cache, with the scales fused).
    Returns (logits, updates): the refreshed recurrent states, len + 1 and,
    for the attention layers, k_new/v_new (L or n_super, B, Hkv, hd) —
    KV placement is :func:`apply_decode_updates`' job. The cache's K/V (and
    scales) are only read. Listed parameters (the reference's
    ``_decode_step_listed``) read a listed cache and return per-layer
    lists. An audio model's step also reads its cross K/V "ck"/"cv" (the
    dense decode kernel over every encoder row) and returns neither: they
    stay the cache's."""
    _check_family(cfg, "decode_step", SERVE_FAMILIES)
    dev = resolve_device(device)
    listed = _is_listed(params)
    cur_len = _int_tensor(cache["len"], dev)
    x = _embed_tokens(params, cfg, _int_tensor(tokens, dev)[:, None])
    updates: Dict[str, Any] = {k: v for k, v in cache.items()
                               if k not in ("k", "v", "ck", "cv", "k_scale",
                                            "v_scale")}
    updates["len"] = cur_len + 1

    if cfg.family == "ssm":
        states = []
        for i in range(cfg.num_layers):
            st = {key: cache[key][i] for key in ("S", "x_tm", "x_cm")}
            x, st = blocks.rwkv_block(_layer(params["layers"], i), cfg, x,
                                      mode="decode", state=st)
            states.append(st)
        for key in ("S", "x_tm", "x_cm"):
            updates[key] = _per_layer([st[key] for st in states], listed)
    elif cfg.family == "hybrid":
        n_super, period, tail = _zamba_split(cfg)
        k_new, v_new, hs, convs = [], [], [], []
        for si in range(n_super):
            x, c, _ = blocks.dense_block(
                params["shared_attn"], cfg, x, mode="decode",
                cache={"k": cache["k"][si], "v": cache["v"][si],
                       "len": cur_len})
            k_new.append(c["k_new"])
            v_new.append(c["v_new"])
            sup = _layer(params["layers"], si)
            states = []
            for mi in range(period):
                x, st = blocks.mamba_block(
                    _layer(sup, mi), cfg, x, mode="decode",
                    state={"h": cache["h"][si][mi],
                           "conv": cache["conv"][si][mi]})
                states.append(st)
            hs.append(_per_layer([st["h"] for st in states], listed))
            convs.append(_per_layer([st["conv"] for st in states], listed))
        updates.update(k_new=_per_layer(k_new, listed),
                       v_new=_per_layer(v_new, listed),
                       h=_per_layer(hs, listed),
                       conv=_per_layer(convs, listed))
        states = []
        for ti in range(tail):
            x, st = blocks.mamba_block(
                _layer(params["tail"], ti), cfg, x, mode="decode",
                state={"h": cache["tail_h"][ti],
                       "conv": cache["tail_conv"][ti]})
            states.append(st)
        if tail:
            for key in ("h", "conv"):
                updates[f"tail_{key}"] = _per_layer(
                    [st[key] for st in states], listed)
    elif cfg.family == "audio":
        k_new, v_new = [], []
        for i in range(cfg.num_layers):
            x, c = blocks.decoder_block(
                _layer(params["layers"], i), cfg, x,
                (cache["ck"][i], cache["cv"][i]), mode="decode",
                cache={"k": cache["k"][i], "v": cache["v"][i],
                       "len": cur_len})
            k_new.append(c["k_new"])
            v_new.append(c["v_new"])
        updates["k_new"] = _per_layer(k_new, listed)
        updates["v_new"] = _per_layer(v_new, listed)
    else:
        caches = []
        for i in range(cfg.num_layers):
            lc = {"k": cache["k"][i], "v": cache["v"][i], "len": cur_len}
            if _int8_cache(cfg):
                lc.update(k_scale=cache["k_scale"][i],
                          v_scale=cache["v_scale"][i])
            x, c, _ = blocks.dense_block(
                _layer(params["layers"], i), cfg, x, mode="decode",
                cache=lc, is_local=_is_local(cfg, i),
                moe_group_size=moe_group_size)
            caches.append(c)
        updates["k_new"] = _per_layer([c["k_new"] for c in caches], listed)
        updates["v_new"] = _per_layer([c["v_new"] for c in caches], listed)
    return _head(params, cfg, x[:, 0]), updates


def apply_decode_updates(cache: Dict, updates: Dict) -> Dict:
    """Write the step's k_new/v_new into the dense cache at the old length
    and adopt the refreshed recurrent states and len — the placement used by
    simple generation loops and tests. An int8 cache stores the token
    quantized (``kv_quant.quantize_token``) with its scales. Unlike the
    reference (which returns a new cache), the K/V (and scales) are written
    IN PLACE into ``cache["k"]`` / ``cache["v"]``, so a step never copies
    the whole cache; the returned dict holds those same tensors. An audio
    cache's cross K/V "ck"/"cv" stay as they are. Stacked caches only, as
    in the reference."""
    new_cache = dict(cache)
    if "k_new" in updates:
        B = updates["k_new"].shape[1]
        idx = cache["len"].long()  # position of the token just processed
        b = torch.arange(B, device=idx.device)
        # head-major (L, B, Hkv, S, hd): one S position per sequence
        kn = updates["k_new"].transpose(0, 1)        # (B, L, Hkv, hd)
        vn = updates["v_new"].transpose(0, 1)
        if cache["k"].dtype == torch.int8:
            kn, kns = kv_quant.quantize_token(kn)
            vn, vns = kv_quant.quantize_token(vn)
            cache["k_scale"][:, b, :, idx] = kns
            cache["v_scale"][:, b, :, idx] = vns
        cache["k"][:, b, :, idx] = kn
        cache["v"][:, b, :, idx] = vn
    for key, val in updates.items():
        if key not in ("k_new", "v_new"):
            new_cache[key] = val
    return new_cache
