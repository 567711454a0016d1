"""Placement strategies — where each operator of the decode step runs.
Port of ``repro/serving/placement.py`` (``PlacementStrategy``,
``HomogeneousPlacement``, ``sliced_decode_step``,
``AttentionPoolPlacement`` and ``MoEOffloadPlacement``, the paper's §7
offload of the routed expert FFNs).

Each strategy builds the one-iteration decode step over the paged pool
(:meth:`PlacementStrategy.decode_fn`), supplies its per-iteration host
operands and data-dependent KV-read accounting (:meth:`decode_extra_args`;
the caller puts the operands on the device) and does the analytic §3.1
wire accounting (:meth:`log_step`, :meth:`log_prefill_chunk`). Every
placement decodes greedy token for token like the homogeneous one (the
§4.2.2 combine identity).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.attention import out_project, qkv_project
from repro_torch.models.common import ModelConfig, resolve_device, rms_norm
from repro_torch.models.ffn import ffn_forward
from repro_torch.models.moe import moe_forward
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.worker_pool import (BYTES, AttentionWorkerPool,
                                             ExpertWorkerPool, TransferLog,
                                             request_splits)


def sliced_decode_step(cfg: ModelConfig, pool: AttentionWorkerPool,
                       params, tokens, k_pool, v_pool, block_tables, lens,
                       shard_tables=None, shard_positions=None, *,
                       expert_pool: Optional[ExpertWorkerPool] = None,
                       k_scale_pool=None, v_scale_pool=None,
                       device="cuda"):
    """One disaggregated decode iteration: model slice 0 (norm1 + QKV) on
    the model worker, attention on the worker pool (which reads the paged
    pool in place), model slice 1 (o-proj + FFN) back on the model worker;
    with ``expert_pool`` (paper §7) a moe layer's routed expert FFNs run
    on the expert workers instead.

    tokens (B,); k_pool/v_pool HEAD-MAJOR (L, Hkv, num_blocks, bs, hd);
    block_tables (B, nb); lens (B,) stored tokens; shard_tables /
    shard_positions (n, B, nbl) for the block partition; int8 pools pass
    the (L, Hkv, num_blocks, bs) scale pools. Returns (logits, updates)
    like ``transformer.decode_step_paged``."""
    dev = resolve_device(device)
    tok = transformer._int_tensor(tokens, dev)
    tables = transformer._int_tensor(block_tables, dev)
    cur_len = transformer._int_tensor(lens, dev)        # stored tokens
    x = transformer._embed_tokens(params, cfg, tok[:, None])
    positions = cur_len[:, None]
    ks, vs = [], []
    for layer in range(cfg.num_layers):
        p = transformer._layer(params["layers"], layer)
        window = cfg.sliding_window if (transformer._is_local(cfg, layer) or
                                        not cfg.local_global) else 0
        # ---- model slice 0: norm1 + QKV (send q early — §4.2.2) ----
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        q, k, v = qkv_project(p["attn"], cfg, h, positions)
        ks.append(k[:, 0])
        vs.append(v[:, 0])
        # ---- attention pool: workers read the paged pool in place ----
        attn = pool.attend_paged(
            q[:, 0], k_pool[layer], v_pool[layer], tables, cur_len,
            k[:, 0], v[:, 0], sliding_window=int(window),
            attention_sinks=cfg.attention_sinks if window else 0,
            logit_softcap=cfg.attn_logit_softcap,
            shard_tables=shard_tables, shard_positions=shard_positions,
            k_scale=None if k_scale_pool is None else k_scale_pool[layer],
            v_scale=None if v_scale_pool is None else v_scale_pool[layer])
        # ---- model slice 1: o-proj + residual + FFN ----
        attn_out = out_project(p["attn"], attn[:, None])
        if cfg.post_norms:
            attn_out = rms_norm(attn_out, p["norm_post_attn"], cfg.norm_eps)
        x = x + attn_out
        h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
        if "moe" in p:
            if expert_pool is not None:
                # router on the model worker, routed FFNs on the experts
                f = expert_pool.run_experts(p["moe"], h2)
            else:
                f, _ = moe_forward(p["moe"], cfg, h2)
        else:
            f = ffn_forward(p["ffn"], h2)
        if cfg.post_norms:
            f = rms_norm(f, p["norm_post_ffn"], cfg.norm_eps)
        x = x + f
    updates = {"k_new": torch.stack(ks), "v_new": torch.stack(vs),
               "len": cur_len + 1}
    return transformer._head(params, cfg, x[:, 0]), updates


class PlacementStrategy:
    """Base placement: where each operator of the decode step executes."""

    name = "base"

    def __init__(self, cfg: ModelConfig, econf: EngineConfig, device):
        self.cfg = cfg
        self.econf = econf
        self.device = device

    def decode_fn(self):
        """The one-iteration decode step ``(params, tokens, k_pool, v_pool,
        block_tables, lens, *extra, k_scale_pool=None, v_scale_pool=None)
        -> (logits, updates)``."""
        raise NotImplementedError

    def decode_extra_args(self, kv: PagedKVCache,
                          ids: Sequence[int]) -> Tuple[np.ndarray, ...]:
        """The step's host side, run every step: this step's per-worker
        KV-read accounting, and its extra operands as host int32 arrays.
        Placing them on the device is the caller's: the eager step takes
        them as tensors (:func:`device_operands`), the compiled step copies
        them into its static buffers."""
        return ()

    def log_step(self, batch: int) -> None:
        pass

    def log_prefill_chunk(self, tokens: int) -> None:
        """Account one prefill chunk's KV landing in the pool (homogeneous
        placement moves nothing off the model worker)."""

    @property
    def pool(self) -> Optional[AttentionWorkerPool]:
        return None

    @property
    def expert_pool(self) -> Optional[ExpertWorkerPool]:
        return None

    @property
    def transfer_log(self) -> Optional[TransferLog]:
        return self.pool.log if self.pool is not None else None


class HomogeneousPlacement(PlacementStrategy):
    """vLLM-style baseline: every operator fused on the model worker."""

    name = "homogeneous"

    def decode_fn(self):
        cfg, device = self.cfg, self.device

        def step(params, tokens, k_pool, v_pool, block_tables, lens,
                 k_scale_pool=None, v_scale_pool=None):
            return transformer.decode_step_paged(
                params, cfg, tokens, k_pool, v_pool, block_tables, lens,
                k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
                device=device)
        return step


class AttentionPoolPlacement(PlacementStrategy):
    """Lamina (paper §4): attention on a memory-optimized worker pool,
    partitioned ``head`` / ``request`` / ``block``."""

    name = "attention_pool"

    def __init__(self, cfg: ModelConfig, econf: EngineConfig, device):
        super().__init__(cfg, econf, device)
        self._pool = AttentionWorkerPool(cfg, econf.attention_workers,
                                         econf.partition,
                                         kv_dtype=econf.kv_dtype)

    @property
    def pool(self) -> AttentionWorkerPool:
        return self._pool

    def decode_fn(self):
        cfg, pool, device = self.cfg, self._pool, self.device

        def step(params, tokens, k_pool, v_pool, block_tables, lens,
                 shard_tables=None, shard_positions=None,
                 k_scale_pool=None, v_scale_pool=None):
            return sliced_decode_step(
                cfg, pool, params, tokens, k_pool, v_pool, block_tables,
                lens, shard_tables, shard_positions,
                expert_pool=self.expert_pool, k_scale_pool=k_scale_pool,
                v_scale_pool=v_scale_pool, device=device)
        return step

    def decode_extra_args(self, kv: PagedKVCache,
                          ids: Sequence[int]) -> Tuple[np.ndarray, ...]:
        """Per-worker live-token KV-read accounting, plus, for the block
        partition, each worker's compacted table (global pool ids: the
        shard's local ids + shard·blocks_per_shard) and slot positions as
        host arrays, built once per step."""
        pool, L = self._pool, self.cfg.num_layers
        if pool.partition == "block":
            lt, lp, shard_tokens = kv.block_table_shards(ids)
            pool.log_paged_kv(shard_tokens.sum(axis=1), L)
            offsets = np.arange(kv.n_shards, dtype=np.int32)[:, None, None]
            return lt + offsets * kv.blocks_per_shard, lp
        # a prefix-SHARED physical block is read once per worker, not once
        # per sharer: unique_live_tokens dedupes
        if pool.partition == "head":
            total = kv.unique_live_tokens(ids)
            pool.log_paged_kv([total] * pool.n, L,
                              kv_head_fraction=1.0 / pool.n)
        else:  # request: each worker walks only its requests' tables
            toks = [kv.unique_live_tokens(ids[lo:hi])
                    for lo, hi in request_splits(len(ids), pool.n)]
            pool.log_paged_kv(toks, L)
        return ()

    def log_step(self, batch: int) -> None:
        self._pool.log_iteration(batch)

    def log_prefill_chunk(self, tokens: int) -> None:
        """One chunk's KV crosses the wire model -> pool once per layer;
        int8 pools ship int8 values + fp32 scales (hd + 4 bytes per
        token-head instead of hd·2)."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        per_head = hd + 4 if self.econf.kv_dtype == "int8" else hd * BYTES
        self._pool.log.kv_bytes += (2 * tokens * cfg.num_kv_heads *
                                    per_head * cfg.num_layers)
        self._pool.log.transfers += cfg.num_layers


class MoEOffloadPlacement(AttentionPoolPlacement):
    """Paper §7: attention AND the routed expert FFNs on worker pools."""

    name = "moe_offload"

    def __init__(self, cfg: ModelConfig, econf: EngineConfig, device):
        if cfg.family != "moe":
            raise ValueError("moe_offload placement needs a MoE config; "
                             f"got family={cfg.family}")
        super().__init__(cfg, econf, device)
        self._expert_pool = ExpertWorkerPool(cfg, econf.expert_workers)

    @property
    def expert_pool(self) -> ExpertWorkerPool:
        return self._expert_pool

    def log_step(self, batch: int) -> None:
        super().log_step(batch)
        self._expert_pool.log_iteration(batch)


def device_operands(arrays: Sequence[np.ndarray], device) -> Tuple:
    """Host int32 operands as tensors on ``device`` — the eager step's
    inputs."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


_PLACEMENTS = {"homogeneous": HomogeneousPlacement,
               "attention_pool": AttentionPoolPlacement,
               "moe_offload": MoEOffloadPlacement}


def make_placement(cfg: ModelConfig, econf: EngineConfig,
                   device) -> PlacementStrategy:
    return _PLACEMENTS[econf.placement](cfg, econf, device)
