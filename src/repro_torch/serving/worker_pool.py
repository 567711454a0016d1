"""Memory-device worker pool and wire-byte accounting (paper §4.2.2, §3.1).
Port of ``repro/serving/worker_pool.py`` (``AttentionWorkerPool`` over the
paged pool and over a dense cache, ``TransferLog``,
``expected_transfer_bytes``, and the MoE side: ``transfer_bytes_moe``,
``min_bandwidth_moe`` and ``ExpertWorkerPool``).

:class:`AttentionWorkerPool` owns the partitioning and the accounting of
decode attention over the engine's paged block pool (or, in ``attend``,
over a dense head-major cache: head or request), one of three ways:
"head" (each worker owns Hkv/n heads of every pool block — Lamina's
choice), "block" (the pool's block axis is sharded and a sequence's
round-robin-placed blocks span every worker; the per-worker §4.2.2
partials merge exactly by the combine identity) or "request" (the batch is
split, the load-imbalance baseline). No partition copies or densifies the
pool: each worker reads its part of the layer's pool in place. The workers
run in process on the one card, one kernel launch each.

:class:`ExpertWorkerPool` is the paper's §7 expert side: the routed
expert FFNs of a moe model run on memory-device workers, and the wire
carries each token's activations out and the experts' outputs back.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core import combine as C
from repro_torch.core import costmodel as cm
from repro_torch.kernels.paged_decode_attention import POS_PAD
from repro_torch.models.attention import (_new_token_partial,
                                          decode_attention_combine,
                                          paged_decode_attention_combine,
                                          paged_decode_attention_partial_pos)
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import moe_forward

BYTES = 2  # bf16/fp16 wire format (paper Table 2 "e")


@dataclasses.dataclass
class TransferLog:
    q_bytes: int = 0
    kv_bytes: int = 0
    out_bytes: int = 0
    transfers: int = 0

    @property
    def total(self) -> int:
        return self.q_bytes + self.kv_bytes + self.out_bytes


def request_splits(batch: int, n_workers: int):
    """The request partition's contiguous batch ranges, one per worker
    (``np.array_split`` of the batch, as the reference splits it)."""
    return [(int(idx[0]), int(idx[-1]) + 1) if len(idx) else (0, 0)
            for idx in np.array_split(np.arange(batch), n_workers)]


class AttentionWorkerPool:
    """The memory-device pool: stores nothing itself (the paged pool is the
    engine's), but owns partitioning and accounting of attention work."""

    def __init__(self, cfg: ModelConfig, n_workers: int = 2,
                 partition: str = "head", kv_dtype: str = "bf16"):
        self.cfg = cfg
        self.n = n_workers
        self.partition = partition
        self.kv_dtype = kv_dtype
        self.log = TransferLog()
        self.per_worker_kv_bytes = [0] * n_workers
        if partition not in ("head", "request", "block"):
            raise ValueError(f"unknown partition {partition!r}")
        if partition == "head" and cfg.num_kv_heads % n_workers:
            raise ValueError(
                f"head partition needs kv_heads ({cfg.num_kv_heads}) "
                f"divisible by workers ({n_workers}) — paper §5")

    def _account(self, q, k_new, v_new, out, enabled: bool) -> None:
        """Wire bytes of one direct call (reference ``:73``): q and the new
        token's k/v out, the result back, at the bf16 wire format."""
        if not enabled:
            return
        self.log.q_bytes += q.numel() * BYTES
        self.log.kv_bytes += (k_new.numel() + v_new.numel()) * BYTES
        self.log.out_bytes += out.numel() * BYTES
        self.log.transfers += 2  # QKV out + result back

    def log_iteration(self, batch: int) -> None:
        """Shape-derived per-iteration wire accounting (paper §3.1): q out,
        the new token's k/v out, the attention output back, per layer."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        L = cfg.num_layers
        self.log.q_bytes += batch * cfg.num_heads * hd * BYTES * L
        self.log.kv_bytes += 2 * batch * cfg.num_kv_heads * hd * BYTES * L
        self.log.out_bytes += batch * cfg.num_heads * hd * BYTES * L
        self.log.transfers += 2 * L

    def attend(self, q, k_cache, v_cache, cache_len, k_new, v_new, *,
               sliding_window: int = 0, logit_softcap: float = 0.0,
               k_scale=None, v_scale=None,
               account: bool = False) -> torch.Tensor:
        """Decode attention over a DENSE cache (reference ``:93``).

        q: (B, H, hd); caches HEAD-MAJOR (B, Hkv, S, hd) hold the STORED
        prefix (cache_len tokens); k_new/v_new (B, Hkv, hd) arrive over the
        wire. Each worker computes combine(prefix partial, new partial) on
        its partition — head: kv heads [w·Hkv/n, (w+1)·Hkv/n); request: a
        contiguous range of the batch — and the outputs concatenate. An
        int8 cache passes its (B, Hkv, S) scales, split the same way (the
        dense decode kernel's int8 entry on the card). The reference's
        ``backend=`` is absent: the device decides. ``per_worker_kv_bytes``
        grows by the reference's formula (2 · cache elements · 2 bytes of
        the worker's slice); ``account`` logs the call's wire bytes.
        Returns (B, H, hd)."""
        B, H, hd = q.shape
        Hkv = k_cache.shape[1]
        kw = dict(sliding_window=sliding_window, logit_softcap=logit_softcap)
        if self.partition == "head":
            hk = Hkv // self.n
            g = H // Hkv
            qg = q.reshape(B, Hkv, g, hd)
            outs = []
            for wid in range(self.n):
                sl = slice(wid * hk, (wid + 1) * hk)
                skw = {} if k_scale is None else dict(
                    k_scale=k_scale[:, sl], v_scale=v_scale[:, sl])
                o = decode_attention_combine(
                    qg[:, sl].reshape(B, hk * g, hd), k_cache[:, sl],
                    v_cache[:, sl], cache_len, k_new[:, sl], v_new[:, sl],
                    **kw, **skw)
                outs.append(o.reshape(B, hk, g, hd))
                self.per_worker_kv_bytes[wid] += \
                    2 * k_cache[:, sl].numel() * BYTES
            out = torch.cat(outs, dim=1).reshape(B, H, hd)
        elif self.partition == "request":
            outs = []
            for wid, (lo, hi) in enumerate(request_splits(B, self.n)):
                if hi == lo:
                    continue
                skw = {} if k_scale is None else dict(
                    k_scale=k_scale[lo:hi], v_scale=v_scale[lo:hi])
                outs.append(decode_attention_combine(
                    q[lo:hi], k_cache[lo:hi], v_cache[lo:hi],
                    cache_len[lo:hi], k_new[lo:hi], v_new[lo:hi], **kw,
                    **skw))
                self.per_worker_kv_bytes[wid] += \
                    2 * k_cache[lo:hi].numel() * BYTES
            out = torch.cat(outs, dim=0)
        else:
            raise ValueError(self.partition)
        self._account(q, k_new, v_new, out, account)
        return out

    def attend_paged(self, q, k_pool, v_pool, block_tables, cache_len,
                     k_new, v_new, *, sliding_window: int = 0,
                     attention_sinks: int = 0, logit_softcap: float = 0.0,
                     shard_tables=None, shard_positions=None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
        """The engine's decode hot path over the paged pool.

        q: (B, H, hd); k_pool/v_pool: one layer's HEAD-MAJOR pool
        (Hkv, num_blocks, block_size, hd) holding the STORED prefix;
        block_tables (B, nb); k_new/v_new (B, Hkv, hd) arrive over the wire.
        Each worker reads its partition of the pool in place and the
        partials merge with the new token by §4.2.2. Returns (B, H, hd).

        * head: worker w reads heads [w·Hkv/n, (w+1)·Hkv/n) — a contiguous
          slice of the pool (and of the scale pools); only its few KiB of
          q are copied to make them contiguous.
        * block: worker w walks its compacted table of the blocks its shard
          holds. Unlike the reference, which hands each worker the shard's
          slice of the block axis with LOCAL ids, the port passes the whole
          layer pool with GLOBAL ids (``shard_tables`` holds local +
          w·blocks_per_shard), so no strided slice is ever copied;
          ``shard_positions`` holds each slot's global base position
          (POS_PAD on pad slots). Without them an owner-masked view of the
          global table is derived instead (exact, but every worker walks
          every slot).
        * request: worker w takes a contiguous range of the batch (one
          launch per worker that has requests) over the whole pool.

        Int8 pools pass the layer's scale pools (Hkv, num_blocks,
        block_size); they follow the value pools' split exactly."""
        B, H, hd = q.shape
        Hkv, NB, bs, _ = k_pool.shape
        kw = dict(sliding_window=sliding_window,
                  attention_sinks=attention_sinks,
                  logit_softcap=logit_softcap)
        if self.partition == "head":
            hk = Hkv // self.n
            g = H // Hkv
            qg = q.reshape(B, Hkv, g, hd)
            outs = []
            for wid in range(self.n):
                sl = slice(wid * hk, (wid + 1) * hk)
                skw = {} if k_scale is None else dict(
                    k_scale=k_scale[sl], v_scale=v_scale[sl])
                o = paged_decode_attention_combine(
                    qg[:, sl].reshape(B, hk * g, hd), k_pool[sl], v_pool[sl],
                    block_tables, cache_len, k_new[:, sl], v_new[:, sl],
                    **kw, **skw)
                outs.append(o.reshape(B, hk, g, hd))
            return torch.cat(outs, dim=1).reshape(B, H, hd)
        skw = {} if k_scale is None else dict(k_scale=k_scale,
                                              v_scale=v_scale)
        if self.partition == "block":
            if NB % self.n:
                raise ValueError(
                    f"block partition needs num_blocks ({NB}) divisible by "
                    f"workers ({self.n}) — PagedKVCache(n_shards=...)")
            if shard_tables is None:
                shard_tables, shard_positions = owner_masked_tables(
                    block_tables, NB // self.n, self.n, bs)
            partials = [paged_decode_attention_partial_pos(
                q, k_pool, v_pool, shard_tables[wid], shard_positions[wid],
                cache_len, **kw, **skw) for wid in range(self.n)]
            p_new = _new_token_partial(q, k_new, v_new,
                                       logit_softcap=logit_softcap)
            return C.finalize(C.combine(C.combine_many(partials),
                                        p_new)).to(q.dtype)
        if self.partition == "request":
            outs = [paged_decode_attention_combine(
                q[lo:hi], k_pool, v_pool, block_tables[lo:hi],
                cache_len[lo:hi], k_new[lo:hi], v_new[lo:hi], **kw, **skw)
                for lo, hi in request_splits(B, self.n) if hi > lo]
            return torch.cat(outs, dim=0)
        raise ValueError(self.partition)

    # overlap mode shares the same math (the combine is exact); only the
    # schedule differs, which the reference's latency model prices
    attend_overlapped = attend_paged

    def log_paged_kv(self, worker_tokens: Sequence[int], n_layers: int,
                     kv_head_fraction: float = 1.0) -> None:
        """Per-worker live-token KV-read accounting for the paged hot path.

        worker_tokens: (n_workers,) live tokens each worker's partition
        reads this iteration; kv_head_fraction scales for head partitioning
        (each worker reads Hkv/n heads of every token). Per-token-head
        bytes follow the pool's dtype: hd·2 for bf16, hd + 4 for int8 (the
        value plus its fp32 scale)."""
        hd = self.cfg.resolved_head_dim
        per_head = hd + 4 if self.kv_dtype == "int8" else hd * BYTES
        per_tok = 2 * self.cfg.num_kv_heads * kv_head_fraction * \
            per_head * n_layers
        for wid in range(self.n):
            self.per_worker_kv_bytes[wid] += int(worker_tokens[wid] * per_tok)


def owner_masked_tables(block_tables: torch.Tensor, blocks_per_shard: int,
                        n_workers: int, block_size: int):
    """Per-worker views of a global (B, nb) table for the block partition:
    every worker keeps the global ids and the slots whose block lies on
    another shard get POS_PAD positions, so every mask kills them."""
    nb = block_tables.shape[1]
    base = (torch.arange(nb, dtype=torch.int32, device=block_tables.device)
            * block_size)[None, :].expand_as(block_tables)
    owner = block_tables // blocks_per_shard
    pad = torch.full_like(block_tables, POS_PAD)
    tables = [block_tables] * n_workers
    pos = [torch.where(owner == wid, base, pad).contiguous()
           for wid in range(n_workers)]
    return tables, pos


def expected_transfer_bytes(cfg: ModelConfig, batch: int) -> int:
    """Paper §3.1: (2 + 2/G)·e·d_q·B·L wire bytes per iteration."""
    G = cfg.gqa_group
    return int((2 + 2 / G) * BYTES * cfg.q_dim * batch * cfg.num_layers)


def transfer_bytes_moe(cfg: ModelConfig, batch: int) -> int:
    """Per-iteration wire bytes for expert offloading: token activations to
    the pool and expert outputs back, per MoE layer."""
    return int(2 * BYTES * cfg.d_model * batch * cfg.num_layers)


def min_bandwidth_moe(cfg: ModelConfig, batch: int, seq_len: float,
                      hw_model: cm.HardwareSpec, hw_exp: cm.HardwareSpec,
                      alpha: float = 0.2) -> float:
    """Paper-§3.1 style minimum-bandwidth bound for the MoE boundary
    (reference ``worker_pool.py:292``; ``hw_exp`` is unused there too)."""
    t = cm.mtime(cfg, batch, hw_model) + cm.atime(cfg, batch, seq_len,
                                                  hw_model)
    return transfer_bytes_moe(cfg, batch) / (alpha * t)


class ExpertWorkerPool:
    """The memory-device pool that owns the expert weights and their FFN
    compute (paper §7)."""

    def __init__(self, cfg: ModelConfig, n_workers: int = 2):
        if cfg.num_experts % max(n_workers, 1):
            raise ValueError(
                f"expert partition needs num_experts ({cfg.num_experts}) "
                f"divisible by workers ({n_workers})")
        self.cfg = cfg
        self.n = n_workers
        self.log = TransferLog()
        self.per_worker_tokens = [0] * n_workers

    def run_experts(self, moe_params: Dict, x: torch.Tensor,
                    account: bool = False) -> torch.Tensor:
        """x: (B, S, d) routed-token activations arriving over the wire.
        The experts run as one ``moe_forward`` call, as in the reference
        (each worker's expert shard adds its disjoint share of every
        token's output). ``account`` logs this call's wire bytes; the
        engine's step logs analytically instead (:meth:`log_iteration`)."""
        y, _ = moe_forward(moe_params, self.cfg, x)
        if account:
            self.log.q_bytes += x.numel() * BYTES       # activations out
            self.log.out_bytes += y.numel() * BYTES     # expert outputs back
            self.log.transfers += 2
        return y

    def log_iteration(self, batch: int) -> None:
        d, L = self.cfg.d_model, self.cfg.num_layers
        self.log.q_bytes += batch * d * BYTES * L
        self.log.out_bytes += batch * d * BYTES * L
        self.log.transfers += 2 * L
