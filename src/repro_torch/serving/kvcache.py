"""Paged KV-cache manager (PagedAttention-style, paper baseline [28]).
Port of ``repro/serving/kvcache.py`` for one pool shard and bf16/fp32 pools.

Fixed-size blocks of ``block_size`` tokens from a global pool; per-sequence
block tables; allocation is O(1) off a free list. The allocator is
host-side Python/numpy exactly as in the reference (free list, tables,
lengths, refcounts, copy-on-write); the pools are device tensors, HEAD-MAJOR
``(L, Hkv, num_blocks, block_size, hd)``, written IN PLACE (``index_put_``)
by ``write_prefill`` / ``write_prefill_chunk`` / ``write_tokens`` — the
reference rebuilt immutable arrays instead. One (layer, head, block) tile
is a contiguous ``(block_size, hd)`` slab, the layout the paged kernels
walk through ``block_table_batch()``.

Prefix sharing / copy-on-write: identical prompt prefixes map several
sequences' tables onto the SAME physical blocks (``share_blocks``); every
block carries a refcount, is freed only when the last reference goes, and
the first divergent write into a shared block forks a private copy
(``_cow_block``).

Int8 scale pools, block-granular handoff and shard quarantine arrive with
their slices (ROADMAP Queue 1).

Invariants (tests/test_torch_engine.py replays the reference's):
  * a block's refcount == the number of live tables referencing it,
  * free + referenced == total (a block is free iff its refcount is zero),
  * a sequence's capacity always covers its token count,
  * a writer never mutates a block another live sequence references.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, resolve_device


class OutOfBlocks(RuntimeError):
    pass


class PoolExhausted(OutOfBlocks):
    """Pool exhaustion with context: which request hit the wall, how many
    tokens are live in the pool, and how many blocks remain free — the
    signal the preempting scheduling policy consumes (and the clear error
    FCFS surfaces instead of failing deep in the allocator)."""

    def __init__(self, message: str, *, rid: Optional[int] = None,
                 live_tokens: int = 0, free_blocks: int = 0):
        super().__init__(message)
        self.rid = rid
        self.live_tokens = live_tokens
        self.free_blocks = free_blocks


@dataclasses.dataclass
class PagedKVCache:
    cfg: ModelConfig
    num_blocks: int
    block_size: int = 16
    kv_dtype: str = "bf16"             # "bf16": the model's dtype
    device: object = "cuda"

    def __post_init__(self):
        if self.kv_dtype != "bf16":
            raise NotImplementedError(
                f"kv_dtype {self.kv_dtype!r} is not ported yet; use 'bf16'")
        self.device = resolve_device(self.device)
        hd = self.cfg.resolved_head_dim
        self.k_pool = torch.zeros(
            (self.cfg.num_layers, self.cfg.num_kv_heads, self.num_blocks,
             self.block_size, hd), dtype=self.cfg.dtype, device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        self._free: List[int] = list(range(self.num_blocks))
        self.tables: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}
        # block id -> number of live tables referencing it (free blocks have
        # no entry)
        self.refcounts: Dict[int, int] = {}
        # seq -> block ids it BORROWED via share_blocks. A borrower's
        # prefill write into a still-shared borrowed block copy-on-writes;
        # the original allocator's write is the canonical fill and goes
        # through in place.
        self._borrowed: Dict[int, set] = {}
        self.cow_forks = 0             # copy-on-write block copies
        # memoised device index tensors keyed by the gathered block ids
        self._gather_idx_cache: Dict[Tuple[int, ...], torch.Tensor] = {}

    @property
    def free(self) -> List[int]:
        """All free block ids (read-only copy)."""
        return list(self._free)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def capacity_blocks(self) -> int:
        """Total blocks the pool can hold."""
        return self.num_blocks

    def _pop_block(self) -> int:
        if not self._free:
            raise OutOfBlocks("pool exhausted")
        return self._free.pop()

    # ---------------- allocation ----------------
    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.num_free >= self.blocks_needed(n_tokens)

    def _exhausted(self, message: str, rid: int) -> PoolExhausted:
        return PoolExhausted(message, rid=rid,
                             live_tokens=sum(self.lengths.values()),
                             free_blocks=self.num_free)

    def allocate(self, seq_id: int, n_tokens: int) -> None:
        """Give `seq_id` capacity for `n_tokens`. A fresh sequence gets a new
        table; an EXISTING one (share-seeded, or a chunked prefill growing
        one chunk per iteration) is extended with fresh private blocks."""
        table = self.tables.get(seq_id)
        if table is not None and n_tokens < self.lengths[seq_id]:
            raise ValueError(f"seq {seq_id}: cannot shrink allocation")
        need = self.blocks_needed(n_tokens) - (len(table) if table else 0)
        if need > self.num_free:
            verb = "extending" if table is not None else "allocating"
            raise self._exhausted(
                f"{verb} seq {seq_id}: need {need}, have {self.num_free}",
                seq_id)
        if table is None:
            table = self.tables[seq_id] = []
        for _ in range(need):
            b = self._pop_block()
            self.refcounts[b] = 1
            table.append(b)
        self.lengths[seq_id] = n_tokens

    def share_blocks(self, src_rid: int, dst_rid: int, n_tokens: int) -> int:
        """Map a NEW sequence `dst_rid`'s table onto `src_rid`'s physical
        blocks covering its first `n_tokens` (refcounts bumped, no pool
        memory consumed). A trailing partial block is shared too. Returns
        the number of blocks shared."""
        if dst_rid in self.tables:
            raise ValueError(f"seq {dst_rid} already allocated — "
                             f"share_blocks seeds new tables")
        if n_tokens < 1 or n_tokens > self.lengths[src_rid]:
            raise ValueError(
                f"share_blocks: n_tokens={n_tokens} outside donor {src_rid}'s"
                f" stored range [1, {self.lengths[src_rid]}]")
        shared = self.tables[src_rid][:self.blocks_needed(n_tokens)]
        for b in shared:
            self.refcounts[b] += 1
        self.tables[dst_rid] = list(shared)
        self.lengths[dst_rid] = n_tokens
        self._borrowed[dst_rid] = set(shared)
        return len(shared)

    def _cow_block(self, seq_id: int, slot: int) -> None:
        """Copy-on-write fork of `seq_id`'s table slot: pop a private block,
        copy the physical tile in place, decrement the donor's refcount."""
        old = self.tables[seq_id][slot]
        new = self._pop_block()
        self.refcounts[old] -= 1
        self.refcounts[new] = 1
        self.tables[seq_id][slot] = new
        self._borrowed.get(seq_id, set()).discard(old)
        self.k_pool[:, :, new] = self.k_pool[:, :, old]
        self.v_pool[:, :, new] = self.v_pool[:, :, old]
        self.cow_forks += 1

    def blocks_to_append(self, seq_id: int) -> int:
        """Fresh blocks the next :meth:`append_token` consumes: 1 when the
        table must grow OR a shared tail block must be forked, else 0."""
        n = self.lengths[seq_id]
        table = self.tables[seq_id]
        if self.blocks_needed(n + 1) > len(table):
            return 1
        if self.refcounts[table[n // self.block_size]] > 1:
            return 1
        return 0

    def append_token(self, seq_id: int) -> None:
        n = self.lengths[seq_id] + 1
        table = self.tables[seq_id]
        try:
            if self.blocks_needed(n) > len(table):
                b = self._pop_block()
                self.refcounts[b] = 1
                table.append(b)
            else:
                slot = (n - 1) // self.block_size
                if self.refcounts[table[slot]] > 1:
                    self._cow_block(seq_id, slot)
        except OutOfBlocks:
            live = sum(self.lengths.values())
            raise self._exhausted(
                f"KV pool exhausted growing request {seq_id} to token "
                f"{n}: {live} live tokens across {len(self.tables)} "
                f"sequences occupy all {self.capacity_blocks} usable "
                f"blocks ({self.num_free} free) — preempt a victim or raise "
                f"num_blocks", seq_id) from None
        self.lengths[seq_id] = n

    def free_seq(self, seq_id: int) -> None:
        for b in self.tables.pop(seq_id):
            self.refcounts[b] -= 1
            if self.refcounts[b] == 0:
                del self.refcounts[b]
                self._free.append(b)
        self._borrowed.pop(seq_id, None)
        del self.lengths[seq_id]

    @property
    def used_blocks(self) -> int:
        """PHYSICAL blocks in use (a shared block counts once)."""
        return self.num_blocks - self.num_free

    @property
    def pool_bytes_resident(self) -> int:
        """Resident bytes of the whole pool allocation (K + V)."""
        return 2 * self.k_pool.numel() * self.k_pool.element_size()

    def bytes_per_live_token(self) -> int:
        """Pool bytes one token of context occupies (K + V, all layers)."""
        L, Hkv, _, _, hd = self.k_pool.shape
        return 2 * L * Hkv * hd * self.k_pool.element_size()

    def unique_live_tokens(self, seq_ids: Optional[Sequence[int]] = None
                           ) -> int:
        """Live tokens over UNIQUE physical blocks — a block shared by K
        sequences counts once, at the deepest fill any sharer reaches."""
        if seq_ids is None:
            seq_ids = list(self.tables)
        per_block: Dict[int, int] = {}
        bs = self.block_size
        for sid in seq_ids:
            length = self.lengths[sid]
            for j, g in enumerate(self.tables[sid]):
                t = min(bs, max(0, length - j * bs))
                if t > per_block.get(g, 0):
                    per_block[g] = t
        return sum(per_block.values())

    # ---------------- hot-path views ----------------
    def block_table_batch(self, seq_ids: Sequence[int]
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched (B, nb) block table + (B,) lengths for the paged decode
        step. nb covers the longest live sequence; pad slots are block 0
        (their positions are ≥ cache_len, so the kernel masks them)."""
        lens = np.array([self.lengths[sid] for sid in seq_ids], np.int32)
        nb = max(1, self.blocks_needed(int(lens.max()))) if len(lens) else 1
        tables = np.zeros((len(seq_ids), nb), np.int32)
        for i, sid in enumerate(seq_ids):
            t = self.tables[sid][:nb]
            tables[i, :len(t)] = t
        return tables, lens

    # ---------------- data movement ----------------
    def write_prefill(self, seq_id: int, k: torch.Tensor, v: torch.Tensor,
                      start_token: int = 0) -> None:
        """k/v: HEAD-MAJOR (L, Hkv, S, hd) for this sequence's tokens
        [start_token, start_token + S) (start block-aligned), scattered in
        place into its blocks. A write into a still-shared BORROWED block
        copy-on-writes first; S must equal the allocated length minus
        start_token."""
        if start_token % self.block_size:
            raise ValueError(
                f"write_prefill start_token ({start_token}) must be "
                f"block-aligned (block_size={self.block_size})")
        S = k.shape[2]
        table = self.tables[seq_id]
        if start_token + S > len(table) * self.block_size:
            raise self._exhausted(
                f"request {seq_id}: write_prefill of {S} tokens at "
                f"{start_token} exceeds its allocated {len(table)} blocks × "
                f"{self.block_size} — allocate() must cover the prompt "
                f"first", seq_id)
        expected = self.lengths[seq_id] - start_token
        if S != expected or k.shape != v.shape:
            raise ValueError(
                f"request {seq_id}: write_prefill got k/v of {S} tokens "
                f"(k {tuple(k.shape)}, v {tuple(v.shape)}) at start_token "
                f"{start_token}, but the sequence's allocated length is "
                f"{self.lengths[seq_id]} — expected exactly {expected} "
                f"tokens")
        b0 = start_token // self.block_size
        nb = self.blocks_needed(S)
        borrowed = self._borrowed.get(seq_id, ())
        for slot in range(b0, b0 + nb):
            if table[slot] in borrowed and self.refcounts[table[slot]] > 1:
                self._cow_block(seq_id, slot)
        pad = nb * self.block_size - S
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        L, Hkv, _, hd = k.shape
        idx = torch.as_tensor(table[b0:b0 + nb], device=self.device)
        self.k_pool[:, :, idx] = k.reshape(L, Hkv, nb, self.block_size, hd)
        self.v_pool[:, :, idx] = v.reshape(L, Hkv, nb, self.block_size, hd)

    def write_prefill_chunk(self, seq_id: int, k: torch.Tensor,
                            v: torch.Tensor, start_token: int) -> None:
        """Incremental chunk write — the chunked-prefill data path: extend
        the allocation to cover exactly this chunk, then scatter the
        chunk's head-major (L, Hkv, C, hd) K/V at `start_token`."""
        target = start_token + k.shape[2]
        if target > self.lengths.get(seq_id, 0):
            try:
                self.allocate(seq_id, target)
            except OutOfBlocks:
                live = sum(self.lengths.values())
                raise self._exhausted(
                    f"KV pool exhausted growing request {seq_id}'s chunked "
                    f"prefill to token {target}: {live} live tokens across "
                    f"{len(self.tables)} sequences occupy all "
                    f"{self.capacity_blocks} usable blocks "
                    f"({self.num_free} free) — preempt a victim or raise "
                    f"num_blocks", seq_id) from None
        self.write_prefill(seq_id, k, v, start_token=start_token)

    def write_tokens(self, seq_ids: Sequence[int], k_new: torch.Tensor,
                     v_new: torch.Tensor, positions: Sequence[int]) -> None:
        """Batched in-place scatter of one token per sequence — the decode
        step's single pool write. k_new/v_new: (L, B, Hkv, hd); positions:
        per-sequence 0-based slots (the pre-append lengths). Shared targets
        copy-on-write first."""
        for sid, p in zip(seq_ids, positions):
            slot = p // self.block_size
            if self.refcounts[self.tables[sid][slot]] > 1:
                self._cow_block(sid, slot)
        blk = torch.as_tensor([self.tables[sid][p // self.block_size]
                               for sid, p in zip(seq_ids, positions)],
                              device=self.device)
        off = torch.as_tensor([p % self.block_size for p in positions],
                              device=self.device)
        self.k_pool[:, :, blk, off] = k_new.transpose(1, 2)  # (L, Hkv, B, hd)
        self.v_pool[:, :, blk, off] = v_new.transpose(1, 2)

    def gather_prefix_indices(self, seq_id: int,
                              n_tokens: int) -> torch.Tensor:
        """(nb,) int32 device tensor of the pool-block ids covering this
        sequence's first `n_tokens` (block-aligned) — the prefix operand of
        a prefill chunk. Memoised by block-id content, so it never goes
        stale."""
        if n_tokens % self.block_size:
            raise ValueError(
                f"gather_prefix n_tokens ({n_tokens}) must be block-aligned "
                f"(block_size={self.block_size})")
        key = tuple(self.tables[seq_id][:n_tokens // self.block_size])
        idx = self._gather_idx_cache.get(key)
        if idx is None:
            if len(self._gather_idx_cache) > 4096:   # bound the memo
                self._gather_idx_cache.clear()
            idx = torch.as_tensor(key, dtype=torch.int32, device=self.device)
            self._gather_idx_cache[key] = idx
        return idx
