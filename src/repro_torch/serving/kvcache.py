"""Paged KV-cache manager (PagedAttention-style, paper baseline [28]).
Port of ``repro/serving/kvcache.py``: block-sharded, bf16/fp32 or int8
pools with shard quarantine, and the block-granular KV handoff of the
disaggregated cluster (``export_seqs`` → ``prealloc_handoff`` →
``write_handoff_blocks``, reference ``kvcache.py:799-1003``).

Fixed-size blocks of ``block_size`` tokens from a global pool; per-sequence
block tables; allocation is O(1) off a free list. The allocator is
host-side Python/numpy exactly as in the reference (free list, tables,
lengths, refcounts, copy-on-write); the pools are device tensors, HEAD-MAJOR
``(L, Hkv, num_blocks, block_size, hd)``, written IN PLACE (``index_put_``)
by ``write_prefill`` / ``write_prefill_chunk`` / ``write_token(s)`` and
the handoff import — the reference rebuilt immutable arrays instead. The
captured decode and prefill graphs read the pools by address, so no write
may rebind them. One (layer, head, block) tile is a contiguous
``(block_size, hd)`` slab, the layout the paged kernels walk through
``block_table_batch()``.

Prefix sharing / copy-on-write: identical prompt prefixes map several
sequences' tables onto the SAME physical blocks (``share_blocks``); every
block carries a refcount, is freed only when the last reference goes, and
the first divergent write into a shared block forks a private copy
(``_cow_block``).

Block shards (``n_shards > 1``): the pool's block axis is cut into
``n_shards`` contiguous ranges of ``num_blocks // n_shards`` blocks — shard
s owns global ids [s·npb, (s+1)·npb), the slice one attention worker of the
block partition reads. A sequence's i-th block lands ROUND-ROBIN on shard
i mod n_shards (the most-free shard when that one is empty);
``block_table_shards()`` gives each shard's compacted table and each
slot's global base position.

Shard quarantine (fault recovery): a shard the engine declares dead is
masked out of the allocator (``quarantine_shard``): the round-robin slot
rule walks the LIVE shards only, and every capacity view (``num_free``,
``capacity_blocks``, ``can_allocate``) drops to the survivors. The dead
shard's free list is kept: victims release their refs through the normal
refcount path and the blocks drain back in place, unallocatable until
``rejoin_shard``. Every ``PoolExhausted`` carries the degraded context.

Quantized pool (``kv_dtype="int8"``): int8 value pools plus per-token,
per-kv-head fp32 scale pools ``(L, Hkv, num_blocks, block_size)`` that
mirror the value pools' block axis. Every write path quantizes at write
time (``models/kv_quant.py``) and every block operation (copy-on-write,
free, round-robin placement) moves the scale tile with its value tile —
scales follow blocks. The attention kernels fuse dequantization; nothing
on the hot path builds a dequantized slab.

Handoff (the prefill → decode wire): ``export_seqs`` gathers every
physical block the exported tables reference, once, into host tiles (one
device gather, one device-to-host copy into pinned memory on the card,
then a synchronisation, so no reader sees a payload half copied); the
importer reserves destination blocks all-or-nothing by the round-robin
slot rule (``prealloc_handoff``) and lands block ranges from the host tiles
in place (``write_handoff_blocks``: one host-to-device copy of the range,
one ``index_copy_`` per pool).

Invariants (tests/test_torch_engine.py replays the reference's):
  * a block's refcount == the number of live tables referencing it,
  * free + referenced == total (a block is free iff its refcount is zero),
  * a sequence's capacity always covers its token count,
  * a writer never mutates a block another live sequence references,
  * no allocation lands on a quarantined shard (tests/test_torch_faults.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.paged_decode_attention import POS_PAD
from repro_torch.models import kv_quant
from repro_torch.models.common import ModelConfig, resolve_device


class OutOfBlocks(RuntimeError):
    pass


class PoolExhausted(OutOfBlocks):
    """Pool exhaustion with context: which request hit the wall, how many
    tokens are live in the pool, and how many blocks remain free — the
    signal the preempting scheduling policy consumes (and the clear error
    FCFS surfaces instead of failing deep in the allocator).
    ``quarantined_shards`` / ``live_shards`` tell "pool too small" from
    "pool degraded by a shard fault"."""

    def __init__(self, message: str, *, rid: Optional[int] = None,
                 live_tokens: int = 0, free_blocks: int = 0,
                 quarantined_shards: Tuple[int, ...] = (),
                 live_shards: Tuple[int, ...] = ()):
        super().__init__(message)
        self.rid = rid
        self.live_tokens = live_tokens
        self.free_blocks = free_blocks
        self.quarantined_shards = tuple(quarantined_shards)
        self.live_shards = tuple(live_shards)

    @property
    def degraded(self) -> bool:
        """True when the pool was exhausted with some shards quarantined."""
        return bool(self.quarantined_shards)


@dataclasses.dataclass
class PagedKVCache:
    cfg: ModelConfig
    num_blocks: int
    block_size: int = 16
    n_shards: int = 1
    kv_dtype: str = "bf16"             # "bf16" (the model's dtype) | "int8"
    device: object = "cuda"

    def __post_init__(self):
        if self.num_blocks % self.n_shards:
            raise ValueError(
                f"num_blocks ({self.num_blocks}) must divide evenly over "
                f"n_shards ({self.n_shards}) — the pool's block axis is "
                f"sharded contiguously over the attention workers")
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype must be 'bf16' or 'int8'; "
                             f"got {self.kv_dtype!r}")
        self.device = resolve_device(self.device)
        hd = self.cfg.resolved_head_dim
        L, Hkv = self.cfg.num_layers, self.cfg.num_kv_heads
        pool_dtype = torch.int8 if self.kv_dtype == "int8" else self.cfg.dtype
        self.k_pool = torch.zeros(
            (L, Hkv, self.num_blocks, self.block_size, hd), dtype=pool_dtype,
            device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        # int8: fp32 per-token scale pools mirroring the block axis (scales
        # follow blocks); None for bf16 pools
        self.k_scale = self.v_scale = None
        if self.kv_dtype == "int8":
            self.k_scale = torch.zeros(
                (L, Hkv, self.num_blocks, self.block_size),
                dtype=torch.float32, device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        npb = self.blocks_per_shard
        # per-shard free lists: shard s owns global ids [s·npb, (s+1)·npb)
        self._free_shard: List[List[int]] = [
            list(range(s * npb, (s + 1) * npb)) for s in range(self.n_shards)]
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
        # shards quarantined by fault recovery: their free lists are kept
        # (blocks drain back) but nothing is allocated from them
        self._quarantined: set = set()
        # memoised device index tensors keyed by the gathered block ids
        self._gather_idx_cache: Dict[Tuple[int, ...], torch.Tensor] = {}

    @property
    def blocks_per_shard(self) -> int:
        return self.num_blocks // self.n_shards

    @property
    def free(self) -> List[int]:
        """All ALLOCATABLE free block ids, shard by shard (a quarantined
        shard's drained blocks excluded; read-only copy)."""
        return [b for s, shard in enumerate(self._free_shard)
                for b in shard if s not in self._quarantined]

    @property
    def num_free(self) -> int:
        """Allocatable free blocks (quarantined shards contribute none)."""
        return sum(len(shard) for s, shard in enumerate(self._free_shard)
                   if s not in self._quarantined)

    # ---------------- shard health (fault-recovery surface) ----------------
    @property
    def live_shards(self) -> List[int]:
        """Shards accepting allocations (not quarantined)."""
        return [s for s in range(self.n_shards) if s not in self._quarantined]

    @property
    def quarantined_shards(self) -> Tuple[int, ...]:
        return tuple(sorted(self._quarantined))

    @property
    def capacity_blocks(self) -> int:
        """Blocks the pool can hold now: ``num_blocks`` when healthy, the
        surviving shards' share when degraded — what every "can this
        request ever fit" check reads."""
        return self.blocks_per_shard * (self.n_shards -
                                        len(self._quarantined))

    def seqs_on_shard(self, shard: int) -> List[int]:
        """Live sequences holding at least one block on ``shard`` (a
        borrower of a donor's block there too): the victims its death
        forces through recovery."""
        lo, hi = shard * self.blocks_per_shard, \
            (shard + 1) * self.blocks_per_shard
        return sorted(sid for sid, table in self.tables.items()
                      if any(lo <= b < hi for b in table))

    def quarantine_shard(self, shard: int) -> None:
        """Mask ``shard`` out of the allocator: nothing new lands on it and
        every capacity view drops to the survivors. Its free list is kept
        (blocks drain back as victims release their refs) but stays
        unallocatable until :meth:`rejoin_shard`."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} outside [0, {self.n_shards})")
        self._quarantined.add(shard)

    def rejoin_shard(self, shard: int) -> None:
        """Restore a quarantined shard: the blocks that drained back to its
        free list are allocatable again."""
        self._quarantined.discard(shard)

    def shard_of(self, block_id: int) -> int:
        return block_id // self.blocks_per_shard

    def _pop_block(self, seq_slot: int) -> int:
        """Pop a free block for a sequence's ``seq_slot``-th table entry:
        round robin over the LIVE shards (slot ``seq_slot mod live``), or
        the most-free live shard when that one is empty."""
        live = self.live_shards
        if not live:
            raise OutOfBlocks("every pool shard is quarantined")
        target = live[seq_slot % len(live)]
        if not self._free_shard[target]:
            target = max(live, key=lambda s: len(self._free_shard[s]))
            if not self._free_shard[target]:
                raise OutOfBlocks("pool exhausted")
        return self._free_shard[target].pop()

    def _degraded_kw(self) -> Dict:
        """The shard-health context every ``PoolExhausted`` carries."""
        return {"quarantined_shards": self.quarantined_shards,
                "live_shards": tuple(self.live_shards)}

    def _degraded_note(self) -> str:
        if not self._quarantined:
            return ""
        q = sorted(self._quarantined)
        return (f" [pool DEGRADED: shard(s) {q} quarantined after a fault; "
                f"{len(self.live_shards)} of {self.n_shards} shards live, "
                f"capacity {self.capacity_blocks} of {self.num_blocks} "
                f"blocks]")

    # ---------------- allocation ----------------
    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.num_free >= self.blocks_needed(n_tokens)

    def _exhausted(self, message: str, rid: int) -> PoolExhausted:
        """``PoolExhausted`` with the pool's context and degraded note."""
        return PoolExhausted(message + self._degraded_note(), rid=rid,
                             live_tokens=sum(self.lengths.values()),
                             free_blocks=self.num_free, **self._degraded_kw())

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
        for i in range(len(table), len(table) + need):
            b = self._pop_block(i)       # the i-th block on shard i mod n
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
        """Copy-on-write fork of `seq_id`'s table slot: pop a private block
        (same round-robin slot rule), copy the physical tile — and its
        scale tile — in place, decrement the donor's refcount."""
        old = self.tables[seq_id][slot]
        new = self._pop_block(slot)
        self.refcounts[old] -= 1
        self.refcounts[new] = 1
        self.tables[seq_id][slot] = new
        self._borrowed.get(seq_id, set()).discard(old)
        self.k_pool[:, :, new] = self.k_pool[:, :, old]
        self.v_pool[:, :, new] = self.v_pool[:, :, old]
        if self.k_scale is not None:   # the scale tile forks with its block
            self.k_scale[:, :, new] = self.k_scale[:, :, old]
            self.v_scale[:, :, new] = self.v_scale[:, :, old]
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
                b = self._pop_block(len(table))
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
                self._free_shard[self.shard_of(b)].append(b)
        self._borrowed.pop(seq_id, None)
        del self.lengths[seq_id]

    @property
    def used_blocks(self) -> int:
        """PHYSICAL blocks in use (a shared block counts once)."""
        return self.num_blocks - self.num_free

    @property
    def pool_bytes_resident(self) -> int:
        """Resident bytes of the whole pool allocation: K + V value pools
        plus (int8) the fp32 scale pools — hd + 4 bytes per token-head
        instead of 2·hd for a bf16 pool."""
        total = 2 * self.k_pool.numel() * self.k_pool.element_size()
        if self.k_scale is not None:
            total += 2 * self.k_scale.numel() * self.k_scale.element_size()
        return total

    def bytes_per_live_token(self) -> int:
        """Pool bytes one token of context occupies (K + V, all layers,
        scales included) — the per-step KV read accounting unit."""
        L, Hkv, _, _, hd = self.k_pool.shape
        per = 2 * L * Hkv * hd * self.k_pool.element_size()
        if self.k_scale is not None:
            per += 2 * L * Hkv * self.k_scale.element_size()
        return per

    def unique_live_tokens(self, seq_ids: Optional[Sequence[int]] = None
                           ) -> int:
        """Live tokens over UNIQUE physical blocks — a block shared by K
        sequences counts once, at the deepest fill any sharer reaches."""
        return sum(self._block_fill(seq_ids).values())

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

    def block_table_shards(self, seq_ids: Sequence[int]
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-shard compacted block tables for the block-partition decode
        step. Returns (local_tables, local_positions, shard_tokens):
          * local_tables (n_shards, B, nbl) int32 — block ids LOCAL to each
            shard's slice (global − shard·blocks_per_shard); pad slots 0;
          * local_positions (n_shards, B, nbl) int32 — each slot's global
            base position (slot index in the sequence's table ×
            block_size), POS_PAD on pad slots so every mask kills them;
          * shard_tokens (n_shards, B) int32 — live tokens per (shard,
            seq), a physical block shared in the batch counted once, for
            the first sequence that references it, at the deepest fill any
            sharer reaches."""
        B = len(seq_ids)
        n, npb, bs = self.n_shards, self.blocks_per_shard, self.block_size
        per = [[[] for _ in range(B)] for _ in range(n)]  # (local id, base)
        shard_tokens = np.zeros((n, B), np.int32)
        fill = self._block_fill(seq_ids)
        counted: set = set()
        for i, sid in enumerate(seq_ids):
            for j, g in enumerate(self.tables[sid]):
                s = self.shard_of(g)
                per[s][i].append((g - s * npb, j * bs))
                if g not in counted:
                    counted.add(g)
                    shard_tokens[s, i] += fill[g]
        nbl = max([1] + [len(per[s][i]) for s in range(n) for i in range(B)])
        local_tables = np.zeros((n, B, nbl), np.int32)
        local_positions = np.full((n, B, nbl), POS_PAD, np.int32)
        for s in range(n):
            for i in range(B):
                for j, (lb, base) in enumerate(per[s][i]):
                    local_tables[s, i, j] = lb
                    local_positions[s, i, j] = base
        return local_tables, local_positions, shard_tokens

    def shard_live_tokens(self, seq_ids: Optional[Sequence[int]] = None
                          ) -> np.ndarray:
        """(n_shards,) live tokens held per pool shard (all sequences by
        default); a shared physical block counts once, at the deepest fill
        any sharer reaches."""
        totals = np.zeros((self.n_shards,), np.int64)
        for g, t in self._block_fill(seq_ids).items():
            totals[self.shard_of(g)] += t
        return totals

    def _block_fill(self, seq_ids: Optional[Sequence[int]] = None
                    ) -> Dict[int, int]:
        """Physical block id -> live tokens in it, at the deepest fill any
        of ``seq_ids`` (default: every sequence) reaches."""
        if seq_ids is None:
            seq_ids = list(self.tables)
        fill: Dict[int, int] = {}
        bs = self.block_size
        for sid in seq_ids:
            length = self.lengths[sid]
            for j, g in enumerate(self.tables[sid]):
                t = min(bs, max(0, length - j * bs))
                if t > fill.get(g, 0):
                    fill[g] = t
        return fill

    # ---------------- data movement ----------------
    def write_prefill(self, seq_id: int, k: torch.Tensor, v: torch.Tensor,
                      start_token: int = 0,
                      length: Optional[int] = None) -> None:
        """k/v: HEAD-MAJOR (L, Hkv, S, hd) for this sequence's tokens
        [start_token, start_token + S) (start block-aligned), scattered in
        place into its blocks. ``length`` (default S) is the number of real
        rows when k/v come padded from a compiled prefill: only those are
        written, so no pad row lands in a block. A write into a
        still-shared BORROWED block copy-on-writes first; the real length
        must equal the allocated length minus start_token."""
        if start_token % self.block_size:
            raise ValueError(
                f"write_prefill start_token ({start_token}) must be "
                f"block-aligned (block_size={self.block_size})")
        if length is not None:
            if not 0 <= length <= k.shape[2]:
                raise ValueError(f"write_prefill length {length} outside "
                                 f"the {k.shape[2]} rows given")
            k, v = k[:, :, :length], v[:, :, :length]
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
        ks = vs = None
        if self.kv_dtype == "int8":    # quantize at write time, pre-pad
            k, ks = kv_quant.quantize_kv(k)
            v, vs = kv_quant.quantize_kv(v)
        pad = nb * self.block_size - S
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        L, Hkv, _, hd = k.shape
        idx = torch.as_tensor(table[b0:b0 + nb], device=self.device)
        self.k_pool[:, :, idx] = k.reshape(L, Hkv, nb, self.block_size, hd)
        self.v_pool[:, :, idx] = v.reshape(L, Hkv, nb, self.block_size, hd)
        if ks is not None:
            if pad:
                ks = torch.nn.functional.pad(ks, (0, pad))
                vs = torch.nn.functional.pad(vs, (0, pad))
            self.k_scale[:, :, idx] = ks.reshape(L, Hkv, nb, self.block_size)
            self.v_scale[:, :, idx] = vs.reshape(L, Hkv, nb, self.block_size)

    def write_prefill_chunk(self, seq_id: int, k: torch.Tensor,
                            v: torch.Tensor, start_token: int,
                            length: Optional[int] = None) -> None:
        """Incremental chunk write — the chunked-prefill data path: extend
        the allocation to cover exactly this chunk, then scatter the
        chunk's head-major (L, Hkv, C, hd) K/V at `start_token`; of a
        padded chunk only its first ``length`` rows (default C)."""
        target = start_token + (k.shape[2] if length is None else length)
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
        self.write_prefill(seq_id, k, v, start_token=start_token,
                           length=length)

    def write_token(self, seq_id: int, k: torch.Tensor, v: torch.Tensor,
                    position: int) -> None:
        """k/v: (L, Hkv, hd) for one token at `position` (0-based), written
        in place; a shared target block copy-on-writes first."""
        slot = position // self.block_size
        if self.refcounts[self.tables[seq_id][slot]] > 1:
            self._cow_block(seq_id, slot)      # never write a donor's block
        blk = self.tables[seq_id][slot]
        off = position % self.block_size
        if self.kv_dtype == "int8":
            k, ks = kv_quant.quantize_token(k)
            v, vs = kv_quant.quantize_token(v)
            self.k_scale[:, :, blk, off] = ks
            self.v_scale[:, :, blk, off] = vs
        self.k_pool[:, :, blk, off] = k
        self.v_pool[:, :, blk, off] = v

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
        kn = k_new.transpose(1, 2)                           # (L, Hkv, B, hd)
        vn = v_new.transpose(1, 2)
        if self.kv_dtype == "int8":
            kn, kns = kv_quant.quantize_token(kn)            # (L, Hkv, B)
            vn, vns = kv_quant.quantize_token(vn)
            self.k_scale[:, :, blk, off] = kns
            self.v_scale[:, :, blk, off] = vns
        self.k_pool[:, :, blk, off] = kn
        self.v_pool[:, :, blk, off] = vn

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

    def gather_prefix(self, seq_id: int, n_tokens: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """HEAD-MAJOR (L, Hkv, n_tokens, hd) K/V of this sequence's first
        `n_tokens` (block-aligned) — the context operand of the prefix-
        sharing suffix prefill (reference ``kvcache.py:750``). An int8 pool
        dequantizes with its scales into the model's dtype. The one dense
        read of the pool: once per ADMISSION, never per decode step."""
        return gather_blocks(
            self.k_pool, self.v_pool, self.k_scale, self.v_scale,
            self.gather_prefix_indices(seq_id, n_tokens), self.cfg.dtype)

    # ---------------- block-granular KV handoff (disaggregated cluster) ----
    def export_seqs(self, seq_ids: Sequence[int]) -> "KVHandoffPayload":
        """The given sequences' KV state as a block-granular
        :class:`KVHandoffPayload`, the prefill → decode wire unit
        (reference ``kvcache.py:799``). It carries each sequence's table
        (source block ids, in slot order) and every referenced physical
        block exactly once, so a block several exported tables share
        crosses once. The tiles live on the host (pinned when the pool is
        on the card): one device gather, one device-to-host copy, and a
        synchronisation before this returns. The source sequences are NOT
        freed."""
        missing = [sid for sid in seq_ids if sid not in self.tables]
        if missing:
            raise ValueError(
                f"export_seqs: sequence(s) {missing} have no table in this "
                f"pool — only admitted, prefilled sequences can be exported")
        ids: List[int] = []
        seen: set = set()
        for sid in seq_ids:
            for b in self.tables[sid]:
                if b not in seen:
                    seen.add(b)
                    ids.append(b)
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        tiles = [_to_host(t, idx) for t in (self.k_pool, self.v_pool,
                                            self.k_scale, self.v_scale)]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        k, v, ks, vs = tiles
        return KVHandoffPayload(
            tables={sid: tuple(self.tables[sid]) for sid in seq_ids},
            lengths={sid: self.lengths[sid] for sid in seq_ids},
            block_ids=tuple(ids), k_blocks=k, v_blocks=v,
            block_size=self.block_size, k_scales=ks, v_scales=vs)

    def prealloc_handoff(self, payload: "KVHandoffPayload"
                         ) -> Dict[int, int]:
        """Phase 1 of an import (reference ``kvcache.py:842``): reserve one
        destination block per unique payload block, popped by the
        round-robin slot rule of its FIRST referencing table entry, and
        rebuild tables, lengths, refcounts (the number of referencing
        tables, so shared prefixes stay shared) and ``_borrowed``. No bytes
        move. All-or-nothing: a pool that cannot cover the payload raises
        :class:`PoolExhausted` with nothing allocated. Returns the src →
        dst block mapping."""
        if payload.block_size != self.block_size:
            raise ValueError(
                f"prealloc_handoff: payload block_size "
                f"({payload.block_size}) != destination pool block_size "
                f"({self.block_size}) — handoff is block-granular and "
                f"never re-chunks tiles")
        for rid in payload.tables:
            if rid in self.tables:
                raise ValueError(
                    f"prealloc_handoff: seq {rid} already has a table on "
                    f"the destination pool — a handoff import must land on "
                    f"a fresh rid")
        need = len(payload.block_ids)
        have = self.num_free
        rid0 = next(iter(payload.tables))
        if need > have:
            raise self._exhausted(
                f"handoff prealloc of {len(payload.tables)} seq(s) needs "
                f"{need} blocks, have {have}", rid0)
        first_slot: Dict[int, int] = {}
        for table in payload.tables.values():
            for slot, b in enumerate(table):
                first_slot.setdefault(b, slot)
        mapping: Dict[int, int] = {}
        try:
            for b in payload.block_ids:
                mapping[b] = self._pop_block(first_slot[b])
        except OutOfBlocks:
            for dst in mapping.values():   # all-or-nothing: roll back
                self._free_shard[self.shard_of(dst)].append(dst)
            raise self._exhausted(
                f"handoff prealloc exhausted the pool after "
                f"{len(mapping)} of {need} blocks", rid0) from None
        owners: Dict[int, int] = {}     # dst block -> first referencing rid
        for rid, src_table in payload.tables.items():
            dst_table = [mapping[b] for b in src_table]
            self.tables[rid] = dst_table
            self.lengths[rid] = payload.lengths[rid]
            for d in dst_table:
                self.refcounts[d] = self.refcounts.get(d, 0) + 1
                owners.setdefault(d, rid)
        for rid, src_table in payload.tables.items():
            borrowed = {mapping[b] for b in src_table
                        if owners[mapping[b]] != rid}
            if borrowed:
                self._borrowed[rid] = borrowed
        return mapping

    def write_handoff_blocks(self, payload: "KVHandoffPayload",
                             mapping: Dict[int, int],
                             start: int, stop: int) -> int:
        """Phase 2 of an import (reference ``kvcache.py:915``): land payload
        blocks [start, stop) (indices into ``payload.block_ids``) at their
        mapped destination ids, IN PLACE: one host-to-device copy of the
        range, then one ``index_copy_`` per pool (the captured graphs read
        the pools by address). The dtypes are checked before any write.
        Returns the wire bytes landed."""
        if payload.k_scales is not None and self.k_scale is None:
            raise ValueError(
                "write_handoff_blocks: payload carries int8 scales but "
                "the destination pool is not kv_dtype='int8' — source "
                "and destination tiers must agree on kv_dtype")
        if payload.k_scales is None and self.k_scale is not None:
            raise ValueError(
                "write_handoff_blocks: destination pool is kv_dtype='int8' "
                "but the payload carries no scales — source and destination "
                "tiers must agree on kv_dtype")
        if payload.k_blocks.dtype != self.k_pool.dtype:
            raise ValueError(
                f"write_handoff_blocks: payload tiles are "
                f"{payload.k_blocks.dtype} but the destination pool holds "
                f"{self.k_pool.dtype}")
        ids = payload.block_ids[start:stop]
        if not ids:
            return 0
        dst = torch.as_tensor([mapping[b] for b in ids], dtype=torch.long,
                              device=self.device)
        pairs = [(self.k_pool, payload.k_blocks),
                 (self.v_pool, payload.v_blocks)]
        if payload.k_scales is not None:
            pairs += [(self.k_scale, payload.k_scales),
                      (self.v_scale, payload.v_scales)]
        for pool, tiles in pairs:
            # the tiles are block-major in memory: [start, stop) is one
            # contiguous host range
            part = tiles.movedim(2, 0)[start:stop].to(self.device,
                                                      non_blocking=True)
            pool.index_copy_(2, dst, part.movedim(0, 2))
        return payload.bytes_of_blocks(stop - start)

    def import_seqs(self, payload: "KVHandoffPayload") -> Dict[int, int]:
        """One-shot import: prealloc + write every payload block
        (reference ``kvcache.py:951``). Returns the src → dst mapping."""
        mapping = self.prealloc_handoff(payload)
        self.write_handoff_blocks(payload, mapping, 0, payload.n_blocks)
        return mapping


def _to_host(pool: Optional[torch.Tensor],
             idx: torch.Tensor) -> Optional[torch.Tensor]:
    """Pool blocks ``idx`` as a host tensor viewed (L, Hkv, n, ...) over
    block-major memory (n, L, Hkv, ...): one gather on the pool's device,
    one copy into a pinned buffer when that device is the card (the
    caller synchronises before reading it)."""
    if pool is None:
        return None
    tiles = pool.movedim(2, 0)[idx]                # (n, L, Hkv, ...)
    if tiles.device.type == "cpu":
        return tiles.movedim(0, 2)
    host = torch.empty(tiles.shape, dtype=tiles.dtype, pin_memory=True)
    host.copy_(tiles, non_blocking=True)
    return host.movedim(0, 2)


@dataclasses.dataclass(frozen=True)
class KVHandoffPayload:
    """Block-granular KV handoff unit, prefill engine → decode replica
    (reference ``kvcache.py:962``).

    ``tables`` keeps each sequence's block chain in SOURCE ids;
    ``block_ids`` lists every referenced physical block once, in the order
    of the stacked head-major host tiles ``k_blocks`` / ``v_blocks``
    ``(L, Hkv, n_unique, bs, hd)`` (block-major in memory). int8 pools also
    ship ``k_scales`` / ``v_scales`` ``(L, Hkv, n_unique, bs)`` fp32 in the
    same order: scales follow their blocks across the wire."""
    tables: Dict[int, Tuple[int, ...]]
    lengths: Dict[int, int]
    block_ids: Tuple[int, ...]
    k_blocks: torch.Tensor
    v_blocks: torch.Tensor
    block_size: int
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def n_blocks(self) -> int:
        return len(self.block_ids)

    @property
    def nbytes(self) -> int:
        """Total wire bytes (K + V tiles, plus scale tiles when int8)."""
        tiles = [self.k_blocks, self.v_blocks]
        if self.k_scales is not None:
            tiles += [self.k_scales, self.v_scales]
        return sum(t.numel() * t.element_size() for t in tiles)

    def bytes_of_blocks(self, n: int) -> int:
        """Wire bytes of `n` payload blocks (K + V, scales included)."""
        if not self.n_blocks:
            return 0
        return int(self.nbytes * n // self.n_blocks)


def gather_blocks(k_pool: torch.Tensor, v_pool: torch.Tensor,
                  k_scale: Optional[torch.Tensor],
                  v_scale: Optional[torch.Tensor], blocks: torch.Tensor,
                  dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pool blocks ``blocks`` (nb,) (device ids) as HEAD-MAJOR
    (L, Hkv, nb·bs, hd) K/V, int8 pools dequantized with their scales into
    ``dtype``. The token count comes from the operand's shape, so the
    compiled suffix prefill runs it inside its graph (the reference fuses
    the same gather into its jitted program, ``llm_engine.py:222``)."""
    idx = blocks.long()
    L, Hkv, _, bs, hd = k_pool.shape
    n_tokens = idx.shape[0] * bs
    k = k_pool[:, :, idx].reshape(L, Hkv, n_tokens, hd)
    v = v_pool[:, :, idx].reshape(L, Hkv, n_tokens, hd)
    if k_scale is not None:       # admission-time dequant (off hot path)
        ks = k_scale[:, :, idx].reshape(L, Hkv, n_tokens)
        vs = v_scale[:, :, idx].reshape(L, Hkv, n_tokens)
        k = kv_quant.dequantize_kv(k, ks, dtype)
        v = kv_quant.dequantize_kv(v, vs, dtype)
    return k, v
