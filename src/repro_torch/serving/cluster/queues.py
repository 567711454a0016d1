"""Decode-side handoff lifecycle: Prealloc → Transfer → Waiting.
Port (a copy) of ``repro/serving/cluster/queues.py``.

A handoff (one request's exported KV payload, serving/kvcache.py) arriving
at a decode replica walks three queues — the sglang-style disaggregated
decode lifecycle:

  * :class:`PreallocQueue` — payloads waiting for destination blocks.
    FCFS: the head preallocates (``PagedKVCache.prealloc_handoff``) as
    soon as the pool can cover it; a head that doesn't fit blocks the
    tail, exactly like the scheduler's FCFS admission.
  * :class:`TransferQueue` — preallocated handoffs landing their blocks
    incrementally (``write_handoff_blocks``), a bounded number of blocks
    per engine step (``DisaggConfig.transfer_blocks_per_step`` — the
    wire budget).
  * :class:`WaitingQueue` — fully transferred handoffs waiting for a
    decode batch slot (``RequestScheduler.admit_prefilled``): the request
    joins the PREBUILT batch, skipping the prefill forward entirely.

Every failure path raises a contextual :class:`HandoffError` carrying the
request id, replica id, and blocks in flight — the ``PoolExhausted``
degraded-context convention, never a bare assert.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional

from repro_torch.serving.kvcache import KVHandoffPayload
from repro_torch.serving.request import Request


class HandoffError(RuntimeError):
    """A KV handoff failed terminally (payload can never fit, transfer
    retry budget exhausted). Carries full context — rid, replica, blocks
    in flight, lifecycle stage — mirroring ``PoolExhausted``'s
    degraded-context convention."""

    def __init__(self, message: str, *, rid: int, replica: int,
                 blocks_in_flight: int, stage: str):
        super().__init__(message)
        self.rid = rid
        self.replica = replica
        self.blocks_in_flight = blocks_in_flight
        self.stage = stage      # "enqueue" | "prealloc" | "transfer"


@dataclasses.dataclass
class Handoff:
    """One in-flight prefill→decode handoff."""

    request: Request
    payload: KVHandoffPayload
    replica: int
    enqueued_step: int                  # decode engine step at arrival
    enqueue_s: float = dataclasses.field(default_factory=time.time)
    # set by prealloc (src→dst block mapping); reset on transfer abort
    mapping: Optional[Dict[int, int]] = None
    cursor: int = 0                     # payload blocks written so far
    attempts: int = 0                   # transfer (re)starts consumed

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def blocks_in_flight(self) -> int:
        """Blocks this handoff still has to land (0 once transferred)."""
        return self.payload.n_blocks - self.cursor

    @property
    def transferred(self) -> bool:
        return self.mapping is not None and \
            self.cursor >= self.payload.n_blocks


class _FIFOQueue:
    """Minimal FIFO with stable iteration + mid-queue removal (shard-death
    recovery plucks faulted handoffs out of the middle)."""

    def __init__(self):
        self._items: List[Handoff] = []

    def push(self, h: Handoff) -> None:
        self._items.append(h)

    def push_front(self, h: Handoff) -> None:
        self._items.insert(0, h)

    def peek(self) -> Optional[Handoff]:
        return self._items[0] if self._items else None

    def pop(self) -> Handoff:
        return self._items.pop(0)

    def remove(self, h: Handoff) -> None:
        self._items.remove(h)

    def __iter__(self) -> Iterator[Handoff]:
        return iter(list(self._items))

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)


class PreallocQueue(_FIFOQueue):
    """Handoffs awaiting destination-block preallocation (FCFS)."""


class TransferQueue(_FIFOQueue):
    """Preallocated handoffs landing blocks under the per-step budget."""


class WaitingQueue(_FIFOQueue):
    """Fully transferred handoffs awaiting a decode batch slot."""
