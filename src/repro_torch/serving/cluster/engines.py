"""PrefillEngine / DecodeEngine — the disaggregated split of ``LLMEngine``.
Port of ``repro/serving/cluster/engines.py``: the same role overlays on
the port's engine, through the hooks it already has (``_pre_admit_tick``,
``_stall_waiver``, ``_free_blocks_for_chunk``, ``_decode_iteration``,
``_handle_shard_death``, ``has_work``), with ``device`` passed through.

Both are thin role overlays on the unified engine (same placement
strategies, same scheduler, same fault machinery); ``DisaggConfig`` names
the role and the handoff knobs. The split is the sglang-style prefill/
decode disaggregation:

  * a :class:`PrefillEngine` runs admission + prefill only. The moment a
    request's prefill completes (its first token is sampled), its KV
    blocks are EXPORTED (``PagedKVCache.export_seqs`` — block-granular,
    no densify) and the request is detached: the engine never decodes.
    With ``retain_prefixes`` the exported prompt's blocks stay resident
    as prefix-sharing donors (LRU-evicted under pool pressure), so
    same-prefix followers routed here skip their shared prefill.
  * a :class:`DecodeEngine` receives handoffs and walks them through the
    Prealloc → Transfer → Waiting lifecycle (``cluster/queues.py``); a
    fully transferred request joins the PREBUILT decode batch via
    ``RequestScheduler.admit_prefilled`` — no prefill forward ever runs
    for it. Preemption/fault recovery still recomputes locally (a decode
    replica CAN prefill — recovery is the one path that does).

Greedy outputs through the split equal a single engine's on the CPU: the
exported pool bytes are the prefill engine's verbatim, positions are
preserved block-granularly across the wire, and sampling streams are
per-request (seeded), independent of which engine draws them. On the card
each role replays only its own graphs: a prefill engine never calls its
decode step (no decode graph is captured), a decode engine runs the
prefill programs only to recover a shard death; decode batches form at
other steps than in one engine, so a bf16 row may round differently.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from repro_torch.serving.config import DisaggConfig
from repro_torch.serving.kvcache import KVHandoffPayload, PoolExhausted
from repro_torch.serving.llm_engine import LLMEngine
from repro_torch.serving.request import Request, State
from repro_torch.serving.cluster.queues import (Handoff, HandoffError,
                                                PreallocQueue, TransferQueue,
                                                WaitingQueue)

# callback a PrefillEngine fires per completed prefill: (request, payload)
HandoffSink = Callable[[Request, KVHandoffPayload], None]


class PrefillEngine(LLMEngine):
    """Prefill-only role: admit, prefill, export, detach — never decode."""

    def __init__(self, cfg, params, engine_config=None,
                 disagg: Optional[DisaggConfig] = None,
                 fault_injector=None, replica: int = 0, *, device="cuda",
                 **overrides):
        super().__init__(cfg, params, engine_config,
                         fault_injector=fault_injector, device=device,
                         **overrides)
        disagg = disagg or DisaggConfig(role="prefill")
        if disagg.role != "prefill":
            disagg = disagg.replace(role="prefill")
        self.disagg = disagg
        self.replica = replica
        # rid -> detached Request whose prompt blocks stay resident as
        # prefix donors (insertion order = LRU order; re-export refreshes)
        self._retained: Dict[int, Request] = {}
        # where exported handoffs go (DisaggCluster wires this to the
        # paired DecodeEngine's enqueue_handoff); None = caller collects
        # via the handoff_out events / collect_handoffs()
        self.on_handoff: Optional[HandoffSink] = None
        self._outbox: List[Handoff] = []

    # ---- the role: harvest instead of decode ----
    def _decode_iteration(self) -> None:
        """A prefill engine never decodes. Every running request whose
        prefill just completed (first token sampled) is exported and
        detached — the handoff payload carries its pool blocks verbatim."""
        ready = [r for r in self.sched.running
                 if r.state == State.RUNNING
                 and self.sched.prefill_done(r.rid) and r.output]
        for req in ready:
            payload = self.kv.export_seqs([req.rid])
            self.stats.kv_bytes_transferred += payload.nbytes
            self._emit("handoff_out", req.rid, blocks=payload.n_blocks,
                       nbytes=payload.nbytes, replica=self.replica)
            self._detach(req)
            h = Handoff(request=req, payload=payload, replica=self.replica,
                        enqueued_step=self._step_no)
            if self.on_handoff is not None:
                self.on_handoff(req, payload)
            else:
                self._outbox.append(h)

    def collect_handoffs(self) -> List[Handoff]:
        """Drain exported handoffs (only populated when no ``on_handoff``
        sink is wired — the poll-style transport)."""
        out, self._outbox = self._outbox, []
        return out

    def _detach(self, req: Request) -> None:
        """Remove an exported request from the batch. With prefix
        retention its blocks stay resident (table + PrefixIndex entry
        kept) so followers can share them; otherwise they free now."""
        rid = req.rid
        self.sched.running.remove(req)
        req.state = State.TRANSFERRING
        if (self.disagg.retain_prefixes and self.disagg.max_retained_seqs
                and self.sched.prefix_index is not None):
            self.sched._shared.pop(rid, None)
            self._retained[rid] = req
        else:
            self.sched._release(rid)

    @property
    def retained_rids(self) -> List[int]:
        return list(self._retained)

    def _evict_retained(self, rid: int, cause: str) -> None:
        self._retained.pop(rid, None)
        self.sched._release(rid)
        self._emit("retain_evict", rid, cause=cause, replica=self.replica)

    # ---- pool-pressure integration for retained donors ----
    def _pre_admit_tick(self) -> None:
        """Retained donors yield to live work: enforce the retention cap,
        then evict LRU donors until the waiting head's admission fits —
        preferring to spare the head's own matched donor (evicting it
        would forfeit the prefix skip the retention exists for)."""
        while len(self._retained) > self.disagg.max_retained_seqs:
            self._evict_retained(next(iter(self._retained)), cause="cap")
        while self.sched.waiting and self._retained \
                and not self._head_fits():
            head = self.sched.waiting[0]
            donor, _ = self.sched._match_prefix(
                head, self.sched.stored_tokens(head))
            victim = next((r for r in self._retained if r != donor), None)
            if victim is None:
                victim = next(iter(self._retained))  # the donor itself:
                # correctness (admission) beats affinity (the skip)
            self._evict_retained(victim, cause="pressure")

    def _head_fits(self) -> bool:
        """Would ``sched.admit`` take the waiting head right now? Mirrors
        the admission arithmetic (shared-prefix discount, chunked first-
        chunk charge) without mutating anything."""
        sched, head = self.sched, self.sched.waiting[0]
        if len(sched.running) >= sched.max_batch:
            return True          # blocked on batch slots, not on blocks —
            # evicting retained donors cannot help
        stored = sched.stored_tokens(head)
        donor, shared = sched._match_prefix(head, stored)
        chunk = sched.chunk_tokens
        if chunk:
            if self.kv.blocks_needed(stored + sched.decode_headroom) > \
                    self.kv.capacity_blocks:
                return True      # can NEVER fit — eviction cannot help;
                # let the stall check surface it
            first = min(chunk, stored - shared)
            if not sched._chunked_commitment_ok(donor, shared, first):
                return False
        else:
            first = stored - shared
        return self.kv.can_allocate(first + sched.decode_headroom)

    def _free_blocks_for_chunk(self, req: Request, need: int) -> bool:
        """Chunk growth evicts retained donors before stalling: a prefill
        engine has no running decoders to wait out, so retained blocks are
        the only ones that will ever free."""
        while self.kv.num_free < need and self._retained:
            self._evict_retained(next(iter(self._retained)),
                                 cause="chunk_pressure")
        return super()._free_blocks_for_chunk(req, need)

    def _handle_shard_death(self, shard: int, cause: str) -> None:
        """Retained donors holding blocks on the dead shard are dropped
        (their bytes are lost — a follower must not map onto them); live
        requests recover through the base preempt-and-recompute path."""
        victims = set(self.kv.seqs_on_shard(shard))
        super()._handle_shard_death(shard, cause)
        for rid in [r for r in self._retained if r in victims]:
            self._evict_retained(rid, cause="shard_down")


class DecodeEngine(LLMEngine):
    """Decode role: imports handoffs, decodes prebuilt batches."""

    def __init__(self, cfg, params, engine_config=None,
                 disagg: Optional[DisaggConfig] = None,
                 fault_injector=None, replica: int = 0, *, device="cuda",
                 **overrides):
        super().__init__(cfg, params, engine_config,
                         fault_injector=fault_injector, device=device,
                         **overrides)
        disagg = disagg or DisaggConfig(role="decode")
        if disagg.role != "decode":
            disagg = disagg.replace(role="decode")
        self.disagg = disagg
        self.replica = replica
        self.prealloc_q = PreallocQueue()
        self.transfer_q = TransferQueue()
        self.waiting_q = WaitingQueue()

    # ---- ingress ----
    def enqueue_handoff(self, request: Request,
                        payload: KVHandoffPayload) -> Handoff:
        """Accept a prefill engine's export. Terminally oversized payloads
        (cannot fit even an EMPTY healthy pool) fail fast with full
        context; everything else queues for prealloc."""
        if payload.block_size != self.kv.block_size:
            raise HandoffError(
                f"handoff for request {request.rid}: payload block_size "
                f"{payload.block_size} != pool block_size "
                f"{self.kv.block_size} on replica {self.replica}",
                rid=request.rid, replica=self.replica,
                blocks_in_flight=payload.n_blocks, stage="enqueue")
        if payload.n_blocks + self._headroom_blocks() > self.kv.num_blocks:
            raise HandoffError(
                f"handoff for request {request.rid} can never fit: "
                f"{payload.n_blocks} payload blocks + "
                f"{self._headroom_blocks()} headroom exceed the pool's "
                f"{self.kv.num_blocks} blocks on replica {self.replica}",
                rid=request.rid, replica=self.replica,
                blocks_in_flight=payload.n_blocks, stage="enqueue")
        request.state = State.TRANSFERRING
        h = Handoff(request=request, payload=payload, replica=self.replica,
                    enqueued_step=self._step_no)
        self.prealloc_q.push(h)
        self._emit("handoff_recv", request.rid, blocks=payload.n_blocks,
                   nbytes=payload.nbytes, replica=self.replica)
        return h

    def _headroom_blocks(self) -> int:
        return self.kv.blocks_needed(self.sched.decode_headroom)

    # ---- the per-step queue walk ----
    def _pre_admit_tick(self) -> None:
        """Drain the handoff lifecycle BEFORE this step's admission wave:
        faulted mid-transfer imports reset first (``_fault_tick`` already
        ran, so this step's shard deaths are visible), then prealloc →
        transfer → admit. A transfer that completes this step joins this
        very step's decode batch."""
        tr = self.trace
        if tr.on:
            tr.open("step.handoff")
            tr.open("handoff.prealloc")
        self._reset_faulted_transfers()
        self._advance_prealloc()
        if tr.on:
            tr.close()
        self._advance_transfer()
        if tr.on:
            tr.open("handoff.admit")
        self._advance_waiting()
        if tr.on:
            tr.close()
            tr.close()

    def _stall_waiver(self) -> bool:
        """Handoffs in flight hold pool blocks while nothing runs yet — a
        state the single-engine stall check would misread as permanent."""
        return bool(self.prealloc_q or self.transfer_q or self.waiting_q)

    def has_work(self) -> bool:
        return (super().has_work() or bool(self.prealloc_q)
                or bool(self.transfer_q) or bool(self.waiting_q))

    def _reset_faulted_transfers(self) -> None:
        """A shard death mid-transfer invalidates every handoff whose
        preallocated destination blocks live on the dead shard (its bytes
        are lost / partially landed): free the import, reset the cursor,
        and requeue at the FRONT of the prealloc queue — the retry
        preallocates fresh blocks on the survivors. Each reset burns one
        attempt; past ``max_transfer_attempts`` the handoff fails with
        full context instead of looping forever on a shrinking pool."""
        if not self.kv.quarantined_shards:
            return
        bad = set(self.kv.quarantined_shards)
        for q in (self.transfer_q, self.waiting_q):
            for h in q:
                table = self.kv.tables.get(h.rid)
                if table is None or \
                        not any(self.kv.shard_of(b) in bad for b in table):
                    continue
                q.remove(h)
                self.kv.free_seq(h.rid)
                in_flight = h.blocks_in_flight
                h.mapping = None
                h.cursor = 0
                h.attempts += 1
                self.stats.handoff_retries += 1
                if h.attempts >= self.disagg.max_transfer_attempts:
                    raise HandoffError(
                        f"handoff for request {h.rid} interrupted by shard "
                        f"death {h.attempts} time(s) on replica "
                        f"{self.replica} ({in_flight} blocks were in "
                        f"flight) — transfer attempt budget "
                        f"({self.disagg.max_transfer_attempts}) exhausted",
                        rid=h.rid, replica=self.replica,
                        blocks_in_flight=in_flight, stage="transfer")
                self.prealloc_q.push_front(h)
                self._emit("handoff_retry", h.rid, attempt=h.attempts,
                           blocks_lost=in_flight, replica=self.replica)

    def _advance_prealloc(self) -> None:
        """FCFS prealloc: the head reserves destination blocks as soon as
        the pool covers payload + decode headroom; a head that does not
        fit blocks the tail (same head-of-line contract as admission)."""
        while self.prealloc_q:
            h = self.prealloc_q.peek()
            if self.kv.num_free < h.payload.n_blocks + \
                    self._headroom_blocks():
                break
            try:
                h.mapping = self.kv.prealloc_handoff(h.payload)
            except PoolExhausted:
                break       # raced the headroom margin (borrowed blocks /
                # CoW forks); retry next step — capacity-wise it fits
            self.prealloc_q.pop()
            self.transfer_q.push(h)
            self._emit("prealloc", h.rid, blocks=h.payload.n_blocks,
                       replica=self.replica)

    def _advance_transfer(self) -> None:
        """Land blocks under the per-step wire budget
        (``transfer_blocks_per_step``; 0 = unbounded). The budget is
        shared across the queue in FIFO order, so a large import cannot
        starve a small one forever — the head finishes first."""
        budget = self.disagg.transfer_blocks_per_step or None
        tr = self.trace
        for h in self.transfer_q:
            if budget is not None and budget <= 0:
                break
            step = h.blocks_in_flight if budget is None \
                else min(budget, h.blocks_in_flight)
            stop = h.cursor + step
            if tr.on:
                tr.open("handoff.transfer", h.rid, step,
                        h.payload.bytes_of_blocks(step))
            self.stats.kv_bytes_transferred += self.kv.write_handoff_blocks(
                h.payload, h.mapping, h.cursor, stop)
            if tr.on:
                tr.close()
            h.cursor = stop
            if budget is not None:
                budget -= step
            if h.transferred:
                self.transfer_q.remove(h)
                self.waiting_q.push(h)
                self.stats.handoff_latencies.append(
                    time.time() - h.enqueue_s)
                self._emit("transfer_done", h.rid,
                           blocks=h.payload.n_blocks,
                           steps=self._step_no - h.enqueued_step,
                           replica=self.replica)

    def _advance_waiting(self) -> None:
        """Admit fully transferred requests into the PREBUILT decode
        batch — ``admit_prefilled`` skips allocation and prefill entirely;
        a full batch holds the queue (blocks stay resident) until slots
        retire."""
        while self.waiting_q:
            h = self.waiting_q.peek()
            if not self.sched.admit_prefilled(h.request):
                break
            self.waiting_q.pop()
            self._emit("handoff_admit", h.rid,
                       stored_tokens=self.kv.lengths[h.rid],
                       replica=self.replica)
