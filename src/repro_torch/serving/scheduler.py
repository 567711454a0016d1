"""Iteration-level scheduling for the serving engines.
Port of ``repro/serving/scheduler.py`` (the whole file; it never touched
JAX).

:class:`SchedulingPolicy` + :class:`RequestScheduler` — the pluggable
scheduler behind :class:`repro_torch.serving.llm_engine.LLMEngine`. The
policy decides *who* gets admitted and *who* gets evicted under pool
pressure; the scheduler owns the queues and the KV-pool bookkeeping
(allocate on admit, free on retire/preempt). This is the hook surface
the prefix-sharing, chunked-prefill, and disaggregated-cluster layers
plug into (transfer-complete admission enters through
:meth:`RequestScheduler.admit_prefilled`). The legacy Orca-style
``Scheduler`` that served the deleted oracle engines is gone.

Preemption model (``PreemptingPolicy``): when a decode iteration needs more
blocks than the pool has free (requests outliving their ``decode_headroom``
margin), the policy picks a victim — LIFO over admission order, vLLM's
choice: the most recently admitted request has the least sunk work — whose
blocks are freed back to the pool. The victim's generated tokens are kept;
on re-admission its KV is *recomputed* by re-prefilling prompt + generated
tokens (minus the still-unstored last token — exactly the fault-tolerance
recovery path, paper §5), so greedy decoding resumes bit-identically.
Preempted requests re-enter at the FRONT of the waiting queue.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, List, Optional, Protocol, Sequence, Set, Tuple,
                    runtime_checkable)

from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.request import Request, State


# ======================================================================
# Pluggable scheduling (LLMEngine)
# ======================================================================

@runtime_checkable
class SchedulingPolicy(Protocol):
    """Decides admission order and preemption victims.

    ``select_victim`` returns the running request to evict under pool
    pressure, or ``None`` when the policy does not preempt (the engine then
    surfaces :class:`repro_torch.serving.kvcache.PoolExhausted`). ``running`` is
    in admission order; the victim must come from it.
    """

    name: str
    preemptible: bool

    def select_victim(self, running: Sequence[Request]) -> Optional[Request]:
        ...


class FCFSPolicy:
    """Strict arrival order, no eviction — the legacy behaviour, now
    explicit: under pool pressure the engine raises ``PoolExhausted``
    instead of stranding the pool mid-decode."""

    name = "fcfs"
    preemptible = False

    def select_victim(self, running: Sequence[Request]) -> Optional[Request]:
        return None

    def __repr__(self):
        return "FCFSPolicy()"


class PreemptingPolicy(FCFSPolicy):
    """FCFS admission + LIFO victim eviction under pool pressure."""

    name = "preempt"
    preemptible = True

    def select_victim(self, running: Sequence[Request]) -> Optional[Request]:
        # last admitted = least sunk prefill/decode work (vLLM's recompute
        # preemption picks the same victim); never the head of the batch —
        # evicting the oldest request could livelock admission against it.
        if len(running) < 2:
            return None
        return running[-1]

    def __repr__(self):
        return "PreemptingPolicy()"


class ChunkedPrefillPolicy:
    """Chunked admission: wraps an inner admission/eviction policy and
    admits PARTIAL prompts — the ROADMAP's reserved scheduler hook.

    Admission charges only the request's FIRST prefill chunk (plus decode
    headroom) against the free list instead of the whole prompt, so a long
    prompt is admitted while most of the pool is still held by running
    requests; its remaining blocks are allocated incrementally, one chunk
    per engine iteration, as earlier requests retire and free them. The
    scheduler carries a per-request prefill CURSOR (tokens computed so
    far); the engine runs at most one chunk per iteration alongside the
    full decode batch (``prefill_chunk_tokens`` is the per-iteration
    prefill token budget), so decode TBT never stalls behind a long
    prefill. Victim selection under pool pressure delegates to the inner
    policy unchanged."""

    def __init__(self, inner: SchedulingPolicy, chunk_tokens: int):
        if chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1; got {chunk_tokens}")
        self.inner = inner
        self.chunk_tokens = chunk_tokens
        self.name = f"chunked[{inner.name}]"

    @property
    def preemptible(self) -> bool:
        return self.inner.preemptible

    def select_victim(self, running: Sequence[Request]) -> Optional[Request]:
        return self.inner.select_victim(running)

    def __repr__(self):
        return (f"ChunkedPrefillPolicy({self.inner!r}, "
                f"chunk_tokens={self.chunk_tokens})")


POLICIES = {"fcfs": FCFSPolicy, "preempt": PreemptingPolicy}


def make_policy(name: str,
                prefill_chunk_tokens: Optional[int] = None
                ) -> SchedulingPolicy:
    """Build a policy by name, optionally wrapped for chunked prefill
    (``prefill_chunk_tokens`` is the per-iteration prefill token budget)."""
    try:
        policy = POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown scheduler policy {name!r}; "
                         f"choose from {sorted(POLICIES)}") from None
    if prefill_chunk_tokens is not None:
        policy = ChunkedPrefillPolicy(policy, prefill_chunk_tokens)
    return policy


# ======================================================================
# Prefix sharing (block-granular prompt-prefix index)
# ======================================================================

class PrefixIndex:
    """Block-granular prompt-prefix trie consulted at admission.

    Nodes are keyed by the token-content CHAIN of the first i full blocks —
    ``key_i = (key_{i-1}, tuple(prompt[i·bs:(i+1)·bs]))`` — so lookup is
    exact (dict equality on the token tuples; hashes only route buckets, a
    collision can never alias two different prefixes). A node records which
    LIVE requests hold a physical block with that content at that table
    slot; any of them can donate (``PagedKVCache.share_blocks`` maps the
    new request's table onto the donor's blocks and bumps refcounts).

    Only FULL blocks are indexed: a partial tail block is never shared at
    admission (the allocator's copy-on-write handles partial-tail sharing
    for explicit forks). Registrants are removed on retire AND on preempt —
    an evicted request's table is gone, so it can no longer donate (its
    blocks survive through the refcounts of any sharer that remains).
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._nodes: Dict[Tuple, Set[int]] = {}
        self._keys_of: Dict[int, List[Tuple]] = {}

    def _chain(self, prompt: Sequence[int]):
        key: Tuple = ()
        bs = self.block_size
        for i in range(len(prompt) // bs):
            key = (key, tuple(prompt[i * bs:(i + 1) * bs]))
            yield key

    def register(self, rid: int, prompt: Sequence[int]) -> None:
        """Index every full prompt block of `prompt` for `rid`. Idempotent
        and INCREMENTAL: re-registering (or registering a longer prefix of
        the same prompt) only adds blocks deeper than those already
        indexed, so callers need not track what is registered."""
        keys = self._keys_of.get(rid, [])
        for depth, key in enumerate(self._chain(prompt)):
            if depth < len(keys):
                continue                 # already indexed (shallower call)
            self._nodes.setdefault(key, set()).add(rid)
            keys.append(key)
        if keys:
            self._keys_of[rid] = keys

    def unregister(self, rid: int) -> None:
        for key in self._keys_of.pop(rid, ()):
            rids = self._nodes.get(key)
            if rids is not None:
                rids.discard(rid)
                if not rids:
                    del self._nodes[key]

    def match(self, prompt: Sequence[int]) -> Tuple[Optional[int], int]:
        """Deepest indexed block-aligned prefix of `prompt`: returns
        (donor rid, matched tokens) — (None, 0) when nothing matches.
        The donor is the smallest rid at the deepest node (deterministic);
        its table covers every shallower block too."""
        donor, matched = None, 0
        for i, key in enumerate(self._chain(prompt)):
            rids = self._nodes.get(key)
            if not rids:
                break
            donor = min(rids)
            matched = (i + 1) * self.block_size
        return donor, matched

    def __len__(self) -> int:
        return len(self._nodes)


@dataclasses.dataclass
class RequestScheduler:
    """Queue + KV-pool bookkeeping behind ``LLMEngine``.

    Design points:
      * the admission/eviction *decisions* are delegated to a
        :class:`SchedulingPolicy`;
      * preempted requests are supported end to end: :meth:`preempt` frees
        the victim's blocks back to the pool and requeues it at the front;
        :meth:`admit` re-admits it sized for prompt + already-generated
        tokens (the recompute re-prefill needs them all stored again);
      * with ``prefix_sharing`` a :class:`PrefixIndex` is consulted in
        :meth:`admit`: a waiting request whose prompt starts with full
        blocks already resident (another live request's identical prompt
        prefix) is mapped onto those physical blocks
        (``PagedKVCache.share_blocks``) and admission charges only the
        UNSHARED suffix against the free list — the same pool memory
        admits strictly more concurrent requests. The engine reads
        :meth:`shared_prefix_tokens` to slice the prompt before prefill
        (matched blocks are never recomputed);
      * with a :class:`ChunkedPrefillPolicy` (``chunk_tokens`` set),
        admission charges only the FIRST prefill chunk and the scheduler
        carries a per-request prefill cursor (:meth:`prefill_cursor`);
        the engine advances the oldest incomplete prefill by one chunk per
        iteration (:meth:`next_prefill` / :meth:`advance_prefill`) while
        the decode batch — everyone for whom :meth:`prefill_done` — keeps
        decoding. Prefix-index registration follows the WRITES, so a
        waiting request can never match a donor block whose KV is not in
        the pool yet.
    """

    kv: PagedKVCache
    max_batch: int
    policy: SchedulingPolicy = dataclasses.field(default_factory=FCFSPolicy)
    decode_headroom: int = 8
    prefix_sharing: bool = False

    def __post_init__(self):
        self.waiting: List[Request] = []
        self.running: List[Request] = []   # admission order (LIFO eviction)
        self.n_preemptions = 0
        self.prefix_index: Optional[PrefixIndex] = (
            PrefixIndex(self.kv.block_size) if self.prefix_sharing else None)
        self._shared: Dict[int, int] = {}  # rid -> shared prefix tokens
        # rid -> prefill cursor (tokens computed & written so far) for
        # requests admitted CHUNKED and still mid-prefill; absence means the
        # prefill is complete (or the request was admitted one-shot)
        self._prefill_cursor: Dict[int, int] = {}
        if self.chunk_tokens is not None and \
                self.chunk_tokens % self.kv.block_size:
            # EngineConfig validates this too; direct RequestScheduler
            # callers must fail at construction, not mid-run when a
            # misaligned cursor hits the block-aligned gather
            raise ValueError(
                f"prefill chunk_tokens ({self.chunk_tokens}) must be a "
                f"multiple of the KV block size ({self.kv.block_size})")

    @property
    def chunk_tokens(self) -> Optional[int]:
        """Per-iteration prefill token budget (None = one-shot prefill)."""
        return getattr(self.policy, "chunk_tokens", None)

    # ---- queue management ----
    def submit(self, reqs: Sequence[Request]) -> None:
        self.waiting.extend(reqs)

    def stored_tokens(self, req: Request) -> int:
        """Tokens that must be in the pool for `req` to decode: the prompt
        plus every generated token except the still-unstored last one."""
        return len(req.prompt) + max(len(req.output) - 1, 0)

    def shared_prefix_tokens(self, rid: int) -> int:
        """Block-aligned prompt tokens this running request shares with a
        donor (0 without prefix sharing). The engine's prefill/recompute
        slices these off the prompt — their KV is already in the pool."""
        return self._shared.get(rid, 0)

    def _match_prefix(self, req: Request, stored: int
                      ) -> Tuple[Optional[int], int]:
        """Deepest usable prefix match for `req`: capped one block short of
        `stored` tokens so at least one token is left to prefill (the last
        prompt token's logits seed sampling; a recompute needs a non-empty
        suffix too), and capped at the DONOR's allocated length — a chunked
        donor's table grows one chunk per iteration, so a recipient can
        only map onto blocks the donor already has (they are written by
        the time the recipient's own prefill reads them: chunk prefills
        run FCFS over admission order, and the same-wave canonical-fill
        invariant covers the donor's in-flight chunk)."""
        if self.prefix_index is None:
            return None, 0
        donor, matched = self.prefix_index.match(req.prompt)
        bs = self.kv.block_size
        matched = min(matched, ((stored - 1) // bs) * bs)
        if donor is not None:
            matched = min(matched,
                          (self.kv.lengths.get(donor, 0) // bs) * bs)
        if donor is None or matched <= 0:
            return None, 0
        return donor, matched

    def admit(self) -> List[Request]:
        """FCFS-prefix admission: move waiting requests to running while the
        pool can hold their stored tokens + decode headroom. The head of the
        queue blocks the tail (head-of-line blocking is the documented FCFS
        trade-off — a size-aware policy can override this hook). With prefix
        sharing, only the unshared suffix is charged against the pool."""
        admitted = []
        chunk = self.chunk_tokens
        while self.waiting and len(self.running) < self.max_batch:
            req = self.waiting[0]
            stored = self.stored_tokens(req)
            donor, shared = self._match_prefix(req, stored)
            if chunk:
                # chunked admission: charge only the FIRST chunk (plus
                # headroom) up front — later chunks allocate incrementally
                # as the prefill progresses. Guards against admissions
                # that could NEVER complete (they would deadlock
                # mid-prefill instead of surfacing SchedulingStalled):
                # the pool must hold this request outright, and admitting
                # it must leave every OLDER mid-prefill prompt completable
                # (only the oldest prefill progresses, so a younger
                # partial prompt's holdings are stuck until it finishes —
                # decoder holdings, by contrast, free as they retire).
                # capacity_blocks, not num_blocks: a fault-quarantined
                # shard's blocks are not coming back until rejoin
                if self.kv.blocks_needed(stored + self.decode_headroom) > \
                        self.kv.capacity_blocks:
                    break
                first = min(chunk, stored - shared)
                if not self._chunked_commitment_ok(donor, shared, first):
                    break
            else:
                first = stored - shared
            if not self.kv.can_allocate(first + self.decode_headroom):
                break
            self.waiting.pop(0)
            if shared:
                self.kv.share_blocks(donor, req.rid, shared)
            self.kv.allocate(req.rid, shared + first)
            self._shared[req.rid] = shared
            if chunk:
                self._prefill_cursor[req.rid] = shared
            if self.prefix_index is not None:
                # the full prompt is indexable immediately, even though a
                # CHUNKED donor's blocks fill over many iterations, because
                # an allocated block is always eventually written: matches
                # are capped at the donor's ALLOCATED length
                # (_match_prefix), the only reader of a borrowed prefix is
                # the recipient's own prefill (its first chunk / suffix
                # gather) which runs strictly AFTER the older donor's
                # chunks (next_prefill is FCFS over admission order), and a
                # mid-prefill request is never a preemption victim
                # anywhere (decode pool pressure selects only among
                # prefill-complete requests; chunk growth never preempts —
                # llm_engine._free_blocks_for_chunk), so the promise cannot
                # be revoked. One-shot admission keeps the same-wave
                # canonical-fill invariant (serving/kvcache.py).
                self.prefix_index.register(req.rid, req.prompt)
            req.state = State.RUNNING
            self.running.append(req)
            admitted.append(req)
        return admitted

    def admit_prefilled(self, req: Request) -> bool:
        """Transfer-complete admission (disaggregated cluster): `req`'s KV
        is ALREADY resident in this pool — its block table, refcounts, and
        stored length were rebuilt by ``PagedKVCache.prealloc_handoff`` and
        every block's bytes have landed — so admission skips allocation AND
        prefill entirely: the request joins the prebuilt decode batch with
        only batch-slot and bookkeeping work. The ``SchedulingPolicy``
        still governs it from here on (it is a normal ``running`` member
        for victim selection and retirement). Returns False when the batch
        is full this iteration — the caller's WaitingQueue holds the
        request (its blocks stay resident) and retries next step."""
        if len(self.running) >= self.max_batch:
            return False
        if req.rid not in self.kv.tables:
            raise ValueError(
                f"admit_prefilled: request {req.rid} has no imported block "
                f"table in this pool — the handoff transfer must complete "
                f"(prealloc + every block written) before admission")
        self._shared[req.rid] = 0
        if self.prefix_index is not None:
            # an imported request is as good a donor as a locally prefilled
            # one: its blocks are resident and its table covers the prompt
            self.prefix_index.register(req.rid, req.prompt)
        req.state = State.RUNNING
        self.running.append(req)
        return True

    def _chunked_commitment_ok(self, donor: Optional[int], shared: int,
                               first: int) -> bool:
        """Aggregate over-commitment guard for chunked admission: would
        admitting a new partial prompt still leave every OLDER mid-prefill
        request O able to complete? Chunk prefills run strictly FCFS, so
        the PHYSICAL blocks referenced by prefills younger than O (plus the
        new request's) are stuck until O finishes — each O needs its full
        allocation (stored + headroom) to fit in ``num_blocks`` minus
        those stuck holdings. Without this check, several long partial
        prompts admitted together deadlock into PoolExhausted on a pool
        that serves the same workload one-shot (serially) without trouble.

        Stuck blocks are counted as UNIQUE physical ids, excluding O's own
        table — a donor block prefix-shared by K mid-prefill sharers
        counts once, not K times, so co-admitting a common-prefix family
        keeps the capacity win sharing exists for. The new request's
        holdings are its donor's shared blocks (by id) plus
        ``blocks_needed(shared+first) − blocks_needed(shared)`` fresh
        ones (ids unknown until allocation — necessarily disjoint from
        everything live)."""
        mids = [r for r in self.running if r.rid in self._prefill_cursor]
        new_shared = (self.kv.tables[donor][:self.kv.blocks_needed(shared)]
                      if donor is not None else [])
        new_fresh = (self.kv.blocks_needed(shared + first) -
                     self.kv.blocks_needed(shared))
        for i, o in enumerate(mids):
            stuck = {b for y in mids[i + 1:] for b in self.kv.tables[y.rid]}
            stuck.update(new_shared)
            stuck.difference_update(self.kv.tables[o.rid])
            need_o = self.kv.blocks_needed(self.stored_tokens(o) +
                                           self.decode_headroom)
            if need_o + len(stuck) + new_fresh > self.kv.capacity_blocks:
                return False
        return True

    # ---- chunked-prefill cursor surface (ChunkedPrefillPolicy) ----
    def next_prefill(self) -> Optional[Request]:
        """Oldest running request whose chunked prefill is incomplete — the
        one the engine advances by one chunk this iteration (FCFS over the
        admission order; at most one chunk runs per iteration)."""
        for r in self.running:
            if r.rid in self._prefill_cursor:
                return r
        return None

    def prefill_cursor(self, rid: int) -> Optional[int]:
        """Tokens of `rid`'s prompt computed & written so far, or None when
        its prefill is complete (or it was admitted one-shot)."""
        return self._prefill_cursor.get(rid)

    def prefill_done(self, rid: int) -> bool:
        """True when `rid` may join the decode batch (no pending chunks)."""
        return rid not in self._prefill_cursor

    def advance_prefill(self, req: Request, cursor: int) -> None:
        """Record that `req`'s prefill has computed & written `cursor`
        tokens; reaching the stored-token target completes the prefill
        (the request joins the decode batch from the next iteration on)."""
        if cursor >= self.stored_tokens(req):
            self._prefill_cursor.pop(req.rid, None)
        else:
            self._prefill_cursor[req.rid] = cursor

    def _release(self, rid: int) -> None:
        """Drop a request's pool blocks (refcount-aware) and its prefix-
        index registrations — retire and preempt share this path. A block
        another live request still references survives (refcount > 0);
        evicting a sharer can therefore never corrupt its donor or
        recipients."""
        self.kv.free_seq(rid)
        self._shared.pop(rid, None)
        self._prefill_cursor.pop(rid, None)   # a preempted mid-prefill
        # request recomputes from scratch on re-admission (fresh cursor)
        if self.prefix_index is not None:
            self.prefix_index.unregister(rid)

    def preempt(self, req: Request) -> int:
        """Evict `req`: release its block refs (physical blocks return to
        the pool only when no other live request still references them) and
        requeue it at the FRONT of the waiting queue (preempted requests
        have priority). Returns the number of physical blocks freed."""
        free_before = sum(len(s) for s in self.kv._free_shard)
        self._release(req.rid)
        freed = sum(len(s) for s in self.kv._free_shard) - free_before
        self.running.remove(req)
        req.state = State.PREEMPTED
        self.waiting.insert(0, req)
        self.n_preemptions += 1
        return freed

    def retire_finished(self) -> List[Request]:
        done = [r for r in self.running if r.state == State.FINISHED]
        for r in done:
            self._release(r.rid)
        self.running = [r for r in self.running if r.state != State.FINISHED]
        return done

    def cancel_all(self) -> List[Request]:
        """Cleanly cancel every in-flight request (graceful shutdown):
        running requests release their pool blocks (refcount-aware, same
        path as retire/preempt), waiting requests are simply dequeued.
        Returns every cancelled request, running first — the caller marks
        states and emits events."""
        cancelled = list(self.running) + list(self.waiting)
        for r in self.running:
            self._release(r.rid)
        self.running = []
        self.waiting = []
        return cancelled

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
