"""LLMEngine — the streaming serving facade.
Port of ``repro/serving/llm_engine.py``: the homogeneous, attention-pool
and moe-offload placements, over bf16 or int8 pools, for the dense, vlm
and moe families.

The request lifecycle is streaming: :meth:`LLMEngine.submit` returns a
:class:`RequestHandle` per request whose iterator drives the engine and
yields token ids as they are generated; :meth:`LLMEngine.events` streams
lifecycle events (``submit`` / ``admit`` / ``readmit`` / ``chunk`` /
``preempt`` / ``finish``); :meth:`LLMEngine.run` drains everything.

Every iteration is MIXED: admission (one-shot prefill, recompute, or a
chunked admission that only seeds a prefill cursor), pool-pressure
resolution (preempting under the ``preempt`` policy), at most one prefill
chunk, then one decode token for every running request whose prefill is
complete. Chunked prefill runs the paged chunk-prefill kernel; decode runs
the paged decode kernel — both on the card when the pool lives there, their
plain twins when it lives on the CPU; an int8 pool hands its scale pools to
the int8 kernels. On the card every compiled program of the reference
(``jax.jit``) replays from CUDA graphs (``serving/compiled.py``): the
decode step keyed by (B, table-width bucket), the chunk step by (chunk
bucket, prefix blocks), the one-shot prefill by its length bucket and the
suffix prefill by (prefix blocks, suffix bucket); the CPU runs them all
eagerly on unpadded operands. A shared prompt prefix is skipped by
one-shot prefill too: only the suffix runs (``transformer.prefill_suffix``
over the prefix gathered from the pool).

A moe model routes its tokens in capacity-limited groups, so a chunk
boundary, a skipped prefix or pad rows would change which tokens its
experts drop. As in the reference, its prompts run one-shot (the
``prefill_chunk_tokens`` knob is accepted and runs no chunk) and a shared
prefix shares pool memory but is recomputed; on the card its one-shot
program is keyed by the exact prompt length (``serving/compiled.py``).

Sampling honours ``SamplingParams.seed``: token ``i`` of a request is drawn
from a generator seeded by (its seed, i) alone (``serving/sampler.py``).

Fault tolerance (``serving/faults.py``): a :class:`FaultInjector` supplies
deterministic shard faults at the host-side pool boundary; detection is a
per-shard ``healthy → suspect → dead`` machine fed by heartbeat probes and
NaN/inf validation of the decode step's output, with bounded
retry-with-backoff (a retry is a second replay of the same graph, so it is
bit-identical). A dead shard is quarantined, every request holding blocks
on it is evicted through the preemption path and re-admitted by
recompute onto the survivors (through the prefill programs above); a
rejoined shard restores capacity. Non-finite logits no injected fault
accounts for raise :class:`CorruptedLogitsError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

import torch

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig, resolve_device
from repro_torch.serving.compiled import CompiledDecodeStep, CompiledPrefill
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.faults import DEAD, FaultInjector, ShardHealthTracker
from repro_torch.serving.kvcache import PagedKVCache, PoolExhausted
from repro_torch.serving.placement import (PlacementStrategy,
                                           device_operands, make_placement)
from repro_torch.serving.request import Request, SamplingParams, State
from repro_torch.serving.sampler import request_generator, sample_per_request
from repro_torch.serving.scheduler import RequestScheduler, make_policy
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.trace import SpanRecorder


class SchedulingStalled(RuntimeError):
    """Nothing is running and the head of the waiting queue can never be
    admitted — the engine would spin forever. Raised instead."""


class CorruptedLogitsError(RuntimeError):
    """Decode/prefill produced non-finite logits that no injected fault
    accounts for — sampling from them would silently emit garbage tokens.
    Carries the affected request ids and the engine step."""

    def __init__(self, message: str, *, rids: Sequence[int] = (),
                 step: int = 0):
        super().__init__(message)
        self.rids = tuple(rids)
        self.step = step


@dataclasses.dataclass(frozen=True)
class EngineEvent:
    """One iteration-level lifecycle event (the ``events()`` stream)."""

    # submit | admit | readmit | chunk | preempt | finish, plus the fault
    # lifecycle: shard_suspect | retry | recover | shard_down | shard_up
    # (shard-level events carry rid=-1 and name the shard in info["shard"])
    kind: str
    rid: int
    step: int          # engine step counter when the event fired
    info: Dict = dataclasses.field(default_factory=dict)
    # time.time() when it fired; events compare by kind, rid, step, info
    t_s: float = dataclasses.field(default=0.0, compare=False)


class RequestHandle:
    """Streaming view of one submitted request: iterating yields token ids
    incrementally, driving the engine only as far as needed. Preemption
    keeps generated tokens, so every yielded token is final."""

    __slots__ = ("request", "_engine")

    def __init__(self, engine: "LLMEngine", request: Request):
        self._engine = engine
        self.request = request

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def finished(self) -> bool:
        return self.request.state == State.FINISHED

    @property
    def output(self) -> List[int]:
        return self.request.output

    def __iter__(self) -> Iterator[int]:
        sent = 0
        while True:
            out = self.request.output
            while sent < len(out):
                yield out[sent]
                sent += 1
            if self.request.state == State.FINISHED:
                return
            self._engine.step()

    def result(self) -> List[int]:
        """Drain the stream; returns the complete output token list."""
        for _ in self:
            pass
        return self.request.output

    def __repr__(self):
        return (f"RequestHandle(rid={self.rid}, "
                f"state={self.request.state.value}, "
                f"tokens={len(self.request.output)})")


class LLMEngine:
    """The serving facade: continuous batching over the paged KV pool."""

    def __init__(self, cfg: ModelConfig, params,
                 engine_config: Optional[EngineConfig] = None,
                 fault_injector: Optional[FaultInjector] = None, *,
                 device="cuda", **overrides):
        """``params`` must live on ``device`` (default ``"cuda"``; a machine
        without a GPU raises unless ``device="cpu"``). ``overrides`` are
        EngineConfig fields for call-site convenience.
        ``fault_injector`` attaches a deterministic fault scenario at the
        pool boundary; the health machine and the recovery paths are
        always live."""
        if cfg.family not in transformer.DENSE_FAMILIES:
            raise NotImplementedError(
                f"the port's engine serves the KV-cache families "
                f"{transformer.DENSE_FAMILIES}; got family={cfg.family}")
        econf = engine_config or EngineConfig()
        if overrides:
            econf = econf.replace(**overrides)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.config = econf
        self.params = params
        self.kv = PagedKVCache(cfg, econf.num_blocks, econf.block_size,
                               n_shards=econf.resolved_kv_shards,
                               kv_dtype=econf.kv_dtype, device=self.device)
        self.placement: PlacementStrategy = make_placement(cfg, econf,
                                                           self.device)
        # a chunk boundary changes MoE routing groups: moe prompts run
        # one-shot (the knob is accepted and has no effect)
        self._chunk_tokens = (econf.prefill_chunk_tokens
                              if cfg.family != "moe" else None)
        self.policy = make_policy(econf.scheduler,
                                  prefill_chunk_tokens=self._chunk_tokens)
        self.sched = RequestScheduler(self.kv, econf.max_batch, self.policy,
                                      econf.decode_headroom,
                                      prefix_sharing=econf.prefix_sharing)
        self.stats = EngineStats()
        self.stats.kv_pool_bytes_resident = self.kv.pool_bytes_resident
        # host spans of each step (serving/trace.py), off until started
        self.trace = SpanRecorder()
        self._decode_fn = self.placement.decode_fn()
        # the port of the reference's jax.jits: on the card the decode step
        # and the three prefill programs replay from CUDA graphs keyed by
        # shape, all in one graph memory pool; the CPU runs them eagerly
        self.compiled: Optional[CompiledDecodeStep] = None
        self.compiled_prefill: Optional[CompiledPrefill] = None
        if self.device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            self.compiled = CompiledDecodeStep(
                self._decode_fn, params, self.kv.k_pool, self.kv.v_pool,
                self.kv.k_scale, self.kv.v_scale, self.device,
                n_shards=self.kv.n_shards, pool=pool)
            self.compiled_prefill = CompiledPrefill(
                cfg, params, self.kv, self.device, self._chunk_tokens,
                pool=pool)
            for g in (self.compiled,
                      *self.compiled_prefill.programs().values()):
                g.trace = self.trace
        # prefill compute is skipped only where the suffix-only prefill
        # equals the full one: MoE capacity dispatch couples a routing
        # group's tokens, so a moe model shares pool memory but recomputes
        # the full prompt, writing only the unshared suffix
        self._skip_prefill_compute = cfg.family != "moe"
        # fault tolerance: the per-shard health machine (always live) plus
        # the optional injector; _recovering maps a shard-death victim to
        # the instant its shard was declared dead, closed out (into
        # stats.recovery_latencies) when it is decodable again
        self._fault = fault_injector
        self.health = ShardHealthTracker(self.kv.n_shards,
                                         econf.fault_retry_limit)
        self._backoff_s = econf.fault_retry_backoff_s
        self._recovering: Dict[int, float] = {}
        self._events: List[EngineEvent] = []
        self._step_no = 0

    # ------------------------------------------------------------------
    # submission / streaming surface
    # ------------------------------------------------------------------
    def submit(self, reqs: Union[Request, Sequence[Request]]
               ) -> Union[RequestHandle, List[RequestHandle]]:
        """Enqueue request(s); returns one streaming handle per request
        (a single handle for a single request)."""
        single = isinstance(reqs, Request)
        batch = [reqs] if single else list(reqs)
        handles = []
        for req in batch:
            self._emit("submit", req.rid)
            if not req.output and req.done():      # max_new_tokens == 0
                req.state = State.FINISHED
                req.finish_s = time.time()
                self._emit("finish", req.rid, tokens=0)
            else:
                self.sched.submit([req])
            handles.append(RequestHandle(self, req))
        return handles[0] if single else handles

    def generate(self, prompt: Sequence[int],
                 params: Optional[SamplingParams] = None) -> RequestHandle:
        """Convenience: wrap a raw prompt in a Request and submit it."""
        return self.submit(Request(prompt=list(prompt),
                                   params=params or SamplingParams()))

    def events(self) -> Iterator[EngineEvent]:
        """Stream lifecycle events, driving the engine while work remains."""
        i = 0
        while True:
            while i < len(self._events):
                yield self._events[i]
                i += 1
            if not self.sched.has_work():
                return
            self.step()

    @property
    def event_log(self) -> List[EngineEvent]:
        return list(self._events)

    def _emit(self, kind: str, rid: int, **info) -> None:
        self._events.append(EngineEvent(kind, rid, self._step_no, info,
                                        time.time()))

    @property
    def pool(self):
        """The attention worker pool (None for homogeneous placement)."""
        return self.placement.pool

    @property
    def expert_pool(self):
        """The expert worker pool (moe_offload placement only)."""
        return self.placement.expert_pool

    @property
    def transfer_log(self):
        return self.placement.transfer_log

    def _scale_kwargs(self, k_name: str, v_name: str) -> Dict:
        """The int8 pool's scale pools keyed by the callee's kwarg names;
        empty for bf16 pools (every path that reads the pool gets its
        scales)."""
        if self.kv.k_scale is None:
            return {}
        return {k_name: self.kv.k_scale, v_name: self.kv.v_scale}

    # ------------------------------------------------------------------
    # the iteration
    # ------------------------------------------------------------------
    def step(self) -> None:
        """One MIXED engine iteration: admit (one-shot prefill / recompute,
        or chunked admission that only seeds a prefill cursor), advance at
        most one prefill chunk, decode one token for every running request
        whose prefill is complete (resolving pool pressure first), retire
        the finished. Fault bookkeeping (rejoins, stragglers, heartbeat
        probes) runs first, so a shard death detected at the step boundary
        is recovered before this step's admission wave."""
        self._step_no += 1
        tr = self.trace
        if tr.on:
            tr.open_step(self._step_no)
            tr.open("step.fault_tick")
        self._fault_tick()
        if tr.on:
            tr.close()
        self._pre_admit_tick()
        if tr.on:
            tr.open("step.admit")
        while True:
            admitted = self.sched.admit()
            for req in admitted:
                if self.sched.prefill_cursor(req.rid) is not None:
                    shared = self.sched.shared_prefix_tokens(req.rid)
                    self.stats.blocks_shared += shared // self.kv.block_size
                    self.stats.prefill_tokens_skipped += shared
                    kind = "readmit" if req.output else "admit"
                    self._emit(kind, req.rid, prompt_len=len(req.prompt),
                               chunked=True)
                elif req.output:               # preempted earlier: recompute
                    self._recompute(req)
                    self._emit("readmit", req.rid,
                               recomputed_tokens=self.kv.lengths[req.rid])
                else:
                    self._emit("admit", req.rid, prompt_len=len(req.prompt))
                    self._prefill(req)
            self._retire()                     # EOS-at-prefill frees early
            if self.sched.running or not admitted:
                break
        if not self.sched.running and self.sched.waiting:
            head = self.sched.waiting[0]
            need = self.sched.stored_tokens(head) + self.sched.decode_headroom
            blocks = self.kv.blocks_needed(need)
            # degraded pool with a rejoin on the schedule: the head may fit
            # once the quarantined shard returns — idle this step instead
            waitable = (self.kv.quarantined_shards
                        and self._fault is not None
                        and self._fault.pending_rejoins(self._step_no)
                        and blocks <= self.kv.num_blocks)
            if not waitable and not self._stall_waiver():
                raise SchedulingStalled(
                    f"request {head.rid} needs {blocks} "
                    f"blocks ({need} tokens incl. headroom) but the pool "
                    f"only has {self.kv.capacity_blocks} blocks "
                    f"({self.kv.num_free} free) and nothing is running — "
                    f"it can never be admitted; shrink the prompt or grow "
                    f"num_blocks" + self.kv._degraded_note())
        if tr.on:
            tr.close()
        self._prefill_chunk_iteration()
        self._note_recoveries()
        if tr.on:
            tr.open("step.decode")
        self._decode_iteration()
        if tr.on:
            tr.close()
            tr.open("step.retire")
        self._retire()
        if tr.on:
            tr.close()
            tr.close()                         # the step

    def run(self, max_steps: int = 10_000) -> EngineStats:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.stats

    def has_work(self) -> bool:
        return self.sched.has_work()

    # ------------------------------------------------------------------
    # disaggregation hooks (the cluster engines override these)
    # ------------------------------------------------------------------
    def _pre_admit_tick(self) -> None:
        """Hook between fault bookkeeping and this step's admission wave
        (the reference's cluster engines drain handoff queues or evict
        retained donors here)."""

    def _stall_waiver(self) -> bool:
        """Hook: True suppresses this step's SchedulingStalled check."""
        return False

    def _retire(self) -> None:
        for req in self.sched.retire_finished():
            self.stats.observe_request(req)
            self._emit("finish", req.rid, tokens=len(req.output))

    def cancel_all(self) -> int:
        """Graceful shutdown: cancel every in-flight request (running AND
        waiting), freeing their pool blocks and marking each FINISHED.
        Partial outputs are kept. Returns the number cancelled."""
        cancelled = self.sched.cancel_all()
        now = time.time()
        for req in cancelled:
            req.state = State.FINISHED
            req.finish_s = now
            self.stats.observe_request(req)
            self._emit("finish", req.rid, tokens=len(req.output),
                       cancelled=True)
        self._recovering.clear()
        return len(cancelled)

    # ------------------------------------------------------------------
    # fault detection / recovery
    # ------------------------------------------------------------------
    def _fault_tick(self) -> None:
        """Per-step fault bookkeeping at the pool boundary: scheduled
        rejoins restore quarantined capacity, stragglers are observed
        (slow is suspect, not wrong), then every live shard is probed with
        bounded retry-with-backoff: a shard that answers within the retry
        budget recovers, one that does not is declared dead and its
        requests recovered (:meth:`_handle_shard_death`)."""
        if self._fault is None:
            return
        self._fault.begin_step(self._step_no)
        for s in self._fault.rejoins(self._step_no):
            if self.health.is_dead(s):
                self.kv.rejoin_shard(s)
                self.health.mark_up(s)
                self.stats.shard_rejoins += 1
                self._emit("shard_up", -1, shard=s,
                           capacity_blocks=self.kv.capacity_blocks)
        for s, delay in self._fault.straggles(self._step_no):
            if self.health.is_dead(s):
                continue
            self.stats.straggle_steps += 1
            if delay > 0:
                time.sleep(delay)
            self._emit("shard_suspect", -1, shard=s, cause="straggler",
                       delay_s=delay)
            self._emit("recover", -1, shard=s, cause="straggler")
        for s in range(self.kv.n_shards):
            if self.health.is_dead(s):
                continue
            attempt = 0
            suspected = False
            while not self._fault.probe(s, self._step_no):
                self.stats.fault_retries += 1
                if not suspected:
                    suspected = True
                    self._emit("shard_suspect", -1, shard=s,
                               cause="heartbeat")
                if self.health.strike(s) == DEAD:
                    self._handle_shard_death(s, cause="heartbeat")
                    break
                self._emit("retry", -1, shard=s, attempt=attempt + 1)
                self._backoff(attempt)
                attempt += 1
            else:
                if suspected:
                    self.health.clear(s)
                    self.stats.transient_faults_recovered += 1
                    self._emit("recover", -1, shard=s, cause="heartbeat",
                               retries=attempt)

    def _handle_shard_death(self, shard: int, cause: str) -> None:
        """Quarantine a dead shard and recover its requests: the allocator
        masks it out (capacity drops to the survivors), every request
        holding blocks there is evicted through the preemption path
        (generated tokens kept), and re-admission recomputes its KV onto
        the surviving shards. Eviction bypasses ``policy.select_victim``:
        shard death names its victims by block placement, so recovery
        works under ``fcfs`` too, and mid-prefill victims are allowed (their
        prefill cursor resets with the eviction)."""
        t0 = time.time()
        victims = set(self.kv.seqs_on_shard(shard))
        # quarantine BEFORE freeing: the dead shard's blocks must not be
        # handed back out to the re-admission wave
        self.kv.quarantine_shard(shard)
        self.stats.shard_failures += 1
        self._emit("shard_down", -1, shard=shard, cause=cause,
                   victims=sorted(victims),
                   live_shards=list(self.kv.live_shards),
                   capacity_blocks=self.kv.capacity_blocks)
        for r in list(self.sched.running):
            if r.rid in victims:
                freed = self.sched.preempt(r)
                self.stats.preemptions = self.sched.n_preemptions
                self._emit("preempt", r.rid, freed_blocks=freed,
                           generated_tokens=len(r.output),
                           cause="shard_down")
                self._recovering[r.rid] = t0

    def _note_recoveries(self) -> None:
        """Close out recovery-latency timers: a shard-death victim counts
        as recovered once it is decodable again (running, prefill
        complete) on the surviving shards."""
        if not self._recovering:
            return
        for r in self.sched.running:
            t0 = self._recovering.get(r.rid)
            if t0 is not None and self.sched.prefill_done(r.rid):
                lat = time.time() - t0
                del self._recovering[r.rid]
                self.stats.recovery_latencies.append(lat)
                self.stats.requests_recovered += 1
                self._emit("recover", r.rid, latency_s=lat,
                           cause="readmitted")

    def _backoff(self, attempt: int) -> None:
        if self._backoff_s > 0:
            time.sleep(self._backoff_s * (2 ** attempt))

    def _guard_finite(self, reqs: List[Request],
                      logits: torch.Tensor) -> None:
        """Refuse to sample from non-finite logits: name the offending
        requests and the engine step instead of emitting garbage tokens."""
        tr = self.trace
        if tr.on:
            tr.open("wait.sample")
        finite = torch.isfinite(logits).all(dim=-1).cpu()
        if tr.on:
            tr.close()
        if bool(finite.all()):
            return
        bad = [r.rid for r, ok in zip(reqs, finite.tolist()) if not ok]
        raise CorruptedLogitsError(
            f"non-finite logits at engine step {self._step_no} for "
            f"request(s) {bad} — refusing to sample; no injected fault "
            f"accounts for this (check model numerics / KV integrity)",
            rids=bad, step=self._step_no)

    # ------------------------------------------------------------------
    # prefill / recompute
    # ------------------------------------------------------------------
    def _prefill(self, req: Request) -> None:
        tr = self.trace
        if tr.on:
            tr.open("step.admit", req.rid, len(req.prompt))
        logits = self._prefill_known(req.rid, req.prompt)
        tok = self._sample([req], logits)
        req.record_token(int(tok[0]))
        if tr.on:
            tr.close()

    def _recompute(self, req: Request) -> None:
        """Re-admission of a preempted request: rebuild its pool KV by
        re-prefilling prompt + generated tokens minus the still-unstored
        last one (the §5 recovery path). No token is sampled."""
        known = req.prompt + req.output[:-1]
        tr = self.trace
        if tr.on:
            tr.open("step.admit", req.rid, len(known))
        self._prefill_known(req.rid, known)
        if tr.on:
            tr.close()

    def _prefill_known(self, rid: int, known: Sequence[int]) -> torch.Tensor:
        """One-shot prefill: compute and store pool KV for `known` tokens,
        honouring the prefix the scheduler mapped onto a donor's blocks at
        admission (reference ``llm_engine.py:591``); returns the last
        position's logits. With a shared prefix only the suffix runs
        through the model (``transformer.prefill_suffix`` over the prefix
        gathered from the pool) and only the suffix is written. On the card
        both run from the compiled prefill programs on padded operands;
        the real rows of their K/V are written."""
        shared = self.sched.shared_prefix_tokens(rid)
        self.stats.blocks_shared += shared // self.kv.block_size
        comp = self.compiled_prefill
        if shared and self._skip_prefill_compute:
            suffix = list(known[shared:])
            if comp is not None:
                blocks = self.kv.tables[rid][:shared // self.kv.block_size]
                logits, k, v = comp.run_suffix(suffix, blocks)
            else:
                k_pre, v_pre = self.kv.gather_prefix(rid, shared)
                logits, cache = transformer.prefill_suffix(
                    self.params, self.cfg, {"tokens": [suffix]},
                    k_pre[:, None], v_pre[:, None], device=self.device)
                # suffix cache k/v are head-major (L, 1, Hkv, S - shared, hd)
                k, v = cache["k"][:, 0], cache["v"][:, 0]
            self.kv.write_prefill(rid, k, v, start_token=shared,
                                  length=len(suffix))
            self.stats.prefill_tokens_skipped += shared
            self.stats.max_prefill_slab_tokens = max(
                self.stats.max_prefill_slab_tokens, len(suffix))
            return logits
        self.stats.max_prefill_slab_tokens = max(
            self.stats.max_prefill_slab_tokens, len(known))
        if comp is not None:
            logits, k, v = comp.run_oneshot(list(known))
        else:
            logits, cache = transformer.prefill(
                self.params, self.cfg, {"tokens": [list(known)]},
                max_seq=len(known), device=self.device)
            # cache k/v are head-major (L, 1, Hkv, S, hd) — the pool's layout
            k, v = cache["k"][:, 0], cache["v"][:, 0]
        self.kv.write_prefill(rid, k[:, :, shared:], v[:, :, shared:],
                              start_token=shared, length=len(known) - shared)
        return logits

    # ------------------------------------------------------------------
    # chunked prefill (mixed iterations)
    # ------------------------------------------------------------------
    def _prefill_chunk_iteration(self) -> None:
        """Advance the OLDEST incomplete prefill by one chunk while the
        decode batch keeps decoding. The chunk's queries attend over the
        already-written pool blocks (plus the in-chunk causal mask), its KV
        is written as it completes, and only the FINAL chunk samples the
        request's first token."""
        req = self.sched.next_prefill()
        if req is None:
            return
        tr = self.trace
        t0 = time.time_ns() if tr.on else 0
        rid = req.rid
        known = list(req.prompt) + req.output[:-1] if req.output \
            else req.prompt
        total = len(known)
        cursor = self.sched.prefill_cursor(rid)
        target = min(cursor + self._chunk_tokens, total)
        grow = self.kv.blocks_needed(target) - len(self.kv.tables[rid])
        # the FINAL chunk re-establishes the decode headroom one-shot
        # admission reserves up front
        headroom = 0
        if target >= total:
            headroom = (self.kv.blocks_needed(total +
                                              self.sched.decode_headroom) -
                        self.kv.blocks_needed(total))
        if grow + headroom > 0:
            # never starve the decode batch: reserve the blocks this
            # iteration's decodes are about to append first
            reserve = sum(self.kv.blocks_to_append(r.rid)
                          for r in self.sched.running
                          if r.state == State.RUNNING
                          and self.sched.prefill_done(r.rid))
            if not self._free_blocks_for_chunk(req,
                                               grow + headroom + reserve):
                return  # stall this iteration; decode continues
        if tr.on:
            tr.open("step.chunk", rid, cursor, target - cursor, start_ns=t0)
        chunk = list(known[cursor:target])
        if self.compiled_prefill is not None:
            blocks = self.kv.tables[rid][:cursor // self.kv.block_size]
            logits, k, v = self.compiled_prefill.run_chunk(
                chunk, blocks, -(-(total - target) // self._chunk_tokens))
        else:
            idx = self.kv.gather_prefix_indices(rid, cursor)
            logits, cache = transformer.prefill_chunk(
                self.params, self.cfg, {"tokens": [chunk]}, self.kv.k_pool,
                self.kv.v_pool, idx, device=self.device,
                **self._scale_kwargs("k_scale_pool", "v_scale_pool"))
            # chunk cache k/v are head-major (L, 1, Hkv, C, hd)
            k, v = cache["k"][:, 0], cache["v"][:, 0]
        self.kv.write_prefill_chunk(rid, k, v, start_token=cursor,
                                    length=len(chunk))
        self.stats.prefill_chunks_run += 1
        self.stats.max_prefill_slab_tokens = max(
            self.stats.max_prefill_slab_tokens, target - cursor)
        self.placement.log_prefill_chunk(target - cursor)
        self._emit("chunk", rid, start=cursor, tokens=target - cursor,
                   remaining=total - target)
        self.sched.advance_prefill(req, target)
        if target >= total and not req.output:
            tok = self._sample([req], logits)
            req.record_token(int(tok[0]))
        if tr.on:
            tr.close()

    def _free_blocks_for_chunk(self, req: Request, need: int) -> bool:
        """Check `need` blocks are free before a chunk allocation. Chunk
        growth NEVER preempts: while any decoder is still running the chunk
        STALLS this iteration (returns False) and the freed blocks arrive
        as decoders retire. Raises :class:`PoolExhausted` only when no
        running decoder is left to ever free a block."""
        if self.kv.num_free >= need:
            return True
        if any(r.state == State.RUNNING and r is not req
               and self.sched.prefill_done(r.rid)
               for r in self.sched.running):
            return False
        free = self.kv.num_free
        fix = ("raise num_blocks" if self.policy.preemptible
               else "use scheduler='preempt' or raise num_blocks")
        raise PoolExhausted(
            f"KV pool exhausted mid chunked prefill: request "
            f"{req.rid} needs {need} blocks for its next chunk and "
            f"{free} of {self.kv.capacity_blocks} are free "
            f"({sum(self.kv.lengths.values())} live tokens across "
            f"{len(self.kv.tables)} sequences) with no running "
            f"decoder left to retire: {fix}" + self.kv._degraded_note(),
            rid=req.rid, live_tokens=sum(self.kv.lengths.values()),
            free_blocks=free, **self.kv._degraded_kw())

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _decode_iteration(self) -> None:
        tr = self.trace
        if tr.on:
            tr.open("decode.prepare")
        batch = self._decode_batch()
        if tr.on:
            tr.close()
        if batch is None:
            return
        running, ids, tables, lens, extra = batch
        tokens = [r.output[-1] for r in running]
        t0 = time.time()
        if tr.on:
            tr.open("decode.run", a=len(running))
        out = self._decode_validated(running, tokens, tables, lens, extra)
        if tr.on:
            tr.close()
        if out is None:
            # a shard died mid-decode: this iteration is aborted with
            # NOTHING committed (no append, no pool write, no sample); its
            # victims were evicted, survivors decode next step
            return
        logits, updates = out
        dt = time.time() - t0
        if tr.on:
            tr.open("decode.commit")
        # placement is the memory pool's job: append the input token's K/V
        # (allocator bookkeeping per sequence, then ONE batched scatter)
        positions = [int(n) for n in lens]
        for r in running:
            self.kv.append_token(r.rid)
        self.kv.write_tokens(ids, updates["k_new"], updates["v_new"],
                             positions)
        if tr.on:
            tr.close()
            tr.open("decode.sample")
        toks = self._sample(running, logits)
        for i, r in enumerate(running):
            r.record_token(int(toks[i]))
        if tr.on:
            tr.close()
            tr.open("decode.account")
        self.placement.log_step(len(running))
        self.stats.steps += 1
        self.stats.kv_pool_bytes_resident = self.kv.pool_bytes_resident
        self.stats.kv_bytes_read += (self.kv.unique_live_tokens(ids) *
                                     self.kv.bytes_per_live_token())
        self.stats.tokens_generated += len(running)
        self.stats.batch_sizes.append(len(running))
        self.stats.step_times.append(dt)
        if tr.on:
            tr.close()

    def _decode_batch(self):
        """This step's decode batch, pool pressure resolved, and its host
        operands: ``(running, ids, tables, lens, extra)``; ``None`` when
        nothing decodes."""
        running = [r for r in self.sched.running
                   if r.state == State.RUNNING
                   and self.sched.prefill_done(r.rid)]
        if running:
            running = self._resolve_pool_pressure(running)
        if not running:
            return None
        ids = [r.rid for r in running]
        extra = self.placement.decode_extra_args(self.kv, ids)
        tables, lens = self.kv.block_table_batch(ids)
        return running, ids, tables, lens, extra

    def _decode_validated(self, running: List[Request], tokens, tables,
                          lens, extra):
        """Run the decode step (a graph replay on the card) and VALIDATE
        its output before anything is committed. Injected corruption — NaN
        partials from a pool shard — strikes the shard and retries: the
        step is deterministic and a retry replays the same graph on the
        same operands, so a retry that succeeds is bit-identical to an
        unfaulted step. Strikes past the retry budget declare the shard
        dead (returns ``None``; the victims were evicted). Non-finite
        logits no fault accounts for raise :class:`CorruptedLogitsError`
        (the finite check synchronises)."""
        attempt = 0
        suspect = None
        while True:
            if self.compiled is not None:
                logits, updates = self.compiled(tokens, tables, lens, *extra)
            else:
                logits, updates = self._decode_fn(
                    self.params, tokens, self.kv.k_pool, self.kv.v_pool,
                    tables, lens, *device_operands(extra, self.device),
                    **self._scale_kwargs("k_scale_pool", "v_scale_pool"))
            shard = None
            if self._fault is not None:
                logits, shard = self._fault.filter_decode(self._step_no,
                                                          logits)
            tr = self.trace
            if tr.on:
                tr.open("wait.validate")
            finite = bool(torch.isfinite(logits).all())
            if tr.on:
                tr.close()
            if finite:
                if suspect is not None:
                    self.health.clear(suspect)
                    self.stats.transient_faults_recovered += 1
                    self._emit("recover", -1, shard=suspect,
                               cause="corrupt_partial", retries=attempt)
                return logits, updates
            if shard is None:
                # non-finite output with no injected fault to blame
                self._guard_finite(running, logits)
            if suspect is None:
                suspect = shard
                self._emit("shard_suspect", -1, shard=shard,
                           cause="corrupt_partial")
            self.stats.fault_retries += 1
            if self.health.strike(shard) == DEAD:
                self._handle_shard_death(shard, cause="corrupt_partial")
                return None
            self._emit("retry", -1, shard=shard, attempt=attempt + 1)
            self._backoff(attempt)
            attempt += 1

    def _resolve_pool_pressure(self, running: List[Request]
                               ) -> List[Request]:
        """Ensure every running sequence can store one more token; when the
        pool can't cover the growers, the policy evicts victims (blocks
        freed, re-admission via recompute) or — non-preemptible — the
        engine raises PoolExhausted up front."""
        while True:
            growers = [r for r in running
                       if self.kv.blocks_to_append(r.rid) > 0]
            free = self.kv.num_free
            if len(growers) <= free:
                return running
            victim = self.policy.select_victim(running)
            if victim is None:
                g = growers[0]
                fix = ("a sole running request has no viable victim — "
                       "raise num_blocks" if self.policy.preemptible
                       else "use scheduler='preempt' or raise num_blocks")
                raise PoolExhausted(
                    f"KV pool exhausted: request {g.rid} "
                    f"({self.kv.lengths[g.rid]} stored tokens) needs a "
                    f"block and {free} of {self.kv.capacity_blocks} are "
                    f"free ({sum(self.kv.lengths.values())} live tokens "
                    f"across {len(self.kv.tables)} sequences); the "
                    f"{self.policy.name!r} policy found no victim: {fix}"
                    + self.kv._degraded_note(),
                    rid=g.rid, live_tokens=sum(self.kv.lengths.values()),
                    free_blocks=free, **self.kv._degraded_kw())
            freed = self.sched.preempt(victim)
            self.stats.preemptions = self.sched.n_preemptions
            self._emit("preempt", victim.rid, freed_blocks=freed,
                       generated_tokens=len(victim.output))
            running = [r for r in running if r is not victim]

    # ------------------------------------------------------------------
    # sampling (per-request streams — SamplingParams.seed honoured)
    # ------------------------------------------------------------------
    def _sample(self, reqs: List[Request],
                logits: torch.Tensor) -> torch.Tensor:
        self._guard_finite(reqs, logits)
        gens = [self._request_generator(r) if r.params.temperature > 0
                else None for r in reqs]
        tr = self.trace
        if tr.on:
            tr.open("wait.sample")
        toks = sample_per_request(logits, gens,
                                  [r.params.temperature for r in reqs],
                                  [r.params.top_k for r in reqs])
        if tr.on:
            tr.close()
        return toks

    def _request_generator(self, req: Request) -> torch.Generator:
        # token i of this request always draws from stream index i; a
        # request without its own seed falls back to the engine's
        seed = req.params.seed
        return request_generator(self.config.seed if seed is None else seed,
                                 len(req.output))
