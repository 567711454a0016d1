"""LLMEngine — the streaming serving facade.
Port of ``repro/serving/llm_engine.py`` for the homogeneous and
attention-pool placements, over bf16 or int8 pools.

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
the int8 kernels. On the card the decode step replays from CUDA graphs
keyed by (B, table-width bucket) (``serving/compiled.py``, the port of
``jax.jit``); the CPU and the prefill paths run eagerly. A shared prompt
prefix is skipped by one-shot prefill too: only the suffix runs
(``transformer.prefill_suffix`` over ``PagedKVCache.gather_prefix``).

Sampling honours ``SamplingParams.seed``: token ``i`` of a request is drawn
from a generator seeded by (its seed, i) alone (``serving/sampler.py``).
Non-finite logits raise :class:`CorruptedLogitsError` instead of being
sampled. The fault-injection / shard-health machinery of the reference
arrives with ``serving/faults.py`` in a later slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Union

import torch

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig, resolve_device
from repro_torch.serving.compiled import CompiledDecodeStep
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.kvcache import PagedKVCache, PoolExhausted
from repro_torch.serving.placement import (PlacementStrategy,
                                           device_operands, make_placement)
from repro_torch.serving.request import Request, SamplingParams, State
from repro_torch.serving.sampler import request_generator, sample_per_request
from repro_torch.serving.scheduler import RequestScheduler, make_policy
from repro_torch.serving.stats import EngineStats


class SchedulingStalled(RuntimeError):
    """Nothing is running and the head of the waiting queue can never be
    admitted — the engine would spin forever. Raised instead."""


class CorruptedLogitsError(RuntimeError):
    """Decode/prefill produced non-finite logits — sampling from them would
    silently emit garbage tokens. Carries the affected request ids and the
    engine step."""

    def __init__(self, message: str, *, rids: Sequence[int] = (),
                 step: int = 0):
        super().__init__(message)
        self.rids = tuple(rids)
        self.step = step


@dataclasses.dataclass(frozen=True)
class EngineEvent:
    """One iteration-level lifecycle event (the ``events()`` stream)."""

    kind: str          # submit | admit | readmit | chunk | preempt | finish
    rid: int
    step: int          # engine step counter when the event fired
    info: Dict = dataclasses.field(default_factory=dict)


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
                 engine_config: Optional[EngineConfig] = None, *,
                 device="cuda", **overrides):
        """``params`` must live on ``device`` (default ``"cuda"``; a machine
        without a GPU raises unless ``device="cpu"``). ``overrides`` are
        EngineConfig fields for call-site convenience."""
        if cfg.family not in transformer.DENSE_FAMILIES:
            raise NotImplementedError(
                f"the port's engine serves {transformer.DENSE_FAMILIES} "
                f"models so far; got family={cfg.family}")
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
        self._chunk_tokens = econf.prefill_chunk_tokens
        self.policy = make_policy(econf.scheduler,
                                  prefill_chunk_tokens=self._chunk_tokens)
        self.sched = RequestScheduler(self.kv, econf.max_batch, self.policy,
                                      econf.decode_headroom,
                                      prefix_sharing=econf.prefix_sharing)
        self.stats = EngineStats()
        self.stats.kv_pool_bytes_resident = self.kv.pool_bytes_resident
        self._decode_fn = self.placement.decode_fn()
        # the port of jax.jit(decode_fn): on the card the step replays from
        # CUDA graphs keyed by shape; the CPU runs it eagerly
        self.compiled: Optional[CompiledDecodeStep] = None
        if self.device.type == "cuda":
            self.compiled = CompiledDecodeStep(
                self._decode_fn, params, self.kv.k_pool, self.kv.v_pool,
                self.kv.k_scale, self.kv.v_scale, self.device,
                n_shards=self.kv.n_shards)
        # suffix-only prefill is exact for every family the engine serves
        # (the reference recomputes MoE prompts, which the port lacks)
        self._skip_prefill_compute = cfg.family != "moe"
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
        self._events.append(EngineEvent(kind, rid, self._step_no, info))

    @property
    def pool(self):
        """The attention worker pool (None for homogeneous placement)."""
        return self.placement.pool

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
        the finished."""
        self._step_no += 1
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
            raise SchedulingStalled(
                f"request {head.rid} needs {blocks} "
                f"blocks ({need} tokens incl. headroom) but the pool "
                f"only has {self.kv.capacity_blocks} blocks "
                f"({self.kv.num_free} free) and nothing is running — "
                f"it can never be admitted; shrink the prompt or grow "
                f"num_blocks")
        self._prefill_chunk_iteration()
        self._decode_iteration()
        self._retire()

    def run(self, max_steps: int = 10_000) -> EngineStats:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.stats

    def has_work(self) -> bool:
        return self.sched.has_work()

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
        return len(cancelled)

    def _guard_finite(self, reqs: List[Request],
                      logits: torch.Tensor) -> None:
        """Refuse to sample from non-finite logits: name the offending
        requests and the engine step instead of emitting garbage tokens."""
        finite = torch.isfinite(logits).all(dim=-1).cpu()
        if bool(finite.all()):
            return
        bad = [r.rid for r, ok in zip(reqs, finite.tolist()) if not ok]
        raise CorruptedLogitsError(
            f"non-finite logits at engine step {self._step_no} for "
            f"request(s) {bad} — refusing to sample (check model numerics / "
            f"KV integrity)", rids=bad, step=self._step_no)

    # ------------------------------------------------------------------
    # prefill / recompute
    # ------------------------------------------------------------------
    def _prefill(self, req: Request) -> None:
        logits = self._prefill_known(req.rid, req.prompt)
        tok = self._sample([req], logits)
        req.record_token(int(tok[0]))

    def _recompute(self, req: Request) -> None:
        """Re-admission of a preempted request: rebuild its pool KV by
        re-prefilling prompt + generated tokens minus the still-unstored
        last one (the §5 recovery path). No token is sampled."""
        self._prefill_known(req.rid, req.prompt + req.output[:-1])

    def _prefill_known(self, rid: int, known: Sequence[int]) -> torch.Tensor:
        """One-shot prefill: compute and store pool KV for `known` tokens,
        honouring the prefix the scheduler mapped onto a donor's blocks at
        admission (reference ``llm_engine.py:591``); returns the last
        position's logits. With a shared prefix only the suffix runs
        through the model (``transformer.prefill_suffix`` over the prefix
        gathered from the pool) and only the suffix is written."""
        shared = self.sched.shared_prefix_tokens(rid)
        self.stats.blocks_shared += shared // self.kv.block_size
        if shared and self._skip_prefill_compute:
            k_pre, v_pre = self.kv.gather_prefix(rid, shared)
            logits, cache = transformer.prefill_suffix(
                self.params, self.cfg, {"tokens": [list(known[shared:])]},
                k_pre[:, None], v_pre[:, None], device=self.device)
            # suffix cache k/v are head-major (L, 1, Hkv, S - shared, hd)
            self.kv.write_prefill(rid, cache["k"][:, 0], cache["v"][:, 0],
                                  start_token=shared)
            self.stats.prefill_tokens_skipped += shared
            self.stats.max_prefill_slab_tokens = max(
                self.stats.max_prefill_slab_tokens, len(known) - shared)
            return logits
        self.stats.max_prefill_slab_tokens = max(
            self.stats.max_prefill_slab_tokens, len(known))
        logits, cache = transformer.prefill(
            self.params, self.cfg, {"tokens": [list(known)]},
            max_seq=len(known), device=self.device)
        # cache k/v are head-major (L, 1, Hkv, S, hd) — the pool's layout
        self.kv.write_prefill(rid, cache["k"][:, 0, :, shared:],
                              cache["v"][:, 0, :, shared:],
                              start_token=shared)
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
        idx = self.kv.gather_prefix_indices(rid, cursor)
        logits, cache = transformer.prefill_chunk(
            self.params, self.cfg, {"tokens": [list(known[cursor:target])]},
            self.kv.k_pool, self.kv.v_pool, idx, device=self.device,
            **self._scale_kwargs("k_scale_pool", "v_scale_pool"))
        # chunk cache k/v are head-major (L, 1, Hkv, C, hd)
        self.kv.write_prefill_chunk(rid, cache["k"][:, 0], cache["v"][:, 0],
                                    start_token=cursor)
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
            f"decoder left to retire: {fix}",
            rid=req.rid, live_tokens=sum(self.kv.lengths.values()),
            free_blocks=free)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _decode_iteration(self) -> None:
        running = [r for r in self.sched.running
                   if r.state == State.RUNNING
                   and self.sched.prefill_done(r.rid)]
        if not running:
            return
        running = self._resolve_pool_pressure(running)
        if not running:
            return
        ids = [r.rid for r in running]
        extra = self.placement.decode_extra_args(self.kv, ids)
        tables, lens = self.kv.block_table_batch(ids)
        tokens = [r.output[-1] for r in running]
        t0 = time.time()
        if self.compiled is not None:
            logits, updates = self.compiled(tokens, tables, lens, *extra)
        else:
            logits, updates = self._decode_fn(
                self.params, tokens, self.kv.k_pool, self.kv.v_pool, tables,
                lens, *device_operands(extra, self.device),
                **self._scale_kwargs("k_scale_pool", "v_scale_pool"))
        # validate before anything is committed (the host copy synchronises)
        self._guard_finite(running, logits)
        dt = time.time() - t0
        # placement is the memory pool's job: append the input token's K/V
        # (allocator bookkeeping per sequence, then ONE batched scatter)
        positions = [int(n) for n in lens]
        for r in running:
            self.kv.append_token(r.rid)
        self.kv.write_tokens(ids, updates["k_new"], updates["v_new"],
                             positions)
        toks = self._sample(running, logits)
        for i, r in enumerate(running):
            r.record_token(int(toks[i]))
        self.placement.log_step(len(running))
        self.stats.steps += 1
        self.stats.kv_pool_bytes_resident = self.kv.pool_bytes_resident
        self.stats.kv_bytes_read += (self.kv.unique_live_tokens(ids) *
                                     self.kv.bytes_per_live_token())
        self.stats.tokens_generated += len(running)
        self.stats.batch_sizes.append(len(running))
        self.stats.step_times.append(dt)

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
                    f"{self.policy.name!r} policy found no victim: {fix}",
                    rid=g.rid, live_tokens=sum(self.kv.lengths.values()),
                    free_blocks=free)
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
        return sample_per_request(logits, gens,
                                  [r.params.temperature for r in reqs],
                                  [r.params.top_k for r in reqs])

    def _request_generator(self, req: Request) -> torch.Generator:
        # token i of this request always draws from stream index i; a
        # request without its own seed falls back to the engine's
        seed = req.params.seed
        return request_generator(self.config.seed if seed is None else seed,
                                 len(req.output))
