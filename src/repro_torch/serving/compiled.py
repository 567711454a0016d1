"""The compiled engine programs: the decode step and the three prefill
programs captured as CUDA graphs keyed by shape and replayed. Port of the
reference's ``jax.jit``s (``repro/serving/llm_engine.py:218``, ``:219``,
``:240``, ``:252``).

A graph is keyed, as ``jit`` keys its programs, by the shapes of its
operands. :class:`CompiledDecodeStep` keys the decode step by the batch
``B`` exactly (padding it would change the rows the ``request`` partition
hands each worker, ``request_splits``) and the block-table width rounded
up to a bucket (:func:`width_bucket`: powers of two from 8, capped at the
pool's block count), so a growing sequence does not capture a new graph
every ``block_size`` tokens. Pad slots hold block 0 and are masked by
``cache_len``, as ``PagedKVCache.block_table_batch`` pads already; the
block partition's per-shard tables ``(n, B, nbl)`` are bucketed the same
way (cap: the blocks of one shard) with ``POS_PAD`` positions.

:class:`CompiledPrefill` holds the three prefill programs:

* the chunk step, keyed by (C bucket, nb): nb, the prefix's block count,
  stays exact because the chunk kernel derives P = nb·bs from it as a host
  scalar; it takes only shared/bs + k·chunk/bs, so the full chunks of
  later prompts reuse the graphs (the reference's argument,
  ``llm_engine.py:245``). Only a prompt's final, partial chunk is padded,
  to :func:`chunk_bucket`. Its keys are unbounded: nb grows with every
  chunk of a prompt (a 524,288-token prompt makes 1024 keys). A chunk
  with MAX_GRAPHS or more chunks of its prompt still to run, whose key
  has no graph, runs eagerly and is not captured: the prompt's own later
  keys, all new, push its graph out of the MAX_GRAPHS most recently used
  before the prompt ends, so only a prompt prefilled beside it could
  replay it. Every other key is captured and kept by least recent use,
  so a prompt of at most MAX_GRAPHS chunks runs as under plain LRU, and
  a longer one ends holding the graphs LRU would hold, without the
  captures LRU would drop unreplayed (960 of a 524,288-token prompt's
  1024, each about as long as the call). The eager call launches the
  same kernels;
* the one-shot prefill, keyed by :func:`prefill_bucket` of S; a moe
  model's runs eagerly and unpadded: pad rows would join its routing
  groups and change the experts' capacity (``models/moe.py``), and a
  graph per exact length pays off only where lengths recur, which the
  traces' log-normal prompt lengths rarely do;
* the suffix prefill, keyed by (P exact, suffix bucket), with the prefix
  gather (and int8 dequantization) inside the graph
  (``kvcache.gather_blocks``), as the reference fuses it.

Pad tokens (id 0) sit after the real ones: causal masking keeps them out
of every real row's attention, in the chunk kernel and in the blockwise
path alike; the real length is a device operand that picks the last real
row's logits (``transformer._last_rows``). The pool writes stay outside
the graphs (host block bookkeeping, copy-on-write, int8 quantization):
the engine writes the real rows of the static K/V outputs.

Per key, a program's integer operands live in one static device buffer,
filled outside the graph by ONE copy from a pinned host buffer. The
weights and the pools are bound at construction: the graphs read them by
address (``PagedKVCache`` writes its pools in place); the chunk kernel's
tensor maps, encoded from operand addresses, are baked in at capture, so
every buffer it reads keeps its address across replays. The first call of
a key runs the program eagerly on those buffers (the warm-up: library
handles, lazily loaded kernels; its result is that call's result and its
launches count as the program's), then captures it on a side stream;
later calls replay. Nothing falls back: a failed capture or replay raises.

Memory: every graph of an engine allocates from ONE shared pool. That is
safe because a call's outputs (views of the graph's static outputs) are
consumed before the next call of any program — the engine guards,
writes and samples them first — and replays run in order on one stream.
Outputs are valid until the next call.

Launch counters: the kernel wrappers count in Python, which a replay does
not run, so each graph records the launches counted while it was captured
(:class:`LaunchDeltas`) and every replay adds them. The split-KV decode
kernels' merge tickets of a captured graph are its own array, allocated
before the capture (``kernels._cuda.private_tickets``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import paged_prefill_attention as _ppa
from repro_torch.kernels import rwkv6_scan as _rwkv
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.models import transformer
from repro_torch.serving.kvcache import gather_blocks
from repro_torch.serving.trace import SpanRecorder

MIN_WIDTH_BUCKET = 8
MIN_PREFILL_BUCKET = 64
PREFILL_STRIDE = 512     # one-shot buckets: powers of two, then multiples
MAX_GRAPHS = 64          # least recently used graphs beyond this are freed
PAD_TOKEN = 0            # the token id of pad rows

# every kernel wrapper that counts its launches
COUNTED = (_pda.paged_decode_attention, _pda.paged_decode_attention_int8,
           _ppa.paged_prefill_chunk_attention,
           _ppa.paged_prefill_chunk_attention_int8, _da.decode_attention,
           _da.decode_attention_int8, _ssm.ssm_scan, _rwkv.rwkv6_scan)
# every launch counter a replay keeps: each wrapper's ``launches``, and the
# paged decode wrapper's count of the launches that took its tensor-core
# path
COUNTERS = tuple((fn, "launches") for fn in COUNTED) + \
    ((_pda.paged_decode_attention, "tc_launches"),)


def _pow2_at_least(n: int, floor: int) -> int:
    """The least power of two ≥ max(n, floor) (``floor`` a power of two)."""
    width = floor
    while width < n:
        width *= 2
    return width


def width_bucket(nb: int, cap: int) -> int:
    """The padded width of a table of ``nb`` slots: the least power of two
    ≥ max(nb, 8), but no wider than max(nb, cap) — ``cap`` is the most
    slots such a table can hold, so a bucket never exceeds it and never
    shrinks a table."""
    return min(_pow2_at_least(nb, MIN_WIDTH_BUCKET), max(nb, cap))


def chunk_bucket(C: int, cap: int) -> int:
    """The padded length of a prefill chunk of ``C`` tokens: the least
    power of two ≥ max(C, 64), but no longer than max(C, cap) — ``cap``
    is ``prefill_chunk_tokens``, so a full chunk is never padded."""
    return min(_pow2_at_least(C, MIN_PREFILL_BUCKET), max(C, cap))


def prefill_bucket(S: int) -> int:
    """The padded length of a one-shot prefill (or a suffix) of ``S``
    tokens: powers of two from 64 up to 512, then multiples of 512."""
    if S > PREFILL_STRIDE:
        return -(-S // PREFILL_STRIDE) * PREFILL_STRIDE
    return _pow2_at_least(S, MIN_PREFILL_BUCKET)


def pad_tokens(tokens: Sequence[int], n: int) -> np.ndarray:
    """``tokens`` as an int32 array padded with ``PAD_TOKEN`` to ``n``."""
    out = np.full((n,), PAD_TOKEN, np.int32)
    out[:len(tokens)] = tokens
    return out


def pad_width(a: np.ndarray, width: int, fill: int) -> np.ndarray:
    """``a`` (..., nb) padded with ``fill`` to (..., width)."""
    pad = width - a.shape[-1]
    if pad < 0:
        raise ValueError(f"width {width} < the table's {a.shape[-1]}")
    if not pad:
        return a
    return np.concatenate(
        [a, np.full(a.shape[:-1] + (pad,), fill, a.dtype)], axis=-1)


def pad_operands(tables: np.ndarray, extra: Sequence[np.ndarray],
                 table_cap: int, shard_cap: int
                 ) -> Tuple[np.ndarray, Tuple[np.ndarray, ...]]:
    """The step's tables at their bucket widths: block tables (B, nb) with
    block 0, and — the block partition's ``extra`` — shard tables
    (n, B, nbl) with block 0 and shard positions with ``POS_PAD``."""
    tables = pad_width(tables, width_bucket(tables.shape[-1], table_cap), 0)
    if extra:
        shard_tables, shard_pos = extra
        w = width_bucket(shard_tables.shape[-1], shard_cap)
        extra = (pad_width(shard_tables, w, 0),
                 pad_width(shard_pos, w, _pda.POS_PAD))
    return tables, tuple(extra)


class LaunchDeltas:
    """The launches one captured graph makes per replay, per launch counter
    (:data:`COUNTERS`): recorded from the counters while it is captured
    (and taken back out of them: a capture launches nothing), added by
    every replay."""

    def __init__(self):
        self.delta: Dict = {}

    @contextlib.contextmanager
    def record(self):
        before = {(fn, name): getattr(fn, name) for fn, name in COUNTERS}
        try:
            yield
        finally:
            self.delta = {key: getattr(*key) - n
                          for key, n in before.items() if getattr(*key) != n}
            for (fn, name), n in before.items():
                setattr(fn, name, n)

    def replay(self) -> None:
        for (fn, name), n in self.delta.items():
            setattr(fn, name, getattr(fn, name) + n)


@dataclasses.dataclass
class _Graph:
    graph: Optional[torch.cuda.CUDAGraph]
    host: torch.Tensor            # pinned int32 operands
    dev: torch.Tensor             # the static device copy the graph reads
    views: Tuple[torch.Tensor, ...]
    copied: Optional[torch.cuda.Event]   # the last host -> device copy
    launches: LaunchDeltas
    tickets: Optional[torch.Tensor] = None
    out: Tuple = ()


def cuda_device(device) -> torch.device:
    """``device`` as an indexed CUDA device; a CPU device raises (the CPU
    runs every program eagerly)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"a compiled program captures CUDA graphs; got "
                         f"device {device} (the CPU runs it eagerly)")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class GraphCache:
    """One program's CUDA graphs keyed by the shapes of its operands.

    ``run(key, operands, program)`` replays the graph of ``key`` after
    copying ``operands`` (int32 numpy arrays) into its static buffer, or,
    on the key's first call, runs ``program(*views)`` eagerly on the
    static device views of those operands and captures it. Returns what
    ``program`` returns (the static outputs of the graph after a replay).
    ``pool`` is the graph memory pool shared by every program of an
    engine; ``tickets`` > 0 gives the capture that many private merge
    tickets of the paged decode kernel. With ``capture`` False a key that
    has no graph runs ``program`` eagerly on device copies of its
    operands (counted in ``eager_calls``), neither captured nor evicting
    one; a key that has one replays."""

    eager_calls = 0               # calls run eagerly, not captured

    def __init__(self, device, pool=None):
        self.device = cuda_device(device)
        self._stream = torch.cuda.Stream(self.device)
        self._pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self._graphs: "collections.OrderedDict[Tuple, _Graph]" = \
            collections.OrderedDict()
        self.captures = 0             # graphs captured
        self.capture_s = 0.0          # host seconds spent capturing
        self.replays = 0
        self.reserved_bytes = 0       # device memory reserved by captures
        self.trace = SpanRecorder()   # the engine's, once it owns this

    @property
    def graphs(self) -> int:
        return len(self._graphs)

    def run(self, key: Tuple, operands: Sequence[np.ndarray], program,
            tickets: int = 0, capture: bool = True):
        entry = self._graphs.get(key)
        if entry is None and not capture:
            self.eager_calls += 1
            return program(*(torch.as_tensor(a, device=self.device)
                             for a in operands))
        if entry is None:
            entry = self._entry(operands)
            self._fill(entry, operands)
            # the warm-up: this call's program, eagerly on the static buffers
            result = program(*entry.views)
            self._capture(entry, program, tickets)
            self.captures += 1
            self._graphs[key] = entry
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
            return result
        self._graphs.move_to_end(key)
        self._fill(entry, operands)
        self._replay(entry)
        entry.launches.replay()
        self.replays += 1
        return entry.out

    def _buffers(self, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.empty(size, dtype=torch.int32, pin_memory=True),
                torch.empty(size, dtype=torch.int32, device=self.device))

    def _entry(self, operands: Sequence[np.ndarray]) -> _Graph:
        host, dev = self._buffers(sum(a.size for a in operands))
        views, off = [], 0
        for a in operands:
            views.append(dev[off:off + a.size].view(a.shape))
            off += a.size
        return _Graph(graph=None, host=host, dev=dev, views=tuple(views),
                      copied=None, launches=LaunchDeltas())

    def _fill(self, entry: _Graph, operands: Sequence[np.ndarray]) -> None:
        """The operands into the key's pinned buffer (once the previous
        copy out of it is done), then one copy to the device buffer."""
        if entry.copied is None:
            entry.copied = torch.cuda.Event()
        tr = self.trace
        if tr.on:
            tr.open("wait.fill")
        entry.copied.synchronize()
        if tr.on:
            tr.close()
        host = entry.host.numpy()
        off = 0
        for a in operands:
            host[off:off + a.size] = a.reshape(-1)
            off += a.size
        entry.dev.copy_(entry.host, non_blocking=True)
        entry.copied.record()

    def _capture(self, entry: _Graph, program, tickets: int) -> None:
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        entry.graph = torch.cuda.CUDAGraph()
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        own = _cuda.private_tickets(self.device, side.cuda_stream, tickets) \
            if tickets else contextlib.nullcontext()
        with torch.cuda.stream(side), own as ticket_array, \
                entry.launches.record():
            entry.graph.capture_begin(pool=self._pool)
            try:
                entry.out = program(*entry.views)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    entry.graph.capture_end()     # leave capture mode
                raise
            entry.graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(side)
        entry.tickets = ticket_array
        self.capture_s += time.perf_counter() - t0
        self.reserved_bytes += torch.cuda.memory_reserved(self.device) - \
            reserved

    def _replay(self, entry: _Graph) -> None:
        entry.graph.replay()


class CompiledDecodeStep(GraphCache):
    """``decode_fn`` (a placement's step) replayed from CUDA graphs.

    ``step(tokens, tables, lens, *extra)`` takes the step's host operands
    as the engine builds them (``tokens`` a list, ``tables`` (B, nb),
    ``lens`` (B,) and the placement's ``extra`` as int32 numpy arrays) and
    returns ``(logits, updates)`` like ``decode_fn``, as views of the
    graph's static outputs. Raises on a CPU device."""

    def __init__(self, decode_fn, params, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor], device,
                 n_shards: int = 1, pool=None):
        super().__init__(device, pool)
        self._fn = decode_fn
        self._params = params
        self._pools = (k_pool, v_pool)
        self._scales = {} if k_scale is None else dict(
            k_scale_pool=k_scale, v_scale_pool=v_scale)
        num_blocks = k_pool.shape[2]
        self._table_cap = num_blocks
        self._shard_cap = num_blocks // n_shards
        self._hkv = k_pool.shape[1]

    def __call__(self, tokens, tables: np.ndarray, lens: np.ndarray,
                 *extra: np.ndarray):
        tables, extra = pad_operands(tables, extra, self._table_cap,
                                     self._shard_cap)
        B = len(tokens)
        key = (B, tables.shape[1]) + tuple(e.shape for e in extra[:1])
        return self.run(key, (np.asarray(tokens, np.int32), lens, tables,
                              *extra), self._step, tickets=B * self._hkv)

    def _step(self, tokens, lens, tables, *extra):
        return self._fn(self._params, tokens, *self._pools, tables, lens,
                        *extra, **self._scales)


class CompiledPrefill:
    """The engine's three prefill programs replayed from CUDA graphs, one
    :class:`GraphCache` each (``chunk``, ``oneshot``, ``suffix``), in the
    engine's shared graph pool. Each call takes host token lists and pool
    block ids and returns ``(logits (1, vocab), k, v)`` with head-major
    K/V (L, Hkv, S_padded, hd) as views of the graph's static outputs;
    the caller writes their first ``len(tokens)`` rows. Raises on a CPU
    device."""

    graph_cache = GraphCache

    def __init__(self, cfg, params, kv, device, chunk_tokens: Optional[int],
                 pool=None):
        self.cfg = cfg
        self._params = params
        self._kv = kv
        self._chunk_cap = chunk_tokens or 0
        self.chunk = self.graph_cache(device, pool)
        self.oneshot = self.graph_cache(device, pool)
        self.suffix = self.graph_cache(device, pool)
        self.device = self.chunk.device

    def programs(self) -> Dict[str, GraphCache]:
        return {"chunk": self.chunk, "oneshot": self.oneshot,
                "suffix": self.suffix}

    def _scales(self) -> Dict:
        kv = self._kv
        return {} if kv.k_scale is None else dict(k_scale_pool=kv.k_scale,
                                                  v_scale_pool=kv.v_scale)

    def run_chunk(self, tokens: Sequence[int], blocks: Sequence[int],
                  remaining: int = 0):
        """One chunk of ``tokens`` over the prefix blocks ``blocks``, with
        ``remaining`` chunks of its prompt still to run after it (a new
        key is captured only when that is under MAX_GRAPHS)."""
        C = len(tokens)
        Cb = chunk_bucket(C, self._chunk_cap)
        ops = (pad_tokens(tokens, Cb), np.asarray(blocks, np.int32),
               np.asarray([C], np.int32))
        return self.chunk.run((Cb, len(blocks)), ops, self._chunk,
                              capture=remaining < MAX_GRAPHS)

    def run_oneshot(self, tokens: Sequence[int]):
        """The one-shot prefill of ``tokens`` (a moe model's eagerly, at
        its exact length)."""
        if self.cfg.family == "moe":
            return self._oneshot(torch.as_tensor(tokens, dtype=torch.int32,
                                                 device=self.device))
        Sb = prefill_bucket(len(tokens))
        ops = (pad_tokens(tokens, Sb), np.asarray([len(tokens)], np.int32))
        return self.oneshot.run((Sb,), ops, self._oneshot)

    def run_suffix(self, tokens: Sequence[int], blocks: Sequence[int]):
        """The suffix prefill of ``tokens`` after the prefix held in the
        pool blocks ``blocks``, gathered inside the graph."""
        Sb = prefill_bucket(len(tokens))
        ops = (pad_tokens(tokens, Sb), np.asarray(blocks, np.int32),
               np.asarray([len(tokens)], np.int32))
        return self.suffix.run((len(blocks), Sb), ops, self._suffix)

    # the programs, on the static views -------------------------------
    def _chunk(self, tokens, blocks, length):
        kv = self._kv
        logits, cache = transformer.prefill_chunk(
            self._params, self.cfg, {"tokens": tokens[None]}, kv.k_pool,
            kv.v_pool, blocks, device=self.device, length=length,
            **self._scales())
        return logits, cache["k"][:, 0], cache["v"][:, 0]

    def _oneshot(self, tokens, length=None):
        logits, cache = transformer.prefill(
            self._params, self.cfg, {"tokens": tokens[None]},
            max_seq=tokens.shape[0], device=self.device, length=length)
        return logits, cache["k"][:, 0], cache["v"][:, 0]

    def _suffix(self, tokens, blocks, length):
        kv = self._kv
        k_pre, v_pre = gather_blocks(kv.k_pool, kv.v_pool, kv.k_scale,
                                     kv.v_scale, blocks, self.cfg.dtype)
        logits, cache = transformer.prefill_suffix(
            self._params, self.cfg, {"tokens": tokens[None]},
            k_pre[:, None], v_pre[:, None], device=self.device,
            length=length)
        return logits, cache["k"][:, 0], cache["v"][:, 0]
