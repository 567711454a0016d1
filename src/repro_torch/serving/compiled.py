"""The compiled decode step: the engine's decode step captured as CUDA
graphs keyed by shape and replayed. Port of the reference's
``jax.jit(self.placement.decode_fn())``
(``repro/serving/llm_engine.py:218``).

A graph is keyed, as ``jit`` keys its programs, by the shapes of the
step's operands: the batch ``B`` exactly (padding it would change the rows
the ``request`` partition hands each worker, ``request_splits``) and the
block-table width rounded up to a bucket (:func:`width_bucket`: powers of
two from 8, capped at the pool's block count), so a growing sequence does
not capture a new graph every ``block_size`` tokens. Pad slots hold block
0 and are masked by ``cache_len``, as ``PagedKVCache.block_table_batch``
pads already; the block partition's per-shard tables ``(n, B, nbl)`` are
bucketed the same way (cap: the blocks of one shard) with ``POS_PAD``
positions.

Per key, the step's integer operands (tokens, lengths, tables and, for the
block partition, shard tables and positions) live in one static device
buffer, filled outside the graph by ONE copy from a pinned host buffer.
The weights and the pools are bound at construction: the graphs read them
by address (``PagedKVCache`` writes its pools in place). The first call of
a key runs the step eagerly on those buffers (the warm-up: library
handles, lazily loaded kernels; its result is that call's result and its
launches count as the step's), then captures it on a side stream; later
calls replay. Nothing falls back: a failed capture or replay raises.

Memory: every graph allocates from ONE shared pool. That is safe because
a call's outputs (views of the graph's static outputs) are consumed before
the next call — the engine guards, scatters and samples them first — and
replays run in order on one stream. Outputs are valid until the next call.

Launch counters: the kernel wrappers count in Python, which a replay does
not run, so each graph records the launches counted while it was captured
(:class:`LaunchDeltas`) and every replay adds them. The paged decode
kernel's merge tickets of a captured graph are its own array, allocated
before the capture (``paged_decode_attention.private_tickets``).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import paged_prefill_attention as _ppa
from repro_torch.kernels import rwkv6_scan as _rwkv
from repro_torch.kernels import ssm_scan as _ssm

MIN_WIDTH_BUCKET = 8
MAX_GRAPHS = 64          # least recently used graphs beyond this are freed

# every kernel wrapper that counts its launches
COUNTED = (_pda.paged_decode_attention, _pda.paged_decode_attention_int8,
           _ppa.paged_prefill_chunk_attention,
           _ppa.paged_prefill_chunk_attention_int8, _da.decode_attention,
           _ssm.ssm_scan, _rwkv.rwkv6_scan)


def width_bucket(nb: int, cap: int) -> int:
    """The padded width of a table of ``nb`` slots: the least power of two
    ≥ max(nb, 8), but no wider than max(nb, cap) — ``cap`` is the most
    slots such a table can hold, so a bucket never exceeds it and never
    shrinks a table."""
    width = MIN_WIDTH_BUCKET
    while width < nb:
        width *= 2
    return min(width, max(nb, cap))


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
    """The launches one captured graph makes per replay, per counted
    wrapper: recorded from the counters while it is captured (and taken
    back out of them: a capture launches nothing), added by every
    replay."""

    def __init__(self):
        self.delta: Dict = {}

    @contextlib.contextmanager
    def record(self):
        before = {fn: fn.launches for fn in COUNTED}
        try:
            yield
        finally:
            self.delta = {fn: fn.launches - n for fn, n in before.items()
                          if fn.launches != n}
            for fn, n in before.items():
                fn.launches = n

    def replay(self) -> None:
        for fn, n in self.delta.items():
            fn.launches += n


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    host: torch.Tensor            # pinned int32 operands
    dev: torch.Tensor             # the static device copy the graph reads
    views: Tuple[torch.Tensor, ...]
    copied: torch.cuda.Event      # the last host -> device copy
    launches: LaunchDeltas
    tickets: Optional[torch.Tensor]
    out: Tuple


class CompiledDecodeStep:
    """``decode_fn`` (a placement's step) replayed from CUDA graphs.

    ``step(tokens, tables, lens, *extra)`` takes the step's host operands
    as the engine builds them (``tokens`` a list, ``tables`` (B, nb),
    ``lens`` (B,) and the placement's ``extra`` as int32 numpy arrays) and
    returns ``(logits, updates)`` like ``decode_fn``, as views of the
    graph's static outputs. Raises on a CPU device."""

    def __init__(self, decode_fn, params, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor], device,
                 n_shards: int = 1):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a compiled decode step captures CUDA graphs; "
                             f"got device {device} (the CPU runs the step "
                             f"eagerly)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self._fn = decode_fn
        self._params = params
        self._pools = (k_pool, v_pool)
        self._scales = {} if k_scale is None else dict(
            k_scale_pool=k_scale, v_scale_pool=v_scale)
        num_blocks = k_pool.shape[2]
        self._table_cap = num_blocks
        self._shard_cap = num_blocks // n_shards
        self._hkv = k_pool.shape[1]
        self._stream = torch.cuda.Stream(device)
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: "collections.OrderedDict[Tuple, _Graph]" = \
            collections.OrderedDict()
        self.captures = 0             # graphs captured
        self.capture_s = 0.0          # host seconds spent capturing
        self.replays = 0
        self.reserved_bytes = 0       # device memory reserved by captures

    @property
    def graphs(self) -> int:
        return len(self._graphs)

    def __call__(self, tokens, tables: np.ndarray, lens: np.ndarray,
                 *extra: np.ndarray):
        tables, extra = pad_operands(tables, extra, self._table_cap,
                                     self._shard_cap)
        key = (len(tokens), tables.shape[1]) + tuple(
            e.shape for e in extra[:1])
        entry = self._graphs.get(key)
        if entry is None:
            return self._capture(key, tokens, tables, lens, extra)
        self._graphs.move_to_end(key)
        self._fill(entry, tokens, tables, lens, extra)
        entry.graph.replay()
        entry.launches.replay()
        self.replays += 1
        return entry.out

    def _run(self, views):
        tokens, lens, tables, *extra = views
        return self._fn(self._params, tokens, *self._pools, tables, lens,
                        *extra, **self._scales)

    def _fill(self, entry: _Graph, tokens, tables, lens, extra) -> None:
        """The operands into the key's pinned buffer (once the previous
        copy out of it is done), then one copy to the device buffer."""
        entry.copied.synchronize()
        host = entry.host.numpy()
        off = 0
        for a in (np.asarray(tokens, np.int32), lens, tables, *extra):
            host[off:off + a.size] = a.reshape(-1)
            off += a.size
        entry.dev.copy_(entry.host, non_blocking=True)
        entry.copied.record()

    def _capture(self, key, tokens, tables, lens, extra):
        B = len(tokens)
        shapes = [(B,), (B,), tables.shape, *(e.shape for e in extra)]
        size = sum(int(np.prod(s)) for s in shapes)
        host = torch.empty(size, dtype=torch.int32, pin_memory=True)
        dev = torch.empty(size, dtype=torch.int32, device=self.device)
        views, off = [], 0
        for s in shapes:
            n = int(np.prod(s))
            views.append(dev[off:off + n].view(s))
            off += n
        entry = _Graph(graph=torch.cuda.CUDAGraph(), host=host, dev=dev,
                       views=tuple(views), copied=torch.cuda.Event(),
                       launches=LaunchDeltas(), tickets=None, out=())
        self._fill(entry, tokens, tables, lens, extra)
        # the warm-up: this call's step, eagerly on the static buffers
        result = self._run(entry.views)
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), _pda.private_tickets(
                self.device, side.cuda_stream, B * self._hkv) as tickets, \
                entry.launches.record():
            entry.graph.capture_begin(pool=self._pool)
            try:
                entry.out = self._run(entry.views)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    entry.graph.capture_end()     # leave capture mode
                raise
            entry.graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(side)
        entry.tickets = tickets
        self.capture_s += time.perf_counter() - t0
        self.reserved_bytes += torch.cuda.memory_reserved(self.device) - \
            reserved
        self.captures += 1
        self._graphs[key] = entry
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return result
