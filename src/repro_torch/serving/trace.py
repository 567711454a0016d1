"""Spans of the engine's host work, stamped on the profiler's clock.

The port's own: the reference's engine (``repro/serving/llm_engine.py``)
records its event log and ``EngineStats`` and no spans.

One :class:`SpanRecorder` per engine (``LLMEngine.trace``), shared with its
compiled programs (``GraphCache.trace``). It is off by default and costs a
span site one attribute test (``if trace.on:``) then: no clock read, no
allocation. ``trace.start()`` turns it on; ``trace.stop()`` turns it off
and returns the spans recorded since, in the order they were opened.

A span is a name from :data:`NAMES`, a start and an end in
``time.time_ns()`` nanoseconds (the clock ``torch.profiler`` stamps its
events on, and the one ``Request`` and ``EngineEvent`` times are read
from), the index of the span it sits in (-1 for a ``step`` root), the
engine step, the request it concerns (-1 for none) and two integers whose
meaning the name fixes (:data:`NAMES`). A step opens a fixed handful of
spans: none is opened per token, nor per request of the decode batch.

``wait.*`` spans are the host blocked on the card; ``step`` minus its
``wait.*`` spans is the host's own work. ``wait.sample`` covers the whole
of ``sample_per_request``: a batch with stochastic rows draws them on the
host inside it.

A step that raises leaves its open spans with ``end_ns`` 0; the next
``step`` root closes nothing and starts a fresh stack. Spans stay in
preallocated flat lists (grown by doubling) until :meth:`stop`.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple

# every span name, with what its two integers (a, b) hold
NAMES = {
    "step": "the whole iteration",
    "step.fault_tick": "fault bookkeeping",
    "step.handoff": "a decode engine's handoff queues",
    "handoff.prealloc": "faulted-transfer resets and preallocation",
    "handoff.transfer": "one handoff's blocks landed: a blocks, b bytes",
    "handoff.admit": "transferred requests into the batch",
    "step.admit": "the admission loop; nested, one prefill: a tokens",
    "step.chunk": "one prefill chunk: a start token, b tokens",
    "step.decode": "the decode iteration",
    "decode.prepare": "the batch, pool pressure, the host operands",
    "decode.run": "the step's program and its validation: a batch",
    "decode.commit": "append_token, write_tokens",
    "decode.sample": "guard, argmax, record_token",
    "decode.account": "the stats lines",
    "step.retire": "retirement",
    "wait.fill": "a graph's operand buffer still being copied",
    "wait.validate": "the decode output's finite check",
    "wait.sample": "the sampled logits' copies to the host",
}


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int
    step: int
    rid: int
    a: int
    b: int


class SpanRecorder:
    """The spans of one engine (module docstring)."""

    def __init__(self, capacity: int = 1 << 15):
        self.on = False
        self.step = 0
        self._capacity = capacity
        self._alloc(0)

    def _alloc(self, n: int) -> None:
        self._name: List = [None] * n
        self._t0 = [0] * n
        self._t1 = [0] * n
        self._parent = [0] * n
        self._step = [0] * n
        self._rid = [0] * n
        self._a = [0] * n
        self._b = [0] * n
        self._n = 0
        self._stack: List[int] = []

    def start(self) -> None:
        """Drop what was recorded and record from now on."""
        self._alloc(self._capacity)
        self.on = True

    def stop(self) -> List[Span]:
        """Stop recording; the spans since :meth:`start`."""
        self.on = False
        out = [Span(self._name[i], self._t0[i], self._t1[i],
                    self._parent[i], self._step[i], self._rid[i],
                    self._a[i], self._b[i]) for i in range(self._n)]
        self._alloc(0)
        return out

    def open_step(self, step: int) -> None:
        """Open the ``step`` root of engine step ``step``."""
        self._stack.clear()
        self.step = step
        self.open("step")

    def open(self, name: str, rid: int = -1, a: int = 0, b: int = 0,
             start_ns: int = 0) -> None:
        """Open ``name`` inside the innermost open span, from now or from
        ``start_ns`` (a ``time.time_ns()`` read earlier)."""
        i = self._n
        if i == len(self._t0):
            self._grow()
        self._name[i] = name
        self._t0[i] = start_ns or time.time_ns()
        self._parent[i] = self._stack[-1] if self._stack else -1
        self._step[i] = self.step
        self._rid[i] = rid
        self._a[i] = a
        self._b[i] = b
        self._n = i + 1
        self._stack.append(i)

    def close(self) -> None:
        """Close the innermost open span."""
        self._t1[self._stack.pop()] = time.time_ns()

    def _grow(self) -> None:
        n = max(len(self._t0), 1)
        for lst in (self._name, self._t0, self._t1, self._parent,
                    self._step, self._rid, self._a, self._b):
            lst.extend([0] * n)
