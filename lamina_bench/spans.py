"""The program's host spans (``repro_torch/serving/trace.py``) beside the
device trace.

:func:`window` runs one window of the benchmark's loop (``Driver.window``) with the span
recorder of its engine on and attaches the spans (``Window.spans``) and the queue wait
of every admission in it (``Window.queue_waits_s``: the ``admit`` event's
time less the request's arrival). Under the benchmark's profiler, the
traced slice's ``span_profile`` is :func:`summarize` of the profiler
against the slice's spans. A run that never calls :func:`window` records
no span: the recorder is off unless started.

The spans and the kineto events share a clock (Unix-epoch nanoseconds), so
a device-idle gap is put down to the innermost span open at its midpoint,
and a device operation to the span its launching CUDA call sat in (by the
correlation id kineto gives a CUDA call and the work it launched).
"""
from __future__ import annotations

import bisect
import collections
import statistics
from typing import Dict, List, Optional

from lamina_bench.profile import PROFILER_HOST, PROFILER_OWN, SHORT_GAP_US

OUTSIDE = "outside step"
# the CUDA calls that replay a graph: the clock check reads their kernels
# (CUPTI places a small pinned copy up to 0.6 ms before the call that
# issued it on the H100, so copies are not held to the spans' times)
GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


def window(drv, seconds: float, profiler=None):
    """``drv.window`` with the engine's recorder on (module docstring)."""
    eng = drv.eng
    n_events = len(eng.event_log)
    eng.trace.start()
    try:
        w = drv.window(seconds, profiler)
    finally:
        w_spans = eng.trace.stop()
    w.spans = w_spans
    w.queue_waits_s = [
        ev.t_s - drv.by_rid[ev.rid].req.arrival_s
        for ev in eng.event_log[n_events:]
        if ev.kind == "admit" and ev.rid in drv.by_rid
        and w.t_open <= ev.t_s <= w.t_close]
    return w


# ---------------------------------------------------------------------
# the spans alone
def step_splits(spans) -> List[Dict]:
    """One dict a ``step`` root: its ``ns``, the ``wait_ns`` of its
    ``wait.*`` spans, the ``children_ns`` of its direct children, ``ns``
    by span name (``by_name``), and ``decode_ns``: ``step.decode`` less
    the waits inside it, None where no ``decode.run`` ran."""
    out: List[Dict] = []
    root_of: Dict[int, Dict] = {}
    in_decode = set()               # spans inside a step.decode
    for i, s in enumerate(spans):
        ns = s.end_ns - s.start_ns if s.end_ns else 0
        if s.parent == -1:
            cur = {"step": s.step, "ns": ns, "wait_ns": 0, "children_ns": 0,
                   "by_name": collections.defaultdict(int),
                   "decode_ns": None}
            out.append(cur)
            root_of[i] = cur
            continue
        cur = root_of[s.parent]
        root_of[i] = cur
        cur["by_name"][s.name] += ns
        if spans[s.parent].parent == -1:
            cur["children_ns"] += ns
        if s.name == "step.decode" or s.parent in in_decode:
            in_decode.add(i)
        if s.name == "decode.run":
            cur["decode_ns"] = cur["by_name"]["step.decode"]
        if s.name.startswith("wait."):
            cur["wait_ns"] += ns
            if i in in_decode:
                cur["decode_ns"] -= ns
    return out


def host_busy_ms(spans) -> List[float]:
    """Each step's host work in ms: ``step`` less its ``wait.*`` spans."""
    return [(s["ns"] - s["wait_ns"]) / 1e6 for s in step_splits(spans)]


def coverage(spans) -> Optional[float]:
    """The median over steps of the share of ``step`` its direct children
    cover."""
    shares = [s["children_ns"] / s["ns"] for s in step_splits(spans)
              if s["ns"] > 0]
    return statistics.median(shares) if shares else None


# ---------------------------------------------------------------------
# the spans against the device trace
def _kineto(prof):
    """(device, calls) of a stopped profiler: device operations and the
    host's CUDA calls as (start_ns, end_ns, correlation id, name), each
    sorted by start. Annotations and the profiler's own activities are
    left out, as ``profile._events`` leaves them out."""
    from torch.autograd import DeviceType
    dev, calls = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or end <= start or \
                    any(m in name for m in PROFILER_OWN):
                continue
            dev.append((start, end, e.correlation_id(), name))
        elif e.device_type() == DeviceType.CPU and \
                not any(m in name for m in PROFILER_HOST):
            calls.append((start, end, e.correlation_id(), name))
    dev.sort()
    calls.sort()
    return dev, calls


def _gaps(dev, least_ns: float) -> List[tuple]:
    """The merged idle gaps of ``least_ns`` or more between the first and
    the last device operation."""
    gaps, end = [], None
    for s, e, _, _ in dev:
        if end is not None and s - end >= least_ns:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


class _SpanIndex:
    """The innermost span open at a time, and the step roots' intervals."""

    def __init__(self, spans):
        self.spans = spans
        self.roots = [i for i, s in enumerate(spans) if s.parent == -1]
        self.root_starts = [spans[i].start_ns for i in self.roots]

    def innermost(self, t: int) -> Optional[int]:
        k = bisect.bisect_right(self.root_starts, t) - 1
        if k < 0:
            return None
        lo = self.roots[k]
        hi = self.roots[k + 1] if k + 1 < len(self.roots) else \
            len(self.spans)
        if not self.spans[lo].start_ns <= t <= self.spans[lo].end_ns:
            return None
        # spans nest and are kept in the order opened: the last one opened
        # that is still open at t is the innermost
        best = lo
        for i in range(lo + 1, hi):
            s = self.spans[i]
            if s.start_ns > t:
                break
            if t <= s.end_ns:
                best = i
        return best

    def outside_ns(self, a: int, b: int) -> int:
        """Nanoseconds of [a, b] during which no ``step`` span is open."""
        k = max(bisect.bisect_right(self.root_starts, a) - 1, 0)
        covered = 0
        for i in self.roots[k:]:
            s = self.spans[i]
            if s.start_ns >= b:
                break
            covered += max(0, min(b, s.end_ns) - max(a, s.start_ns))
        return (b - a) - covered


def summarize(prof, spans) -> Dict:
    """What the spans say of a stopped profiler's slice: the idle seconds
    by the innermost span open at each gap's midpoint (``idle_by_span``,
    top 10, ``outside step`` where no step ran), the idle seconds in all
    and outside every step, the host's seconds inside CUDA calls by the
    span they sat in (``call_s_by_span``, top 10), the device seconds of
    the work launched from
    ``handoff.transfer`` spans, and the clock check of each decode step
    (its graph's first kernel after ``decode.run`` opens, its last before
    ``wait.validate`` closes)."""
    dev, calls = _kineto(prof)
    idx = _SpanIndex(spans)
    gaps = _gaps(dev, SHORT_GAP_US * 1e3)
    by_span: Dict[str, float] = collections.defaultdict(float)
    outside = 0
    for a, b in gaps:
        i = idx.innermost((a + b) // 2)
        by_span[OUTSIDE if i is None else spans[i].name] += (b - a) / 1e9
        outside += idx.outside_ns(a, b)
    # the span each CUDA call sat in, by its midpoint (id 0: no launch),
    # and the host's seconds inside CUDA calls by that span: a call that
    # blocks (a pageable copy waits for the stream) shows here
    call_span = {}
    in_calls: Dict[str, float] = collections.defaultdict(float)
    for s, e, corr, name in calls:
        i = idx.innermost((s + e) // 2)
        in_calls[OUTSIDE if i is None else spans[i].name] += (e - s) / 1e9
        if i is not None and corr:
            call_span[corr] = (i, name)
    handoff_ns = 0
    launched = collections.defaultdict(list)   # decode.run -> its graph
    for s, e, corr, name in dev:
        i, call = call_span.get(corr, (None, None))
        if i is None:
            continue
        if spans[i].name == "handoff.transfer":
            handoff_ns += e - s
        while i != -1 and spans[i].name != "decode.run":
            i = spans[i].parent
        if i != -1 and call in GRAPH_LAUNCH:
            launched[i].append((s, e, name, call))
    return {"idle_by_span": sorted(by_span.items(),
                                   key=lambda kv: -kv[1])[:10],
            "idle_s": sum(b - a for a, b in gaps) / 1e9,
            "idle_outside_step_s": outside / 1e9,
            "call_s_by_span": sorted(in_calls.items(),
                                     key=lambda kv: -kv[1])[:10],
            "handoff_copy_s": handoff_ns / 1e9,
            "handoff_spans": sum(s.name == "handoff.transfer"
                                 for s in spans),
            "clock": _clock(spans, launched)}


def _clock(spans, launched) -> Dict:
    """Per decode step, how far its graph's kernels fall outside
    [``decode.run`` opens, ``wait.validate`` closes]: the steps, those
    within 50 us, the worst miss in microseconds, and the three worst as
    (us, side, kernel, the CUDA call that launched it)."""
    validate_end = {}
    for s in spans:
        if s.name == "wait.validate" and s.parent != -1:
            validate_end[s.parent] = s.end_ns
    misses = []
    for i, ops in launched.items():
        if i not in validate_end:
            continue
        first = min(ops)
        last = max(ops, key=lambda op: op[1])
        early = spans[i].start_ns - first[0]
        late = last[1] - validate_end[i]
        side, op = ("early", first) if early > late else ("late", last)
        misses.append((max(0, early, late) / 1e3, side, op[2], op[3]))
    misses.sort(reverse=True)
    return {"steps": len(misses),
            "within_50us": sum(m[0] <= 50 for m in misses),
            "worst_miss_us": misses[0][0] if misses else None,
            "worst": [list(m) for m in misses[:3]]}
