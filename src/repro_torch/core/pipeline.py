"""Rotational staggered pipelining (paper §4.3, Fig. 8). Port of
``repro/core/pipeline.py``; the schedule is exact rational arithmetic and
``run_rotational`` executes the port's sliced block programs
(``core/converter.py``) over environments of torch tensors.

n concurrent batches, R = n-1 model replicas, one shared attention pool.
t_m = time of ONE model slice, t_a = time of one attention call; the pool is
sized so t_a = t_m / (n-1). Batch j starts j·t_a after batch 0; slice k of
batch j runs on replica (j+k) mod R; its attention call follows immediately.

With these choices the schedule is exactly tight:
  * replica r executes model slices back-to-back at times r·t_a + q·t_m,
  * the attention pool executes calls back-to-back at consecutive multiples
    of t_a (index j + k·n + R is a distinct integer per (j, k)),
so both pools are conflict-free AND bubble-free — `validate` proves this
discretely (Fractions, no float fuzz).
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Event:
    batch: int
    step: int            # slice index within the iteration
    device: str          # "model:<r>" or "attn"
    start: Fraction
    end: Fraction


@dataclasses.dataclass
class Schedule:
    n_batches: int
    n_steps: int
    events: List[Event]
    t_model: Fraction    # one model slice
    t_attn: Fraction     # one attention call = t_model / (n-1)

    @property
    def makespan(self) -> Fraction:
        return max(e.end for e in self.events)


def rotational_schedule(n_batches: int, n_steps: int,
                        t_model: float = 1.0) -> Schedule:
    if n_batches < 2:
        raise ValueError("staggered pipelining needs >= 2 batches")
    n, R = n_batches, n_batches - 1
    tm = Fraction(t_model).limit_denominator(10**9)
    ta = tm / R
    events: List[Event] = []
    for j in range(n):
        for k in range(n_steps):
            start = j * ta + k * (tm + ta)
            r = (j + k) % R
            events.append(Event(j, k, f"model:{r}", start, start + tm))
            events.append(Event(j, k, "attn", start + tm, start + tm + ta))
    return Schedule(n, n_steps, events, tm, ta)


def validate(s: Schedule) -> Dict[str, bool]:
    """Prove: conflict-free on every device, sequential per batch,
    bubble-free on the attention pool in the steady-state window."""
    by_device: Dict[str, List[Event]] = {}
    for e in s.events:
        by_device.setdefault(e.device, []).append(e)
    conflict_free = True
    for dev, evs in by_device.items():
        evs = sorted(evs, key=lambda e: e.start)
        for a, b in zip(evs, evs[1:]):
            if b.start < a.end:
                conflict_free = False
    sequential = True
    for j in range(s.n_batches):
        evs = sorted([e for e in s.events if e.batch == j],
                     key=lambda e: (e.start, e.device != "attn"))
        for a, b in zip(evs, evs[1:]):
            if b.start < a.end:
                sequential = False
    attn = sorted([e for e in s.events if e.device == "attn"],
                  key=lambda e: e.start)
    # steady state: from the last batch's first attention to the first
    # batch's last attention
    lo = max(e.start for e in attn if e.step == 0)
    hi = min(max(e.end for e in attn if e.batch == j)
             for j in range(s.n_batches))
    busy = sum(min(e.end, hi) - max(e.start, lo)
               for e in attn if e.end > lo and e.start < hi)
    # vacuously bubble-free when the steady-state window is empty (short runs)
    bubble_free = (hi <= lo) or busy == (hi - lo)
    return {"conflict_free": conflict_free, "sequential": sequential,
            "attn_bubble_free": bubble_free}


def utilisation(s: Schedule) -> Dict[str, float]:
    span = float(s.makespan)
    out: Dict[str, float] = {}
    for e in s.events:
        out[e.device] = out.get(e.device, 0.0) + float(e.end - e.start)
    return {d: b / span for d, b in out.items()}


def throughput_speedup(n_batches: int) -> float:
    """Aggregate-throughput multiplier vs one non-pipelined batch on the SAME
    hardware (R replicas idle when attention runs): n batches complete an
    iteration every (t_m + t_a) per slice vs 1 batch per (t_m + t_a) —
    the win is n× more sequences at (n-1)× replicas + shared pool, i.e.
    per-replica efficiency n/(n-1) and zero attention-pool idle time."""
    n = n_batches
    return n / (n - 1)


# ---------------------------------------------------------------------------
# Executable demonstration: run real sliced programs under the rotation
# ---------------------------------------------------------------------------
def run_rotational(sliced_programs, batches_inputs, attention_fn
                   ) -> Tuple[List[dict], List[Tuple]]:
    """Execute n batches through their sliced block programs in the exact
    global order the schedule prescribes (single-host simulation). Logs
    (batch, slice, replica) tuples so callers can check the rotation law
    (j + k) mod (n-1). The schedule order is realised by sorting events by
    start time; data dependencies hold because batch j's slice k+1 starts
    strictly after its attention k completes. ``attention_fn(j, op_name,
    env)`` plays batch j's remote attention workers."""
    n = len(batches_inputs)
    n_steps = len(sliced_programs[0].slices)
    envs = [dict(b) for b in batches_inputs]
    log: List[Tuple[int, int, int]] = []
    if n >= 2:
        sched = rotational_schedule(n, n_steps)
        order = sorted([e for e in sched.events
                        if e.device.startswith("model:")],
                       key=lambda e: (e.start, e.batch))
    else:
        order = [Event(0, k, "model:0", Fraction(k), Fraction(k + 1))
                 for k in range(n_steps)]
    for ev in order:
        j, k = ev.batch, ev.step
        replica = (j + k) % max(n - 1, 1)
        sp = sliced_programs[j]
        sl = sp.slices[k]
        if sl.recv_attn is not None:
            envs[j][sl.recv_attn] = attention_fn(j, sl.recv_attn, envs[j])
        for name in sl.program:
            op = sp.graph.ops[name]
            if op.kind != "input":
                envs[j][name] = op.fn(*[envs[j][i] for i in op.inputs])
        log.append((j, k, replica))
    return envs, log
