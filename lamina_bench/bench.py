"""One run of one cell: set-up, the window, the metrics, the check.

:func:`run` does all of it on any device, so a test drives it on the CPU
at a reduced size; ``run.py`` adds the look for a card and prints the
result line.

The window itself is never traced, so the host-clock metrics read the
same loop in either kind of run. A ``--trace 1`` run follows the window
with a traced slice of the same loop (``TRACE_SECONDS`` at most), under a
profiler that records the card's activity and the CUDA calls only, not
every host operator; the device metrics read that slice, and standard
error compares its step with the window's. The slice is short because
reading its trace takes seconds for each of its seconds.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Tuple

import torch

from lamina_bench import guard, judge, profile
from lamina_bench.drive import Driver
from lamina_bench.spec import Cell


TRACE_SECONDS = 10.0


class ForbiddenImport(RuntimeError):
    """The run's process loaded JAX or the JAX package."""


def _metrics(cell: Cell, w, trace: bool) -> Dict:
    out = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = m.read(w)
        if value is not None:
            out[m.name] = {"value": float(value), "unit": m.unit}
    return out


def _device(device: torch.device, chips: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _traced(drv: Driver, seconds: float):
    """A slice of the loop after the window, traced (the card's kernels
    and copies, and the CUDA calls that launched them)."""
    from torch.profiler import ProfilerActivity
    prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    t = drv.window(seconds, prof)
    t.profile = profile.summarize(prof)
    return t


def probe_ms(repeats: int = 3) -> float:
    """The least of ``repeats`` timings, in milliseconds, of one fixed
    loop of pure Python: the host's single-thread speed just after the
    window, printed beside the run's numbers."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i & 7
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _step_ms_p50(w) -> float:
    return statistics.median(s.t1 - s.t0 for s in w.steps) * 1e3 \
        if w.steps else 0.0


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False) -> Tuple[Dict, List[str]]:
    """The result of one run (the keys of the result line) and the lines
    that state each compared number beside its limit."""
    device = torch.device(device)
    drv = Driver(cell, seed, device)
    drv.setup(int(cell.settings["warmup_steps"]))
    w = drv.window(seconds)
    w.setup_s = w.t_open - t_start
    if trace and device.type == "cuda":
        w.traced = _traced(drv, min(seconds, TRACE_SECONDS))
    drv.stop()
    w.host["probe_ms"] = probe_ms()
    dev = _device(device, cell.chips)
    if w.traced is not None:
        dev["busy_s"] = w.traced.profile["busy_s"]
        dev["window_s"] = w.traced.window_s
    metrics = _metrics(cell, w, trace)
    found = guard.forbidden_modules()
    if found:
        raise ForbiddenImport(f"loaded in the run's process: {found}")

    jconf = cell.settings["judge"]
    picked = judge.sample(drv.finished_in(w), seed, int(jconf["requests"]))
    weights, dims, arrival = drv.weights, drv.dims, drv.arrival
    prefix_of = drv.prefix
    drv.close()
    t0 = time.time()
    res = judge.judge(weights, dims, picked, arrival, prefix_of, control)
    res["seconds"] = time.time() - t0
    limit = float(jconf["max_gap"])
    why = judge.verdict(res, limit)
    checks = {"worst_gap": {"value": res["worst_gap"], "limit": limit}}
    if control:
        # the control in the program's place, through the same verdict
        ctrl = dict(res, worst_gap=res["control_gap"])
        checks["control_gap"] = {"value": res["control_gap"],
                                 "limit": limit,
                                 "correct": judge.verdict(ctrl, limit) is None}
    found = guard.forbidden_modules()
    if found:
        raise ForbiddenImport(f"loaded in the run's process: {found}")

    result = {"correct": why is None, "attempted": w.attempted,
              "failed": w.failed, "metrics": metrics, "device": dev}
    if w.traced is not None:
        p = w.traced.profile
        result["breakdown"] = {
            "device_ops": [[n, t] for n, t in p["device_ops"]],
            "idle_gaps": [[n, t] for n, t in p["idle_gaps"]]}
    result["host"] = w.host
    result["checks"] = checks
    bs = w.batch_sizes or [0]
    setup = " ".join(f"{k} {v:.2f}" for k, v in drv.setup_log.items())
    hostline = " ".join(f"{k} {v:.3f}" for k, v in w.host.items())
    lines = [f"set-up {w.setup_s:.2f} s: {setup}",
             f"window {w.window_s:.2f} s: {len(w.steps)} steps, step p50 "
             f"{_step_ms_p50(w):.2f} ms, decode batch {min(bs)}-{max(bs)}, "
             f"{w.graph_captures} captures, {w.attempted} requests sent",
             f"host: {hostline}"]
    if w.traced is not None:
        t = w.traced
        lines.append(f"traced slice {t.window_s:.2f} s: {len(t.steps)} "
                     f"steps, step p50 {_step_ms_p50(t):.2f} ms against the "
                     f"window's {_step_ms_p50(w):.2f} ms, "
                     f"{t.graph_captures} captures")
    lines.append(f"judged {res['requests']} requests, {res['tokens']} "
                 f"served tokens, reference {res['seconds']:.1f} s")
    lines += [f"check {k} {c['value']} limit {c['limit']}"
              + (f" correct {c['correct']}" if "correct" in c else "")
              for k, c in checks.items()]
    if why is not None:
        lines.insert(0, f"not correct: {why}")
    return result, lines
