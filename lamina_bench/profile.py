"""What a ``torch.profiler`` trace of the window says: device busy time
(the union of the intervals in which an operation ran on the device),
device seconds by kernel name, the matmul kernels' seconds, and the idle
gaps by the CUDA call the host was in (none: the host was running
Python). The profiler records the card's activity and the CUDA calls
only, so it adds little to the host's step.

``GEMM_MARKERS``, ``PROFILER_OWN`` and the device-event filter are frozen
copies of ``chip_smoke.py:2219``-``2222`` and of ``profile_window``'s
arithmetic (``chip_smoke.py:2247``-``2266``); the busy time here is the
union of intervals, not chip_smoke's sum of kernel times, which counts
twice what two streams run at once.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

# cuBLAS / CUTLASS matmul kernels by name (chip_smoke.py:2219)
GEMM_MARKERS = ("gemm", "gemv", "nvjet", "xmma", "cutlass")
# the profiler's and the driver's own activities, not operators
# (chip_smoke.py:2221)
PROFILER_OWN = ("Module Loading", "Function Loading", "Activity Buffer")
# the profiler's own host-side activities, never what the host was
# doing for the program
PROFILER_HOST = PROFILER_OWN + ("Buffer Flush",)
# a gap shorter than this sits between two launches of one replay or one
# op; it is named as such rather than by a host event
SHORT_GAP_US = 20.0


def is_gemm(name: str) -> bool:
    return any(m in name.lower() for m in GEMM_MARKERS)


def _union(intervals: List[Tuple[float, float]]):
    """Merged (start, end) intervals of ``intervals`` sorted by start."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_label(cpu: List[Tuple[float, float, str]], starts: List[float],
                t: float) -> str:
    """The host's CUDA call running at ``t`` that started last (the
    innermost of those open at ``t``), from the 400 that started before
    it."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 400, 0) - 1, -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "host: Python (no CUDA call)"


def _events(prof):
    """(device, host) events of a stopped profiler as (start, end, name) in
    microseconds, read from its raw kineto results (building its
    ``FunctionEvent`` tree would take minutes for a window's events); the
    host's are its CUDA calls.
    Annotations (``record_function`` spans, which the trace also shows on
    the device's timeline) and the profiler's own activities are left
    out of the device's."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or end <= start or \
                    any(m in name for m in PROFILER_OWN):
                continue
            dev.append((start, end, name))
        elif e.device_type() == DeviceType.CPU and \
                not any(m in name for m in PROFILER_HOST):
            cpu.append((start, end, name))
    return dev, cpu


def summarize(prof) -> Dict:
    """Device busy seconds, device seconds by kernel name, the matmul
    seconds and the idle gaps of a stopped ``torch.profiler.profile``."""
    dev, cpu = _events(prof)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for s, e, name in dev:
        by_name[name] += (e - s) / 1e6
    merged = _union([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in merged)
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gap = s1 - e0
        label = ("between launches (< 20 us)" if gap < SHORT_GAP_US
                 else _host_label(cpu, starts, (e0 + s1) / 2))
        gaps[label] += gap / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "kernel_s": dict(by_name),
        "gemm_s": sum(t for n, t in by_name.items() if is_gemm(n)),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }


def kernel_seconds(profile: Dict, marker: str) -> float:
    """Device seconds of the kernels whose name holds ``marker``."""
    return sum(t for n, t in profile["kernel_s"].items() if marker in n)
