#!/usr/bin/env python3
"""The engine's host spans in one cell of the benchmark, on the card:

    python3 tools/span_split.py --workload <cell> --seed <n> \\
        [--seconds 30] [--pairs 6] [--pair-seconds 4] \\
        [--toggle-seconds 20] [--out FILE]

Builds the cell's engine and closed loop as ``lamina_bench/run.py`` does
and warms it up, then:

1. the recorder's cost: ``--pairs`` pairs of windows of ``--pair-seconds``,
   one with the engine's span recorder on and one off, alternating which
   runs first (each window's step p50, by the benchmark's own clock around
   ``step()``); ``--toggle-seconds`` of steps with the recorder on for
   every other one (the median difference of neighbouring steps); and the
   host time of 100,000 span opens and closes and of as many tests of a
   recorder that is off;
2. a window of ``--seconds`` with the recorder on, which the host metrics
   read, and a traced slice of 10 s after it with the recorder on, which
   the device metrics read, as the benchmark's ``--trace 1`` run reads its
   own window and slice (``lamina_bench/spans.py`` ``window``,
   ``summarize``).

Prints the span readers of ``lamina_bench/metrics/`` and the benchmark's
step, idle and batch readers, the step split by span (mean ms a step, in
the window and in the slice), how much of each step its direct children
cover, the slice's idle time by
the innermost span open, the clock check of the decode steps, the card's
name and power limit, and one JSON line, also written to ``--out``.
Needs a CUDA card."""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TRACE_SECONDS = 10.0
SPAN_READERS = ("host_busy_ms_per_step", "decode_host_ms_per_step",
                "handoff_host_ms_per_step", "handoff_copy_ms_per_step",
                "idle_outside_step_share", "queue_wait_ms_p50")
BENCH_READERS = ("step_ms_p50", "device_idle_share", "decode_batch_mean",
                 "admit_wait_ms_p50", "handoff_wait_ms_p50")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--pairs", type=int, default=6)
    p.add_argument("--pair-seconds", type=float, default=4.0)
    p.add_argument("--toggle-seconds", type=float, default=20.0)
    p.add_argument("--out", default=None)
    return p.parse_args(argv)


def step_p50_ms(w) -> float:
    return statistics.median(s.t1 - s.t0 for s in w.steps) * 1e3


def recorder_us(n: int = 100_000):
    """Microseconds of one span open and close on a recorder that is on,
    and of one ``if trace.on`` test on one that is off."""
    from repro_torch.serving.trace import SpanRecorder
    tr = SpanRecorder(capacity=2 * n + 2)
    tr.start()
    tr.open_step(0)
    t0 = time.perf_counter()
    for _ in range(n):
        tr.open("decode.run")
        tr.close()
    on = (time.perf_counter() - t0) / n * 1e6
    tr.stop()
    t0 = time.perf_counter()
    for _ in range(n):
        if tr.on:
            tr.open("decode.run")
        if tr.on:
            tr.close()
    off = (time.perf_counter() - t0) / n * 1e6
    return on, off


def cost(drv, pairs: int, seconds: float):
    """Step p50 of alternating windows with the recorder on and off."""
    from lamina_bench import spans
    on, off, counts = [], [], []
    for i in range(pairs):
        for traced in ((True, False) if i % 2 == 0 else (False, True)):
            if traced:
                w = spans.window(drv, seconds)
                on.append(step_p50_ms(w))
                roots = sum(s.parent == -1 for s in w.spans)
                counts.append(len(w.spans) / max(roots, 1))
            else:
                off.append(step_p50_ms(drv.window(seconds)))
    return on, off, counts


def toggled(drv, seconds: float):
    """Step times (ms) of one stretch of the loop in which the recorder is
    on for every other step: each step beside a neighbour of the other
    kind, so the host's drift between windows cancels."""
    from lamina_bench.drive import StepRecord
    tr = drv.eng.trace
    ms = {True: [], False: []}
    t_end = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < t_end:
        on = i % 2 == 0
        if on:
            tr.start()
        rec = StepRecord()
        drv._step(rec)
        if on:
            tr.stop()
        ms[on].append((rec.t1 - rec.t0) * 1e3)
        i += 1
    n = min(len(ms[True]), len(ms[False]))
    diffs = [a - b for a, b in zip(ms[True][:n], ms[False][:n])]
    return {"steps": 2 * n, "median_on": statistics.median(ms[True]),
            "median_off": statistics.median(ms[False]),
            "median_diff": statistics.median(diffs),
            "diff_quartiles": statistics.quantiles(diffs, n=4)}


def split(w):
    """Mean ms a step by span name, and the coverage of each step."""
    from lamina_bench import spans
    steps = spans.step_splits(w.spans)
    names = sorted({n for s in steps for n in s["by_name"]})
    mean = {n: sum(s["by_name"].get(n, 0) for s in steps) / len(steps) / 1e6
            for n in names}
    mean["step"] = sum(s["ns"] for s in steps) / len(steps) / 1e6
    mean["wait.*"] = sum(s["wait_ns"] for s in steps) / len(steps) / 1e6
    shares = sorted(s["children_ns"] / s["ns"] for s in steps if s["ns"])
    return mean, {"median": statistics.median(shares), "min": shares[0],
                  "p05": shares[len(shares) // 20]}


def main(argv=None) -> int:
    args = parse(argv)
    t_start = time.time()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import os
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    import torch
    if not torch.cuda.is_available():
        print("span_split: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    from lamina_bench import run, spans, spec
    from lamina_bench.drive import Driver
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = spec.load_cell(args.workload, bench, ROOT)
    drv = Driver(cell, args.seed, "cuda")
    drv.setup(int(cell.settings["warmup_steps"]))
    out = {"workload": args.workload, "seed": args.seed,
           "card": run.smi("name,power.limit"),
           "setup_s": time.time() - t_start}
    on_us, off_us = recorder_us()
    out["recorder_us"] = {"span_on": on_us, "site_off": off_us}
    on, off, counts = cost(drv, args.pairs, args.pair_seconds)
    out["cost"] = {"step_p50_on_ms": on, "step_p50_off_ms": off,
                   "median_on": statistics.median(on),
                   "median_off": statistics.median(off),
                   "spans_per_step": statistics.median(counts),
                   "toggled": toggled(drv, args.toggle_seconds)}
    w = spans.window(drv, args.seconds)
    # the benchmark's traced slice (bench._traced), the recorder on
    from torch.profiler import ProfilerActivity
    from lamina_bench import profile
    prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    w.traced = spans.window(drv, min(args.seconds, TRACE_SECONDS), prof)
    t0 = time.time()
    w.traced.profile = profile.summarize(prof)
    t1 = time.time()
    w.traced.span_profile = spans.summarize(prof, w.traced.spans)
    out["summarize_s"] = {"profile": t1 - t0, "spans": time.time() - t1}
    drv.stop()
    w.setup_s = out["setup_s"]
    metrics = {}
    for name in SPAN_READERS + BENCH_READERS:
        v = spec.load_reader(name)(w)
        metrics[name] = None if v is None else float(v)
    out["metrics"] = metrics
    out["split_ms"], out["coverage"] = split(w)
    out["slice_split_ms"] = split(w.traced)[0]
    sp = w.traced.span_profile
    out["idle_by_span"] = sp["idle_by_span"]
    out["call_s_by_span"] = sp["call_s_by_span"]
    out["clock"] = sp["clock"]
    out["slice"] = {k: sp[k] for k in ("idle_s", "idle_outside_step_s",
                                       "handoff_copy_s", "handoff_spans")}
    out["slice"]["steps"] = len(w.traced.steps)
    out["slice"]["step_p50_ms"] = step_p50_ms(w.traced)
    out["slice"]["idle_gaps"] = w.traced.profile["idle_gaps"]
    # the window's idle time a step (device_idle_share's arithmetic)
    # against the host's work a step plus the loop's time between steps
    n = len(w.steps)
    busy = spans.host_busy_ms(w.spans)
    between = (w.window_s - sum(s.t1 - s.t0 for s in w.steps)) * 1e3 / n
    out["idle_check_ms"] = {
        "idle_per_step": metrics["device_idle_share"] / 100 *
        w.window_s * 1e3 / n,
        "host_busy_mean": sum(busy) / len(busy),
        "between_steps": between}
    out["window"] = {"seconds": w.window_s, "steps": n,
                     "output_tok_s": w.output_tokens / w.window_s}
    drv.close()
    out["seconds"] = time.time() - t_start
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
