"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python3 lamina_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number beside its limit, which also end
standard error). Without a CUDA card, or with fewer cards than the cell
asks for, it exits 3 and prints no result; a failure exits 1.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="also read the float8 control's widest gap (for "
                        "setting limits; the benchmark's runs never do)")
    return p.parse_args(argv)


def smi(fields: str) -> str:
    """``fields`` of the first card as nvidia-smi prints them."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout else \
        out.stderr.strip()


def main(argv=None) -> int:
    args = parse(argv)
    # every cache the run writes stays in the checkout, at a fixed path
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from lamina_bench import spec
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = spec.load_cell(args.workload, bench, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"lamina_bench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    from lamina_bench import bench as bench_mod
    result, lines = bench_mod.run(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START,
                                  control=bool(args.control))
    result["device"]["power_limit"] = smi("name,power.limit")
    checks = result.pop("checks")
    result["checks"] = checks           # the last key of the line
    # the card after the run, before the compared numbers end the lines
    state = smi("clocks.sm,clocks.mem,temperature.gpu,power.draw,"
                "clocks_throttle_reasons.active")
    at = next(i for i, line in enumerate(lines)
              if line.startswith("check "))
    lines.insert(at, f"card (sm MHz, mem MHz, C, W, throttle): {state}")
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
