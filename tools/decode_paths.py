#!/usr/bin/env python3
"""Which design of row 1 (the paged decode kernel) ran in one cell of the
benchmark, on the card:

    python3 tools/decode_paths.py --workload <cell> --seed <n> \\
        [--seconds 30] [--trace 0]

Runs the cell as ``lamina_bench/run.py`` does, in this process (its lines
and its result line as that prints them), then prints one JSON line with
the paged decode wrappers' launch counters since the process started: the
bf16 entry's ``launches`` and, of them, those that ran on the tensor cores
(``tc_launches``; null in a tree without the tensor-core design), and the
int8 entry's ``launches``. The engine's captured graphs count every replay
(``serving/compiled.py`` ``LaunchDeltas``), so the counts cover set-up,
the window and the judge's requests alike. Needs a CUDA card."""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from lamina_bench import run
    rc = run.main(argv)
    from repro_torch.kernels import paged_decode_attention as pda
    bf16, int8 = pda.paged_decode_attention, pda.paged_decode_attention_int8
    print(json.dumps({"rc": rc, "paged_decode_attention": {
        "launches": bf16.launches,
        "tc_launches": getattr(bf16, "tc_launches", None)},
        "paged_decode_attention_int8": {"launches": int8.launches}}),
        flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
