#!/usr/bin/env python3
"""Whether rwkv6-7b's one-shot prefill of one seeded prompt of S tokens at
B = 1 (full width and depth, random bf16 weights from seed 0) fits the
card, for each S given:

    python3 tools/long_prefill_fit.py 524288 262144

Each S runs in a process of its own (an out-of-memory error leaves the
allocator's state behind it), builds the RWKV6 scan first, and prints one
JSON line: S, whether it ran, its wall seconds, the peak of allocated
memory and, when it did not fit, the allocator's message (what it asked
for, what was allocated and reserved). The first line is the card's name
and power limit. chip_smoke's phase 24 prefills at the longest S that
fits."""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(S: int) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import rwkv6_scan
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves
    _cuda.build([rwkv6_scan._LIB_NAME])
    cfg = registry.get_config("rwkv6-7b")
    params = transformer.init_params(0, cfg, device="cuda")
    tokens = np.random.default_rng(24).integers(
        0, cfg.vocab_size, size=(1, S)).tolist()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = {"S": S}
    try:
        logits, _ = transformer.prefill(params, cfg, {"tokens": tokens},
                                        max_seq=S, device="cuda")
        torch.cuda.synchronize()
        out.update(ok=True, wall_s=time.perf_counter() - t0,
                   finite=bool(torch.isfinite(logits.float()).all()))
    except torch.OutOfMemoryError as e:
        out.update(ok=False, wall_s=time.perf_counter() - t0,
                   error=str(e).split(". If reserved")[0])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["weights_gib"] = sum(t.numel() * t.element_size()
                             for t in tree_leaves(params)) / 2**30
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(int(sys.argv[2]))), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    for s in sys.argv[1:]:
        res = subprocess.run([sys.executable, __file__, "--one", s],
                             capture_output=True, text=True, timeout=900)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
        print(lines[-1] if lines else json.dumps(
            {"S": int(s), "ok": False, "rc": res.returncode,
             "stderr": res.stderr[-800:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
