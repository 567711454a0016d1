#!/usr/bin/env python3
"""Decode attention with a window of 8192 at the end of one sequence of
524,288 tokens (B = 1, the long_500k shapes of chip_smoke's phase 24),
against the same call at full context, for the kernels of one source tree:

    python3 tools/window_split_ab.py [SRC]

SRC is a tree's ``src`` directory (default: this repository's). Rows 1 and
3 (paged, one layer's pool of 32,768 blocks of 16 in table order) and rows
5 and 5-int8 (dense cache), each at its model's heads: llama3-8b-sw8k
(Hkv = 8, G = 4) and glm4-9b-sinks (Hkv = 2, G = 16, 4 sinks). Each call
is timed by CUDA events, the mean of 50 calls after a warm one, enqueued
while the card spins (device time: the host's enqueue is not counted); the
windowed call is also held against its plain twin (largest absolute error
of o) and printed beside its byte bound (the kept rows' K and V once over
3.35 TB/s). Where the tree's splits share the live rows (it has
``live_slots``), the windowed call is also timed at the plan's split
count and at forced counts below it, halving down to the least the
kernel holds (``split_sweep``): how the split
count trades each CTA's rows against the last CTA's merge of every
split's partial. To compare two trees, run both on the same card in
turns (parent, change, change, parent): each run builds its own tree's
kernels under that tree's ``build/``. Prints the card's name and power limit, then
one JSON line."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
S = 524_288
BS = 16
WINDOW = 8191                  # the serving window 8192 less the new token
HBM_BYTES_PER_S = 3.35e12
ITERS = 50
HOLD_CYCLES = 200_000_000      # ~0.1 s of spinning: 50 calls enqueued behind

# (name, paged, int8, Hkv, G, sinks)
CASES = [("row 1 llama3-8b-sw8k", True, False, 8, 4, 0),
         ("row 3 llama3-8b-sw8k", True, True, 8, 4, 0),
         ("row 3 glm4-9b-sinks", True, True, 2, 16, 4),
         ("row 5 glm4-9b-sinks", False, False, 2, 16, 4),
         ("row 5-int8 llama3-8b-sw8k", False, True, 8, 4, 0)]


def call_ms(torch, fn):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def _sm_count(torch):
    from repro_torch.kernels import _cuda
    return _cuda.sm_count(torch.device("cuda"))


def one(torch, mods, name, paged, int8, Hkv, G, sinks):
    da, pda = mods
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(Hkv * G + int8)
    shape = (Hkv, S // BS, BS, 128) if paged else (1, Hkv, S, 128)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=gen, device=dev) * 0.025
                  + 0.005 for _ in range(2))
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        kw = {}
    q = torch.randn((1, Hkv, G, 128), generator=gen, device=dev).bfloat16()
    clen = torch.tensor([S], dtype=torch.int32, device=dev)
    if paged:
        table = torch.arange(S // BS, dtype=torch.int32, device=dev)[None]
        args, fn = (q, k, v, table, clen), pda.paged_decode_attention
        plain = pda.paged_decode_attention_plain
    else:
        args, fn = (q, k, v, clen), da.decode_attention
        plain = da.decode_attention_plain
    kw.update(attention_sinks=sinks, return_partials=True)
    full = call_ms(torch, lambda: fn(*args, sliding_window=0, **kw))
    win = call_ms(torch, lambda: fn(*args, sliding_window=WINDOW, **kw))
    got = fn(*args, sliding_window=WINDOW, **kw)[0].float()
    want = plain(*args, sliding_window=WINDOW, **kw)[0].float()
    sweep = {}
    if hasattr(pda, "live_slots"):
        mod = pda if paged else da
        plan = mod.plan_splits
        n = plan(1, Hkv, shape[1] if paged else S,
                 _sm_count(torch), G)
        least = -(-shape[1] // pda.MAX_SLOTS_PER_SPLIT) if paged else 4
        try:
            while n >= least:
                mod.plan_splits = lambda *a, n=n, **k: n
                sweep[n] = call_ms(torch, lambda: fn(
                    *args, sliding_window=WINDOW, **kw))
                n //= 2
        finally:
            mod.plan_splits = plan
    rows = WINDOW + sinks
    row_bytes = (128 + 4) * 2 if int8 else 128 * 2 * 2
    return dict(case=name, full_ms=full, window_ms=win, split_sweep=sweep,
                window_over_full=win / full,
                window_bound_ms=rows * Hkv * row_bytes / HBM_BYTES_PER_S
                * 1e3,
                window_max_abs_err=float((got - want).abs().max()),
                finite=bool(torch.isfinite(got).all()))


def main(argv) -> int:
    src = Path(argv[0]).resolve() if argv else ROOT / "src"
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("window_split_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    _cuda.build([pda._LIB_NAME, da._LIB_NAME])
    out = {"src": str(src), "cases": []}
    for case in CASES:
        out["cases"].append(one(torch, (da, pda), *case))
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
