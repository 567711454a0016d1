"""What the RWKV6 backward kernel's per-channel sweep costs on the card.

Pass 2 of ``rwkv6_scan_bwd`` (``src/repro_torch/csrc/rwkv6_scan.cu``)
computes the in-tile terms of dr, dk and dw on the CUDA cores: one thread
a key channel walks every pair (s > t) of the tile. This script builds a
second copy of that kernel with the sweep cut out (its threads skip it, so
dr, dk, dw and du are left unwritten while dv is still computed) and times
both in one process at chip_smoke's phase 21 (d) shape, held as chip_smoke
holds a kernel (a cold L2, the card busy through the enqueue), in the order
kernel, cut, cut, kernel. The cut copy's time bounds what any rearrangement
of the sweep can save. The cut copy's dv must equal the kernel's bit for
bit (only the sweep went).

    python3 tools/rwkv6_bwd_sweep_cost.py [--batch 8 --seq 2048 --heads 64]

Needs a CUDA card and nvcc. Prints the card's name and power limit, then
one JSON line: held ms of each run per dtype and the shape.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402

# the sweep's branch in pass 2, and the end of it (the dv branch's start)
SWEEP = ("    if (tid < P) {\n      // dr, dk and dw of channel p",
         "    if (tid < P) {\n      if (false) {\n"
         "      // dr, dk and dw of channel p")
SWEEP_END = ("    } else {\n      // dv = ",
             "    }} else {\n      // dv = ")
HOLD_CYCLES = 200_000                  # ~0.1 ms at the H100's clock


def build_cut() -> ctypes.CDLL:
    """The rwkv6_scan library with pass 2's per-channel sweep cut out,
    built from a patched copy of the source under the build directory."""
    src = (_cuda.CSRC / "rwkv6_scan.cu").read_text()
    for old, new in (SWEEP, SWEEP_END):
        if src.count(old) != 1:
            raise RuntimeError(f"rwkv6_scan.cu: {old!r} is not found once")
        src = src.replace(old, new)
    out = _cuda.BUILD_DIR / "sweep_cut"
    out.mkdir(parents=True, exist_ok=True)
    for header in _cuda.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    (out / "rwkv6_scan.cu").write_text(src)
    lib = out / "rwkv6_scan_sweep_cut.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(out), "-o",
                    str(lib), str(out / "rwkv6_scan.cu")], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def held_ms(fn, flush, iters=9) -> float:
    """Median device ms of ``fn()`` after a 128 MB flush, the card spinning
    through the enqueue."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[iters // 2]


def operands(B, S, H, P, dtype):
    """chip_smoke's rwkv_bwd_case inputs: the model's decays, exact 0 among
    them, and a random dy."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    shape = (B, S, H, P)
    r, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    noise = torch.randn(shape, generator=gen, device="cuda")
    w = torch.exp(-torch.exp(-6.0 + 0.5 * noise))
    w = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.02,
                    0.0, w).to(dtype).contiguous()
    u = torch.randn((H, P), generator=gen, device="cuda") * 0.5
    dy = torch.randn(shape, generator=gen, device="cuda")
    return r, k, v, w, u, dy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--heads", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    B, S, H, P = args.batch, args.seq, args.heads, 64
    kernel = _cuda.load(rw._LIB_NAME)
    libs = {"kernel": kernel, "cut": build_cut()}
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {"shape": dict(B=B, S=S, H=H, P=P)}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            ops = operands(B, S, H, P, dtype)
            runs, dv = [], {}
            for name in ("kernel", "cut", "cut", "kernel"):
                _cuda._LIBS[rw._LIB_NAME] = libs[name]
                runs.append((name, held_ms(lambda: rw.rwkv6_scan_bwd(*ops),
                                           flush)))
                dv[name] = rw.rwkv6_scan_bwd(*ops)[2]
            torch.cuda.synchronize()
            if not torch.equal(dv["kernel"], dv["cut"]):
                raise AssertionError(f"{dtype}: the cut copy's dv differs")
            out[str(dtype).split(".")[-1]] = {
                "held_ms": runs,
                "kernel_ms": sorted(t for n, t in runs if n == "kernel"),
                "cut_ms": sorted(t for n, t in runs if n == "cut")}
    finally:
        _cuda._LIBS[rw._LIB_NAME] = kernel
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
