#!/usr/bin/env python3
"""Host microseconds of one call of the kernel entries of rows 1, 3, 5, 6
and 7, on the card, for the port tree at SRC (default: this checkout's
``src``), at chip_smoke's phase 2 and 7 shapes:

    python3 tools/kernel_host_us.py [SRC] [--custom-op]

Each row is timed as chip_smoke's ``Timer.host_us`` times it, repeated:
a warm call, then 200 calls enqueued back to back, the host clock over
them divided by 200 (the enqueue cost of a call, which a replayed CUDA
graph does not pay); the median of 7 such windows is printed. To compare
two trees, run them in one chip call in turns (parent, change, change,
parent, ...): each run builds its own tree's kernels under that tree's
``build/``. ``--custom-op`` also times a
``torch.library.custom_op`` whose body returns three empty tensors, the
dispatcher cost a custom-op face of a kernel would add to every call.
Prints one JSON line with the card's name and power limit."""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS = 200
WINDOWS = 7


def host_us(torch, fn, calls=CALLS, windows=WINDOWS):
    out = []
    for _ in range(windows):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(out)[len(out) // 2]


def main(argv) -> int:
    src = Path(argv[0]).resolve() if argv and not argv[0].startswith("--") \
        else ROOT / "src"
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_host_us: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import rwkv6_scan as rwkv
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.models.kv_quant import quantize_kv
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"src": str(src)}

    # rows 1 and 3: llama3-8b's paged decode (phase 2): B=8, Hkv=8, G=4,
    # hd=128, blocks of 16, lengths up to 2048
    B, Hkv, G, hd, bs, nb = 8, 8, 4, 128, 16, 128
    lens = rng.integers(1, nb * bs + 1, size=B).astype(np.int32)
    lens[0] = nb * bs
    NB = B * nb + 1
    q = torch.randn((B, Hkv, G, hd), generator=gen, device=dev).bfloat16()
    kp = torch.randn((Hkv, NB, bs, hd), generator=gen, device=dev)
    vp = torch.randn((Hkv, NB, bs, hd), generator=gen, device=dev)
    bt = torch.from_numpy(1 + np.arange(B * nb, dtype=np.int32).reshape(
        B, nb)).to(dev)
    cl = torch.from_numpy(lens).to(dev)
    kb, vb = kp.bfloat16(), vp.bfloat16()
    (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
    out["row1_paged_decode_bf16_us"] = host_us(
        torch, lambda: pda.paged_decode_attention(q, kb, vb, bt, cl))
    out["row3_paged_decode_int8_us"] = host_us(
        torch, lambda: pda.paged_decode_attention_int8(q, kq, vq, ks, vs, bt,
                                                       cl))
    del kp, vp, kb, vb, kq, vq, ks, vs
    # row 5: zamba2's dense decode (phase 7): B=8, Hkv=32, G=1, hd=64,
    # 2080 rows
    B, Hkv, G, hd, S = 8, 32, 1, 64, 2080
    dq = torch.randn((B, Hkv, G, hd), generator=gen, device=dev).bfloat16()
    dk = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).bfloat16()
    dv = torch.randn((B, Hkv, S, hd), generator=gen, device=dev).bfloat16()
    dl = torch.full((B,), S, dtype=torch.int32, device=dev)
    out["row5_dense_decode_bf16_us"] = host_us(
        torch, lambda: da.decode_attention(dq, dk, dv, dl))
    del dk, dv
    # rows 6 and 7: the scans at zamba2's / rwkv6's prefill (phase 7):
    # B=8, S=2048, H=64, P=64 (N=64), through their autograd Functions
    B, S, H, P, N = 8, 2048, 64, 64, 64
    x = torch.randn((B, S, H, P), generator=gen, device=dev)
    Bi = torch.randn((B, S, N), generator=gen, device=dev)
    Ci = torch.randn((B, S, N), generator=gen, device=dev)
    decay = torch.rand((B, S, H), generator=gen, device=dev)
    out["row6_ssm_scan_us"] = host_us(
        torch, lambda: ssm.ssm_scan(x, Bi, Ci, decay))
    r, k, v = (torch.randn((B, S, H, P), generator=gen,
                           device=dev).bfloat16() for _ in range(3))
    w = torch.rand((B, S, H, P), generator=gen, device=dev).bfloat16()
    u = torch.randn((H, P), generator=gen, device=dev)
    out["row7_rwkv6_scan_bf16_us"] = host_us(
        torch, lambda: rwkv.rwkv6_scan(r, k, v, w, u))

    if "--custom-op" in argv:
        from typing import Tuple

        @torch.library.custom_op("host_us_probe::face", mutates_args=())
        def face(q_: torch.Tensor, k_: torch.Tensor, n: int, c: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
            return (torch.empty_like(q_), torch.empty_like(q_),
                    torch.empty_like(q_))

        @face.register_fake
        def _(q_, k_, n, c):
            return (torch.empty_like(q_), torch.empty_like(q_),
                    torch.empty_like(q_))

        small = torch.zeros((8, 8), device=dev)

        def plain():
            return (torch.empty_like(small), torch.empty_like(small),
                    torch.empty_like(small))

        out["custom_op_call_us"] = host_us(torch, lambda: face(small, small,
                                                               3, 1.0))
        out["same_body_without_custom_op_us"] = host_us(torch, plain)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out.update(card=card, torch=torch.__version__, calls=CALLS,
               windows=WINDOWS)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
