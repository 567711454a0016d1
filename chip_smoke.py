#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py        # every phase, one card, no arguments

Phases (any failure exits non-zero and prints no result line):
  1. device: card name and power limit, torch/CUDA versions, kernel build;
  2. paged decode kernel vs its plain PyTorch twin on the card, at
     llama3-8b's decode shapes, with POS_PAD slots, and a gemma2-shaped
     window + sinks + softcap case;
  3. paged chunk-prefill kernel vs its plain twin (C=512 at P=0 and
     P=1536, a final partial chunk C=300, a gemma2-shaped masked case);
  4. end to end: llama3-8b at full width and depth (random bf16 weights
     from seed 0) serving 8 requests through LLMEngine with chunked
     prefill; checks kernel launch counts, finishes, and the chunked vs
     one-shot logit cosine;
  5. one JSON line describing every ported kernel (and the TPU kernels
     still to port), then the result line.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a CUDA device or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
ERR_RTOL, ERR_ATOL = 8e-3, 1e-3   # bf16 outputs: 2 ulp relative + floor

TODO_KERNELS = [
    ("paged_decode_attention_int8",
     "src/repro/kernels/paged_decode_attention.py:119"),
    ("paged_prefill_chunk_attention_int8",
     "src/repro/kernels/paged_prefill_attention.py:128"),
    ("decode_attention", "src/repro/kernels/decode_attention.py:31"),
    ("ssm_scan", "src/repro/kernels/ssm_scan.py:20"),
    ("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:22"),
]


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------
class Timer:
    """Median per-call device time with a cold L2 before every call (the
    main path reads a different layer's pool slice each call)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters=15, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, want, rtol=ERR_RTOL, atol=ERR_ATOL):
    import torch
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 2: paged decode
# ---------------------------------------------------------------------------
def decode_case(torch, pda, timer, *, B, Hkv, G, hd, bs, lens, seed,
                sliding_window=0, sinks=0, softcap=0.0, pos_pad=False,
                library=True):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nbs = [-(-n // bs) for n in lens]
    nb = max(nbs)
    NB = sum(nbs) + 9
    shape = (Hkv, NB, bs, hd)
    k_pool = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    v_pool = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    k_pool[:, 0] = float("nan")            # a free block full of NaN ...
    v_pool[:, 0] = float("nan")
    perm = torch.randperm(NB - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, nb), dtype=torch.int32, device="cuda")  # ... pad
    used = 0
    for i, n in enumerate(nbs):
        tables[i, :n] = perm[used:used + n].int()
        used += n
        last = int(tables[i, n - 1])
        tail = lens[i] - (n - 1) * bs      # stale NaN past cache_len
        k_pool[:, last, tail:] = float("nan")
        v_pool[:, last, tail:] = float("nan")
    q = torch.randn((B, Hkv, G, hd), generator=gen, device="cuda").bfloat16()
    cache_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    positions = None
    if pos_pad:     # a block-sharded table: foreign slots carry POS_PAD
        base = torch.arange(nb, dtype=torch.int32, device="cuda") * bs
        positions = base[None].repeat(B, 1).contiguous()
        positions[:, 1::2] = pda.POS_PAD
        tables[:, 1::2] = 0                # ... and point at the NaN block
    kw = dict(block_positions=positions, sliding_window=sliding_window,
              attention_sinks=sinks, logit_softcap=softcap,
              return_partials=True)
    o, l, m = pda.paged_decode_attention(q, k_pool, v_pool, tables,
                                         cache_len, **kw)
    torch.cuda.synchronize()
    po, pl, pm = pda.paged_decode_attention_plain(q, k_pool, v_pool, tables,
                                                  cache_len, **kw)
    err = check_close("decode o", o, po)
    check_close("decode l", l, pl, rtol=1e-3, atol=1e-6)
    check_close("decode m", m, pm, rtol=0.0, atol=1e-3)
    # rows the masks keep (the data-dependent work of this run)
    pos = (torch.arange(nb, device="cuda")[:, None] * bs +
           torch.arange(bs, device="cuda")).reshape(-1)
    valid = pos[None] < cache_len[:, None]
    if positions is not None:
        valid &= (positions[:, :, None] < pda.POS_PAD).expand(
            B, nb, bs).reshape(B, -1)
    if sliding_window:
        valid &= (pos[None] >= cache_len[:, None] - sliding_window) | \
            (pos[None] < sinks)
    rows = int(valid.sum())
    H = Hkv * G
    nbytes = (rows * Hkv * hd * 2 * 2 + q.numel() * 2 + tables.numel() * 4 +
              B * 4 + o.numel() * 2 + 2 * l.numel() * 4)
    flops = 4 * rows * H * hd          # QK + PV, per kept (row, query head)
    bound_ms, bound_by = bound(nbytes, flops)
    kernel_ms = timer.ms(lambda: pda.paged_decode_attention(
        q, k_pool, v_pool, tables, cache_len, **kw))
    plain_ms = timer.ms(lambda: pda.paged_decode_attention_plain(
        q, k_pool, v_pool, tables, cache_len, **kw), iters=5)
    library_ms = None
    if library and softcap == 0.0:
        # yardstick only: SDPA over pre-gathered dense K/V (not timed)
        kc, vc = pda.paged_gather_dense(k_pool, v_pool, tables)
        kc = torch.where(valid[:, None, :, None], kc, 0).repeat_interleave(
            G, dim=1)
        vc = torch.where(valid[:, None, :, None], vc, 0).repeat_interleave(
            G, dim=1)
        qd = q.reshape(B, H, 1, hd)
        mask = valid[:, None, None, :]
        library_ms = timer.ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qd, kc, vc, attn_mask=mask))
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                rows=rows)


# ---------------------------------------------------------------------------
# phase 3: paged chunk prefill
# ---------------------------------------------------------------------------
def prefill_case(torch, ppa, timer, *, H, Hkv, hd, bs, P, C, seed,
                 sliding_window=0, sinks=0, softcap=0.0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nb = P // bs
    NB = nb + 5
    shape = (Hkv, NB, bs, hd)
    k_pool = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    v_pool = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    table = (torch.randperm(NB, generator=gen, device="cuda")[:nb]).int()
    q = torch.randn((C, H, hd), generator=gen, device="cuda").bfloat16()
    kc = torch.randn((C, Hkv, hd), generator=gen, device="cuda").bfloat16()
    vc = torch.randn((C, Hkv, hd), generator=gen, device="cuda").bfloat16()
    kw = dict(sliding_window=sliding_window, attention_sinks=sinks,
              logit_softcap=softcap)
    out = ppa.paged_prefill_chunk_attention(q, k_pool, v_pool, table, kc, vc,
                                            **kw)
    torch.cuda.synchronize()
    ref = ppa.paged_prefill_chunk_attention_plain(q, k_pool, v_pool, table,
                                                  kc, vc, **kw)
    err = check_close("prefill out", out, ref)
    pos_q = P + torch.arange(C, device="cuda")[:, None]
    pos_k = torch.arange(P + C, device="cuda")[None, :]
    valid = pos_k <= pos_q
    if sliding_window:
        valid &= (pos_k > pos_q - sliding_window) | (pos_k < sinks)
    pairs = int(valid.sum())                  # per query head
    nbytes = (2 * (q.numel() + kc.numel() + vc.numel() + out.numel()) +
              P * Hkv * hd * 2 * 2 + nb * 4)
    flops = 4 * pairs * H * hd
    bound_ms, bound_by = bound(nbytes, flops)
    kernel_ms = timer.ms(lambda: ppa.paged_prefill_chunk_attention(
        q, k_pool, v_pool, table, kc, vc, **kw), iters=9)
    plain_ms = timer.ms(lambda: ppa.paged_prefill_chunk_attention_plain(
        q, k_pool, v_pool, table, kc, vc, **kw), iters=5)
    library_ms = None
    if softcap == 0.0:
        kp, vp = ppa.gather_prefix_dense(k_pool, v_pool, table)
        G = H // Hkv
        kd = torch.cat([kp, kc]).permute(1, 0, 2).repeat_interleave(
            G, dim=0)[None]
        vd = torch.cat([vp, vc]).permute(1, 0, 2).repeat_interleave(
            G, dim=0)[None]
        qd = q.permute(1, 0, 2)[None]
        library_ms = timer.ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=valid[None, None]), iters=9)
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# phase 4: end to end
# ---------------------------------------------------------------------------
def end_to_end(torch, np, pda, ppa):
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.serving import (EngineConfig, LLMEngine, PagedKVCache,
                                     Request, SamplingParams, State)

    cfg = registry.get_config("llama3-8b")
    t0 = time.perf_counter()
    params = transformer.init_params(0, cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"e2e: llama3-8b L={cfg.num_layers} d={cfg.d_model} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"init {time.perf_counter() - t0:.1f} s")
    econf = EngineConfig(placement="homogeneous", scheduler="fcfs",
                         block_size=16, num_blocks=2048, max_batch=8,
                         prefill_chunk_tokens=512)

    # warm-up (library handles, allocator) on a small pool, not counted
    warm = LLMEngine(cfg, params, econf.replace(num_blocks=64),
                     device="cuda")
    warm.submit([Request(prompt=list(range(1, 41)),
                         params=SamplingParams(max_new_tokens=2))])
    warm.run()
    del warm

    rng = np.random.default_rng(0)
    lens = rng.integers(300, 2001, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    reqs = [Request(prompt=p, params=SamplingParams(max_new_tokens=32))
            for p in prompts]
    log(f"e2e: prompt lengths {lens.tolist()} "
        f"({sum(int(n) % 16 != 0 for n in lens)} not multiples of 16)")
    eng = LLMEngine(cfg, params, econf, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    pda.paged_decode_attention.launches = 0
    ppa.paged_prefill_chunk_attention.launches = 0
    t0 = time.perf_counter()
    eng.submit(reqs)
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": pda.paged_decode_attention.launches,
                "paged_prefill_chunk_attention":
                    ppa.paged_prefill_chunk_attention.launches}
    st = eng.stats
    peak = torch.cuda.max_memory_allocated()

    if not all(r.state == State.FINISHED and len(r.output) == 32
               for r in reqs):
        raise AssertionError("not every request finished with 32 tokens: "
                             f"{[len(r.output) for r in reqs]}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError("sampled token outside the vocabulary")
    L = cfg.num_layers
    if launches["paged_decode_attention"] != L * st.steps or st.steps == 0:
        raise AssertionError(f"decode launches {launches} != {L} x "
                             f"{st.steps} decode steps")
    if launches["paged_prefill_chunk_attention"] != \
            L * st.prefill_chunks_run or st.prefill_chunks_run == 0:
        raise AssertionError(f"chunk launches {launches} != {L} x "
                             f"{st.prefill_chunks_run} chunks")
    n_out = sum(len(r.output) for r in reqs)
    ttft = st.ttft_percentiles()["p50"]
    tbt = st.tbt_percentiles()["p50"]
    decode_ms = float(np.mean(st.step_times)) * 1e3
    log(f"e2e: {len(reqs)} requests finished, {n_out} tokens in "
        f"{wall:.3f} s -> {n_out / wall:.1f} tok/s; decode steps {st.steps} "
        f"(mean {decode_ms:.1f} ms each, host clock to synchronised "
        f"logits) chunks {st.prefill_chunks_run}; TTFT p50 "
        f"{ttft * 1e3:.1f} ms; TBT p50 {tbt * 1e3:.1f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"e2e: launches {launches} (= {L} layers x steps / chunks)")

    # chunked kernel path vs one-shot plain blockwise prefill, one prompt
    prompt = prompts[int(np.argmax(lens))]
    n = len(prompt)
    kv = PagedKVCache(cfg, -(-n // 16) + 1, 16, device="cuda")
    chunk_ms = []
    for c0 in range(0, n, 512):
        c1 = min(c0 + 512, n)
        t0 = time.perf_counter()
        logits_c, cache = transformer.prefill_chunk(
            params, cfg, {"tokens": [prompt[c0:c1]]}, kv.k_pool, kv.v_pool,
            kv.gather_prefix_indices(0, c0) if c0 else
            torch.zeros((0,), dtype=torch.int32, device="cuda"),
            device="cuda")
        kv.write_prefill_chunk(0, cache["k"][:, 0], cache["v"][:, 0], c0)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    logits_o, _ = transformer.prefill(params, cfg, {"tokens": [prompt]},
                                      max_seq=n, device="cuda")
    torch.cuda.synchronize()
    oneshot_ms = (time.perf_counter() - t0) * 1e3
    log(f"e2e: prompt of {n} tokens: {cfg.num_layers}-layer prefill chunks "
        f"of 512 "
        f"(P = 0, 512, 1024, ...) took {[round(x, 1) for x in chunk_ms]} ms; "
        f"one-shot plain prefill {oneshot_ms:.1f} ms")
    a, b = logits_c.float().flatten(), logits_o.float().flatten()
    cos = float(a @ b / (a.norm() * b.norm()))
    log(f"e2e: chunked (kernel) vs one-shot (plain blockwise) last logits, "
        f"prompt {n} tokens: cosine {cos:.6f} (need >= 0.99); argmax "
        f"{int(a.argmax())} vs {int(b.argmax())}")
    if not cos >= 0.99:
        raise AssertionError(f"chunked vs one-shot cosine {cos} < 0.99")
    result = dict(tok_s=n_out / wall, wall_s=wall, ttft_p50_s=ttft,
                  tbt_p50_s=tbt, peak_gib=peak / 2**30, cosine=cos,
                  decode_steps=st.steps, decode_step_ms_mean=decode_ms,
                  chunks=st.prefill_chunks_run, chunk_ms=chunk_ms,
                  oneshot_prefill_ms=oneshot_ms)
    prof = profile_decode(torch, eng, prompts, Request, SamplingParams, State)
    log(f"e2e: profiled decode-only steps: {json.dumps(prof)}")
    return launches, result


def profile_decode(torch, eng, prompts, Request, SamplingParams, State,
                   n_steps=3):
    """Where a decode step's time goes: a second wave of the same prompts
    is driven until every request decodes, then ``n_steps`` decode-only
    steps (B=8) run under torch.profiler. Reports host wall per step,
    device-busy time per step (sum of kernel self time), the idle share
    and the top kernels. Runs after the launch counts were read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wave = [Request(prompt=p, params=SamplingParams(max_new_tokens=64))
            for p in prompts]
    eng.submit(wave)
    while not all(r.state == State.RUNNING and eng.sched.prefill_done(r.rid)
                  for r in wave):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.cancel_all()
    # device-side events only (kernels, copies): CPU ops' device totals
    # would count the same kernels a second time
    dev = [(e.key, e.self_device_time_total / 1e3 / n_steps)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t in dev)
    step_ms = wall * 1e3 / n_steps
    top = sorted(dev, key=lambda kv: -kv[1])[:6]
    return dict(batch=len(wave), step_ms_profiled=step_ms,
                device_busy_ms=busy,
                idle_share=1 - busy / step_ms if step_ms else None,
                top_kernels_ms={k[:60]: round(v, 3) for k, v in top})


# ---------------------------------------------------------------------------
def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa

    # phase 1: device + build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _cuda.build([pda._LIB_NAME, ppa._LIB_NAME])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    for name, text in _cuda.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    timer = Timer(torch)
    rng = np.random.default_rng(0)
    log(f"tolerance, kernel vs plain twin: |err| <= {ERR_ATOL} + {ERR_RTOL}"
        f" * |plain| elementwise on o (2 bf16 ulp); l rtol 1e-3; m atol 1e-3")

    # phase 2: decode kernel vs plain twin
    lens = rng.integers(1, 2049, size=8).tolist()
    lens[0] = 2048
    dec_main = decode_case(torch, pda, timer, B=8, Hkv=8, G=4, hd=128,
                           bs=16, lens=lens, seed=1)
    log(f"decode llama3-8b B=8 lens={lens}: {json.dumps(dec_main)}")
    r = decode_case(torch, pda, timer, B=8, Hkv=8, G=4, hd=128, bs=16,
                    lens=lens, seed=2, pos_pad=True, library=False)
    log(f"decode POS_PAD slots: {json.dumps(r)}")
    glens = rng.integers(1, 8193, size=4).tolist()
    glens[0] = 8192
    r = decode_case(torch, pda, timer, B=4, Hkv=16, G=2, hd=128, bs=16,
                    lens=glens, seed=3, sliding_window=4095, sinks=4,
                    softcap=50.0)
    log(f"decode gemma2-shaped window=4095 sinks=4 softcap=50 "
        f"lens={glens}: {json.dumps(r)}")

    # phase 3: chunk-prefill kernel vs plain twin
    pre = {}
    for P, C in ((0, 512), (1536, 512), (1024, 300)):
        pre[(P, C)] = prefill_case(torch, ppa, timer, H=32, Hkv=8, hd=128,
                                   bs=16, P=P, C=C, seed=10 + P + C)
        log(f"prefill llama3-8b P={P} C={C}: {json.dumps(pre[(P, C)])}")
    r = prefill_case(torch, ppa, timer, H=32, Hkv=16, hd=128, bs=16,
                     P=4096, C=512, seed=20, sliding_window=4096, sinks=4,
                     softcap=50.0)
    log(f"prefill gemma2-shaped P=4096 C=512 window=4096 sinks=4 "
        f"softcap=50: {json.dumps(r)}")

    del timer
    torch.cuda.empty_cache()
    launches, e2e = end_to_end(torch, np, pda, ppa)
    log(f"e2e: {json.dumps(e2e)}")

    main_pre = pre[(1536, 512)]
    kernels = [
        dict(name="paged_decode_attention", route="cuda", status="ported",
             source="src/repro_torch/csrc/paged_decode_attention.cu",
             replaces="src/repro/kernels/paged_decode_attention.py:55",
             launches=launches["paged_decode_attention"],
             **{k: dec_main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}),
        dict(name="paged_prefill_chunk_attention", route="cuda",
             status="ported",
             source="src/repro_torch/csrc/paged_prefill_attention.cu",
             replaces="src/repro/kernels/paged_prefill_attention.py:54",
             launches=launches["paged_prefill_chunk_attention"],
             **{k: main_pre[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}),
    ]
    todo = [dict(name=n, replaces=r, status="todo") for n, r in TODO_KERNELS]
    log(json.dumps({"kernels": kernels, "todo": todo}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                       # report, no result line
        traceback.print_exc()
        sys.exit(1)
