#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py        # every phase, one card, no arguments

Phases (any failure exits non-zero and prints no result line):
  1. device: card name and power limit, torch/CUDA versions, kernel build;
  2. paged decode kernels (split-KV) vs their plain PyTorch twin on the
     card, bf16 and int8 pools, at llama3-8b's decode shapes (all 8 kv
     heads, one head-partition worker's 4, and a long-context batch of
     16384-32768 tokens), with POS_PAD slots, and a gemma2-shaped window +
     sinks + softcap case; stale blocks hold NaN values (bf16) or NaN
     scales (int8); the int8 kernel is also held against the bf16 twin on
     the unquantized pool (cosine); each timed case beside the same call
     with the card held busy through the enqueue, the host time of one
     call (kernel and SDPA) and the launch grid; ptxas' registers and
     spill of every instantiation are logged with the build; then the
     widened shapes: glm4-9b's G = 16 (main context and 16K), G = 16 at
     hd = 64, kimi-k2's hd = 112 (G = 8 and 4), qwen3-moe's Hkv = 4 at
     G = 8, G = 16 at hd = 112 with window + sinks + softcap, POS_PAD at
     G = 16 (bf16 at G >= 8 runs the tensor-core design);
     ``python3 chip_smoke.py --row1`` builds the paged decode library
     and times row 1 at glm4-9b's shapes on the tensor cores and on the
     lanes (``row1_glm4``);
  3. paged chunk-prefill kernels vs their plain twin, bf16 and int8 (C=512
     at P=0 and P=1536, C=300 at P=1024, a gemma2-shaped masked case),
     with NaN values (bf16) or NaN scales (int8) in the pool blocks the
     table skips; each time beside the same call timed with the card held
     busy through the enqueue, and the host time of one call, for the
     kernel and SDPA; the kernel's launch geometry and the HGMMA count of
     its SASS are logged with the build; then glm4-9b's G = 16 and
     kimi-k2's hd = 112 (P=1536 C=512), hd = 112 over 1- and 2-row TMA
     boxes, and hd = 112 at G = 16 past a 8192 window with sinks;
  4. end to end, homogeneous bf16: llama3-8b at full width and depth
     (random bf16 weights from seed 0) serving 8 requests through
     LLMEngine with chunked prefill, the decode step and the chunk step
     replayed from CUDA graphs; checks kernel launch counts, finishes, and
     the chunked vs one-shot logit cosine; reports the graphs captured
     per program and their capture seconds; serves the 8 requests again
     on the warmed engine (TTFT, launches, captures of that pass); holds
     each compiled prefill program against the eager one
     (``prefill_gates``: bit for bit at the same padded operands, the
     unpadded eager logits at cosine >= 0.999 with the replay's token at
     most 2 bf16 ulps under the eager top logit (a tie), replayed
     and eager walls: chunks of 512 at nb 0/32/64/96 and a partial one,
     one-shot prefills of 662 and 2000 tokens, a suffix of 150 after 512
     shared tokens; a profiled replayed chunk) and counts the device ops
     of one pool write; profiles one eager 512-token prefill chunk and
     decode steps (replays); at the B=8 state holds a compiled step against the eager
     step (``compiled_gates``: bit for bit at the same padded operands,
     two replays in a row, a bucket switch, a pool write between
     replays); serves two requests sharing a 512-token prefix by one-shot
     prefill with and without prefix sharing (equal tokens, the sharing
     counters, the suffix prefill's wall);
  5. end to end, Lamina: the same requests through the attention-pool
     placement (head partition, 2 workers) over an int8 pool; checks the
     int8 kernels' launch counts (and no bf16 launch), the pool's resident
     bytes against phase 4's, and the TransferLog against the §3.1
     formulas; serves them again warmed; profiles decode steps and holds
     the compiled step as in 4, and the int8 chunk and suffix programs
     over an int8 pool;
  6. every partition (head, request, block) and homogeneous placement over
     an int8 and a bf16 pool on 2 requests: next-step logits at one shared
     state (cosine), a compiled step of each against its eager step there
     (bit for bit), per-partition launch counts through replays, token
     agreement, and decode peak memory (the block partition copies no
     pool slice);
  7. (run right after phase 3, with the other kernel phases) the
     dense-cache decode kernel vs its plain twin (o, and the (o, l, m)
     triple) at zamba2's, llama3-8b's and a gemma2-shaped (window, sinks,
     softcap) decode shape, with NaN in every slot past cache_len; the
     chunked Mamba2 and RWKV6 scan kernels vs their step twins at zamba2's
     and rwkv6's prefill shapes (B=8, S=2048), with decays that hold exact
     0 and 1.0, and at a ragged S=2047; the dense decode kernel (beside
     SDPA) and the scans timed unheld and held, with the host time of a
     call; the scans' ptxas lines and the HMMA count of their SASS are
     logged with the build; the dense kernel's widened shapes (glm4-9b's
     G = 16 at 2K and 16K, G = 16 at hd = 64, kimi-k2's hd = 112, a
     windowed hd = 112) in bf16 and through its int8 entry (also at
     llama3-8b's shape), each int8 case also held against the bf16 twin
     on the unquantized cache (cosine), each with its split-KV launch;
     the ``dense_design`` line (the launch and CTAs an SM at glm4-9b's 2K
     and 16K shapes, the HMMA count of the library's SASS, registers and
     spill per instantiation); then every instantiation of the three
     attention kernels (dtype × hd × G) once at a small shape;
  8. end to end through transformer.prefill -> 32 x (decode_step +
     apply_decode_updates): zamba2-1.2b, then rwkv6-7b, at full width and
     depth (random bf16 weights from seed 0, 8 prompts of 2048 tokens):
     launch counts per the path, finite logits, prefill and decode-step
     walls, tokens/s, peak memory, cache bytes, a profiled window of 3
     decode steps and one profiled prefill (device busy, the scan kernel's
     device time);
  9. the card against the CPU at full width and reduced depth (zamba2 with
     4 layers, rwkv6 with 2; B=2, S=128, then 4 decode steps): row cosine
     of every step's logits;
 10. (run after phase 6) fault recovery at full width: llama3-8b on the
     block partition over an int8 pool (2 shards), chunked prefill, the 8
     requests fault-free, then through a shard death at step 12 with a
     rejoin at 30, then through a corrupt partial at step 20 that clears
     on the third attempt (``fault_e2e``): greedy tokens equal the
     fault-free run's, the corrupt attempts bit-identical replays, the
     pool whole after the rejoin, one recovery latency per recovered
     request; recovery latency p50;
 11. (run after phase 10) the disaggregated prefill/decode cluster at
     full width and depth (``cluster_e2e``): (a) one replica over phase
     4's bf16 engine, 8 blocks landed a step, the 8 requests: first
     tokens equal phase 4's cold run's, each handoff's blocks read back
     through the decode table equal its payload bit for bit, the decode
     side's bytes equal the payloads' (2 MiB a block), 8 handoffs, the
     prefill engine launches only the chunk kernel and the decode engine
     only the decode kernel (no chunk, no admit event, no prefill graph),
     the greedy streams equal phase 4's up to a bf16 near-tie; (b)
     Lamina's int8 head engine with prefix sharing on 2 affinity-routed
     replicas of 1024 blocks, 3 groups of 3 requests sharing a 512-token
     prefix: each group on one replica, 6 affinity hits, skipped prefill,
     int8 payloads at 132/256 of the bf16 bytes, only the int8 kernels;
     export / import walls and GB/s over the wire on their own, handoff
     latency (read after a synchronisation), TTFT, TBT, tokens/s, graphs
     per engine, peak memory (with the read-back copies);
 12. (after the llama weights are freed) the serve CLI in process:
     ``repro_torch.launch.serve.main`` in router mode, 2 Lamina int8
     replicas with prefix sharing on 8 azure-conv requests at scale 0.5,
     with weights of its own; its summary lines are logged;
 13. glm4-9b at full width and depth (40 layers, d 4096, 32 / 2 heads:
     G = 16, vocab 151552; random bf16 weights from seed 0) through
     LLMEngine with compiled graphs, 8 requests: (a) homogeneous bf16,
     (b) attention_pool head over 2 workers on an int8 pool, (c) the
     block partition over 4 workers, bf16: every request finishes, the
     launches = L × steps × workers and L × chunks, (c)'s greedy streams
     equal (a)'s up to a bf16 near-tie, the TransferLog equals the §3.1
     formulas, the int8 pool holds (hd + 4)/(2·hd) of the bf16 bytes;
     TTFT, TBT, tokens/s, peak GiB. (d) glm4-9b-sinks (window 8192, 4
     sinks; the same weights): one request of 9216 prompt tokens and 16
     decode steps; at the last step one layer's decode attention and one
     chunk's attention over the real pool equal their plain twins;
 14. the dense-cache path at glm4-9b's width (its weights still loaded):
     ``AttentionWorkerPool.attend``, head and request over 2 workers each,
     over one dense bf16 cache and one int8 cache (B=8, S=4096): the
     partitions agree with each other and with the plain twins on the CPU,
     ``per_worker_kv_bytes`` = the reference formula; ``prefill`` ->
     ``decode_step`` -> ``apply_decode_updates`` over an int8 dense cache
     with the first 4 layers: cosine >= 0.999 to the bf16 forward and the
     same argmax; the listed layout's steps = the stacked ones bit for
     bit; then ``decode_step`` at full depth (40 layers) over a bf16 and
     an int8 dense cache of B=8 sequences of 1-2048 tokens, timed: step
     wall p50 over 10 steps, device-busy ms and idle share of a profiled
     window, the dense kernel's device ms a step (``dense_step_timing``;
     ``python3 chip_smoke.py --dense-step OTHER/src`` runs this step alone
     on another checkout's port, e.g. a parent commit's);
 15. llama3-70b at full width and 8 of 80 layers through LLMEngine,
     attention_pool head over 4 workers on an int8 pool; pixtral-12b at
     full width and 8 layers through ``prefill`` with 1024 frontend
     embeddings and 8 ``decode_step`` s; tinyllama-1.1b at full width and
     depth, homogeneous bf16: every request finishes, launch counts hold;
 16. greedy speculative decoding: llama3-8b at full width and 4 layers as
     the target, its first layer as the draft: the tokens equal plain
     greedy decoding up to a bf16 near-tie; ``SpecStats``;
 17. the moe family through LLMEngine (``moe_e2e``): qwen3-moe-30b-a3b at
     full width and depth (48 layers, 128 experts top-8, 32 / 4 heads:
     G = 8; random bf16 weights from seed 0, capacity factor 1.25), 8
     requests of 128-2048 prompt tokens (lengths the routing groups
     divide) and 32 greedy tokens: (a) homogeneous bf16, (b) moe_offload
     with attention head × 2 and experts on 2 workers over an int8 pool.
     Prompts run one-shot (no chunk launch, ``prefill_chunks_run == 0``);
     decode launches per step; (b)'s streams equal (a)'s up to a bf16
     near-tie; (b)'s attention wire log = the §3.1 formula and its expert
     wire log = ``transfer_bytes_moe`` per decode token; at a B=8 state a
     replayed MoE decode step = its eager step bit for bit
     (``compiled_gates``) and every MoE layer's output on the card vs the
     CPU at cosine >= 0.999; the one-shot program at 200 and 1536 tokens
     (eager, no graph) = the unpadded eager prefill bit for bit; a
     profiled decode window (device busy against the expert weights' byte
     floor); the dense-cache ``prefill`` -> 2 ``decode_step`` s over a
     bf16 and an int8 cache (row 5 launches L a step; logits vs the plain
     twin's step at cosine >= 0.999); how often a moe prompt length
     recurs in the traces (host arithmetic). (c) kimi-k2 at
     full width (d 7168, 384 experts, 64 / 8 heads, hd = 112) and 1 of 61
     layers, homogeneous bf16, 4 requests of 16 tokens: launches, finished
     streams;
 18. gemma2-27b at full width and depth (46 layers; local window 4096 /
     global layers, softcaps, post-norms, tied embeddings) through
     LLMEngine with chunked prefill, 8 requests of 300-2000 tokens and one
     of 6144, 32 new: (a) homogeneous bf16, then, on its warmed engine at
     a decode state of the 6144-token request, the decode and chunk
     attention over the real pool against their plain twins for a local
     and a global layer (the window bites); (b) attention_pool head × 2
     over an int8 pool: launches, the TransferLog, (b)'s streams against
     (a)'s up to a bf16 near-tie;
 19. seamless-m4t-medium at full width and depth (``audio_e2e``: 12
     encoder and 12 decoder layers, d 1024, 16 / 16 heads of 64, d_ff
     4096, vocab 256206; random bf16 weights from seed 0): B=8 stub frame
     sequences of S_enc = 512, then 2048 rows, decoder prompts of 8
     tokens, ``prefill`` then 64 greedy ``decode_step`` +
     ``apply_decode_updates``: row 5 launches 24 times a step (12 self,
     12 cross over every encoder row) and none in the prefill; each
     step's logits against the same step with row 5's plain twin (cosine
     >= 0.999, the same argmax or a NEAR_TIE_ULPS tie); the listed
     layout's first step = the stacked one bit for bit; prefill wall,
     step wall p50, a profiled window, peak memory, cross-KV bytes; row 5
     at the cross shape (B=8, Hkv=16, G=1, hd=64, 2048 rows) against its
     twin, timed unheld and held beside SDPA on the same cache and its
     bound; the card against the CPU at 2 + 2 layers;
 20. the analytic core (``analytic_e2e``): (a) llama3-8b's block (full
     width, fp32 weights from seed 0) as the converter's graph at batch
     8, split at its attention (= the CPU port's slices, programs, sends,
     cut bytes 8·4096·2), run sliced with an attention callback that
     appends the step's k/v to a dense bf16 cache of 2047 tokens and
     launches row 5: residual2 = the unsliced order bit for bit, the
     callback's output vs the plain twin (cosine); (b) ``run_rotational``
     over 4 batches of 8: each = its direct run bit for bit, replica =
     (j + k) mod 3; (c) printed, not gated: ``mtime`` / ``atime`` on
     ``h100`` at efficiency 1.0 for llama3-8b at B=8 and phase 4's mean
     prompt length beside phase 4's profiled GEMM, decode-kernel and
     busy time a step; llama3-70b's ``minimum_bandwidth``,
     ``estimate_vllm`` and ``estimate_lamina`` at DOP (2, 4); qwen3-moe's
     ``min_bandwidth_moe`` at (128, 8192);
 21. training (``train_e2e``): (a) tinyllama-1.1b at full width and
     depth (bf16 weights from seed 0), 30 steps of B=8 x S=512
     ``packed_batches`` through ``train_loop.train`` (AdamW lr 1e-3, 5
     warmup steps): step wall p50, tokens/s, peak memory, the loss at
     steps 1 and 30 (it must fall), the model-FLOPs share of 989 TFLOP/s
     (6·N·T, remat's recompute 2·N·T beside it) and one profiled step;
     then 15 steps, a checkpoint, a restore and 15 more on the same
     batches = the uninterrupted run bit for bit; (b) one batch's loss and
     every gradient at 2 of 22 layers in fp32 against the CPU port; (c)
     zamba2-1.2b at full width and depth and rwkv6-7b at 8 of 32 layers,
     B=4 x S=2048, 5 steps each: the scans' forward kernels launch twice
     a remat unit's layer (forward and recompute) and their backward
     kernels once a layer; at 2 layers a step's gradients through the
     kernels against the plain twins on the card (zamba2 fp32, rwkv6 bf16
     and fp32); (d) each backward kernel against its plain backward at
     the forward's main shape (B=8, S=2048, H=64, P=N=64; row 7 in bf16
     and fp32), two calls bit for bit, ragged S and exact 0 / 1.0 decays,
     timed held and unheld beside its bound and the plain twin; (e) one
     smoke-size fp32 train step of each of the 10 assigned archs on the
     card against the CPU port (loss, gradient norm);
 22. the mesh and the collective attention backends: (a) 4 spawned
     ranks of one gloo world sharing the card (NCCL refuses two ranks on
     one device) drive ``core/attention_parallel.py``'s paged splits at
     llama3-8b's attention width (pool of 2048 blocks of 16, 4 block
     shards, 8 sequences of 300-2000 tokens, bf16 and int8): head on a
     (2, 2) mesh with the batch over data, head x 4, request x 2 and x 4,
     block x 4, and glm4-9b's G = 16 through head x 2 and block x 4; and
     the dense seq / head / request splits x 4 on a (8, 2048, 8, 128)
     bf16 cache. Each rank's row 1 / 3 launches, the bytes it hands to
     the all-reduces (the triple's for block and seq, none for head and
     request) and the count of every other collective it issues
     (``CommDebugMode``: none) are gated, so KV never crosses ranks;
     head and request equal
     the in-process partition over the same slices bit for bit, block and
     seq are within 2 bf16 ulps of the in-process block partition (whole
     cache) and of one launch over the whole pool, every split within 2
     bf16 ulps of ``AttentionWorkerPool.attend_paged``; per-call wall p50
     beside the in-process pool's is printed. (b) the placed train step
     on a (1, 1) mesh (NCCL, world size 1): tinyllama-1.1b at full width
     and 2 layers, 3 steps, equal to ``make_train_step``'s eager steps bit
     for bit in the loss and every leaf, every leaf still placed;
     ``python3 chip_smoke.py --phase22`` runs it alone after the build;
 23. the dry run on fake CUDA tensors (``dryrun_e2e``): (a) every kernel
     entry (rows 1-7, 5-int8, 6-bwd, 7-bwd) at a shape phase 2, 3 or 7
     runs: its real launch, then its shape-only face on fake copies of the
     operands: the same output shapes, dtypes and strides and the same
     reported FLOPs and bytes, no launch, no fake tensor among the stream
     tickets; (b) the memory proof: tinyllama-1.1b's phase 21 (a) step
     traced on a (1, 1) mesh against phase 21 (a)'s measured peak (with
     what that phase holds beside its steps: what earlier phases left
     allocated and its copy of the initial weights) and against one real
     step's peak, and
     the reference test's decode_32k config (2 layers, vocab 2048, B=128,
     S=32768) against one real ``decode_step``'s peak, each within 10 %;
     (c) each traced step's FLOPs equal to the same counting mode's count
     over the real step (6·N·T and 8·N·T printed beside); (d) the
     production sweep on the (16, 16) mesh, the dense family at every
     applicable shape and every other arch at decode_32k
     (``DRY_SWEEP_JOBS`` records at a time, each a ``python -m
     repro_torch.launch.dryrun`` process of its own, ``dryrun.sweep``,
     at the lowest priority, started after phase 18 so it runs beside
     phases 19-23 (c)), and llama3-8b decode_32k on
     (2, 16, 16): per-chip GiB, fits in 80 GB,
     dominant term and seconds a record, then roofline.py's tables; the
     dense family (tinyllama-1.1b, llama3-8b) must be traced ok and no
     record may launch a kernel. Records and the sweep's log go to
     ``build/dryrun/``;
 24. the long_500k configuration (``long_e2e``: one sequence of 524,288
     tokens at B = 1): (a) rows 1, 3 (full context; window 8192; glm4-9b-
     sinks' G = 16 at the 256-split cap), 4 and 2 (a 512-token chunk at P
     = 523,776, window 8192), 5 (zamba2's shared attention, no window;
     glm4-9b-sinks), 5-int8 (llama3-8b-sw8k) and 7 (rwkv6-7b, B·S·H·P =
     2^31, against ``rwkv6_scan_chunked_plain``) against their plain twins
     with NaN values or scales in every slot outside the live range, timed
     unheld and held beside their bounds and SDPA; (b) the dry run's
     ``serve_step`` (``build_lowering_spec(arch, "long_500k")``) at full
     width and depth for zamba2-1.2b, glm4-9b-sinks, llama3-8b-sw8k over
     an int8 dense cache and rwkv6-7b, from a cache filled from a seed at
     524,280 tokens (NaN past it): 8 steps + ``apply_decode_updates``,
     each against the same step with row 5's plain twin (every row 5 call
     of the step within 2 bf16 ulps of its twin on its own operands and
     at a cosine >= 0.999, its largest ulp error printed; the logits'
     cosine within max(0.001, the distance one bf16 ulp on row 5's
     outputs moves the twin step); argmax or a tie), row 5 launches
     counted each step, step wall p50, a profiled window of
     3 steps at the full cache (row 5's ms beside its byte bound), peak
     memory, cache bytes = the formula; rwkv6-7b's one-shot prefill of
     262,144 tokens (``LONG_PREFILL_S``); (c) llama3-8b-sw8k through
     LLMEngine, attention_pool head x 2 over an int8 pool of 32,776
     blocks: one request of 524,256
     tokens chunk-prefilled by 512 and 32 greedy tokens (launches, the
     TransferLog, resident bytes, the last step's decode and last chunk's
     attention over the real pool against their twins; TTFT split into
     eager, capture and replay seconds, TBT p50, peak); (d) each (b)
     record traced on a (1, 1) mesh within 10 % of one real step's peak,
     and llama3-8b-sw8k's bf16 record beside the card's memory.
     ``python3 chip_smoke.py --phase24`` runs it alone after the build;
 25. one JSON line describing every ported kernel, then the result line.
     A failed gate of phases 4, 5, 10, 11 and 13-24 is reported where it
     happens and fails the run after the last phase. No two full-width
     models are alive at once.

It imports nothing of JAX or of the JAX package, and exits non-zero
without a CUDA device or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 on the CUDA cores
ERR_RTOL, ERR_ATOL = 8e-3, 1e-3   # bf16 outputs: 2 ulp relative + floor
# the chunked scan kernels vs their fp32 step twins: every tensor-core
# product runs three bf16 passes (hi + lo, ~1e-5 of each product); over
# 2048 steps the outputs agree to within 1.3e-5 of their scale (H100 runs)
SCAN_RTOL = 1e-4               # and atol = SCAN_RTOL * max |plain|
MIN_COSINE = 0.999             # int8 vs full precision; placements; card
                               # vs CPU logits

KERNELS = {   # name -> (source, TPU kernel it replaces)
    "paged_decode_attention": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:55"),
    "paged_prefill_chunk_attention": (
        "src/repro_torch/csrc/paged_prefill_attention.cu",
        "src/repro/kernels/paged_prefill_attention.py:54"),
    "paged_decode_attention_int8": (
        "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:119"),
    "paged_prefill_chunk_attention_int8": (
        "src/repro_torch/csrc/paged_prefill_attention.cu",
        "src/repro/kernels/paged_prefill_attention.py:128"),
    "decode_attention": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:31"),
    # the int8 entry of the same kernel: the reference runs int8 dense
    # caches through its jnp partial (models/attention.py:175); the Pallas
    # kernel it extends takes no scales
    "decode_attention_int8": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:31"),
    "ssm_scan": (
        "src/repro_torch/csrc/ssm_scan.cu",
        "src/repro/kernels/ssm_scan.py:20"),
    "rwkv6_scan": (
        "src/repro_torch/csrc/rwkv6_scan.cu",
        "src/repro/kernels/rwkv6_scan.py:22"),
    # the scans' backward kernels replace no TPU kernel: the reference
    # differentiates the lax.scan named here (models/ssm.py, its training
    # path); the port's forward is a kernel, so its gradient is one too
    "ssm_scan_bwd": (
        "src/repro_torch/csrc/ssm_scan.cu",
        "src/repro/models/ssm.py:117"),
    "rwkv6_scan_bwd": (
        "src/repro_torch/csrc/rwkv6_scan.cu",
        "src/repro/models/ssm.py:280"),
}


# the dense-cache decode and scan kernels launch on none of LLMEngine's paths
# (nor do the scans' backward kernels on any serving path: no gradient)
NO_NEW_KERNEL = {"decode_attention": 0, "decode_attention_int8": 0,
                 "ssm_scan": 0, "rwkv6_scan": 0, "ssm_scan_bwd": 0,
                 "rwkv6_scan_bwd": 0}
# nor does a paged kernel on the dense-cache / recurrent path (whose caches
# are bf16: the int8 dense entry runs only on phase 14's int8 dense cache)
NO_PAGED_KERNEL = {"paged_decode_attention": 0,
                   "paged_prefill_chunk_attention": 0,
                   "paged_decode_attention_int8": 0,
                   "paged_prefill_chunk_attention_int8": 0,
                   "decode_attention_int8": 0, "ssm_scan_bwd": 0,
                   "rwkv6_scan_bwd": 0}


def log(*a):
    print(*a, flush=True)


# gates of this run that failed; main raises after the last phase, so one
# run reports every phase (the run still exits non-zero, no result line)
FAILED = []


def gate(ok, what):
    if not ok:
        FAILED.append(what)
        log(f"GATE FAILED: {what}")
    return bool(ok)


def sync(torch):
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# launch counters, timing, checks
# ---------------------------------------------------------------------------
class Launches:
    """The kernel wrappers' launch counters: zeroed just before a path is
    driven, read just after it."""

    def __init__(self, pda, ppa, da, ssm, rwkv):
        self.fns = {"paged_decode_attention": pda.paged_decode_attention,
                    "paged_prefill_chunk_attention":
                        ppa.paged_prefill_chunk_attention,
                    "paged_decode_attention_int8":
                        pda.paged_decode_attention_int8,
                    "paged_prefill_chunk_attention_int8":
                        ppa.paged_prefill_chunk_attention_int8,
                    "decode_attention": da.decode_attention,
                    "decode_attention_int8": da.decode_attention_int8,
                    "ssm_scan": ssm.ssm_scan,
                    "rwkv6_scan": rwkv.rwkv6_scan,
                    "ssm_scan_bwd": ssm.ssm_scan_bwd,
                    "rwkv6_scan_bwd": rwkv.rwkv6_scan_bwd}

    def reset(self):
        for fn in self.fns.values():
            fn.launches = 0

    def read(self):
        return {k: fn.launches for k, fn in self.fns.items()}


class Timer:
    """Median per-call device time with a cold L2 before every call (the
    main path reads a different layer's pool slice each call), from an
    event recorded after the 128 MB flush to one after the call: a call
    whose host enqueue outlasts the flush is charged the gap. This is the
    time every kernel row reports. With ``hold=True`` the card first spins
    ~0.1 ms after the flush, so the enqueue lands while it is busy and only
    device time is counted (reported beside it as ``ms_held``)."""

    HOLD_CYCLES = 200_000          # ~0.1 ms at the H100's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)

    def ms(self, fn, iters=15, warmup=2, hold=False):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            if hold:
                torch.cuda._sleep(self.HOLD_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]

    def host_us(self, fn, calls=50):
        """Host time to enqueue one call (µs), the mean over ``calls``
        back-to-back calls that never wait for the card."""
        fn()
        sync(self.torch)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t0
        sync(self.torch)
        return t / calls * 1e6


def bound(nbytes, flops, flop_per_s=BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
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


def cosine(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return float(a @ b / (a.norm() * b.norm()))


# bf16 logits tie often: two equivalent paths (padded and unpadded
# operands, recomputed and decode-written K/V) differ by bf16 rounding
# (row cosine ~0.99997 on this card), which flips an argmax only where
# the top logits lie within a few bf16 ulps of each other
NEAR_TIE_ULPS = 2


def bf16_ulp(x):
    """The spacing of bf16 values at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def gap_ulps(logits, token):
    """How far below the top of ``logits`` (one row) ``token``'s logit
    lies, in bf16 ulps of the top logit (0 for the argmax itself)."""
    row = logits.float().flatten()
    top = float(row.max())
    return (top - float(row[token])) / bf16_ulp(top)


def quantize_pool(torch, pool):
    """A float pool (Hkv, NB, bs, hd) as int8 values + fp32 scales (Hkv,
    NB, bs) — what PagedKVCache stores for it."""
    from repro_torch.models.kv_quant import quantize_kv
    return quantize_kv(pool)


# ---------------------------------------------------------------------------
# phase 2: paged decode
# ---------------------------------------------------------------------------
def decode_case(torch, pda, timer, *, B, Hkv, G, hd, bs, lens, seed,
                int8=False, sliding_window=0, sinks=0, softcap=0.0,
                pos_pad=False, library=True):
    """The paged decode kernel vs its twin; every slot no mask keeps (past
    cache_len, in free blocks, outside the window and sinks) holds NaN
    values (bf16) or NaN scales (int8)."""
    from repro_torch.kernels import _cuda
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nbs = [-(-n // bs) for n in lens]
    nb = max(nbs)
    NB = sum(nbs) + 9
    shape = (Hkv, NB, bs, hd)
    k_pool = torch.randn(shape, generator=gen, device=DEV).bfloat16()
    v_pool = torch.randn(shape, generator=gen, device=DEV).bfloat16()
    stale = torch.zeros((NB, bs), dtype=torch.bool, device=DEV)
    stale[0] = True                        # a free block full of NaN ...
    perm = torch.randperm(NB - 1, generator=gen, device=DEV) + 1
    tables = torch.zeros((B, nb), dtype=torch.int32, device=DEV)  # ... pad
    used = 0
    for i, n in enumerate(nbs):
        tables[i, :n] = perm[used:used + n].int()
        used += n
        stale[int(tables[i, n - 1]), lens[i] - (n - 1) * bs:] = True
        if sliding_window:
            slot = (torch.arange(n, device=DEV)[:, None] * bs +
                    torch.arange(bs, device=DEV))
            out_w = (slot < lens[i] - sliding_window) & (slot >= sinks)
            stale[tables[i, :n].long()] |= out_w
    k_pool[:, stale] = float("nan")        # stale NaN past cache_len
    v_pool[:, stale] = float("nan")
    q = torch.randn((B, Hkv, G, hd), generator=gen, device=DEV).bfloat16()
    cache_len = torch.tensor(lens, dtype=torch.int32, device=DEV)
    positions = None
    if pos_pad:     # a block-sharded table: foreign slots carry POS_PAD
        base = torch.arange(nb, dtype=torch.int32, device=DEV) * bs
        positions = base[None].repeat(B, 1).contiguous()
        positions[:, 1::2] = pda.POS_PAD
        tables[:, 1::2] = 0                # ... and point at the NaN block
    kw = dict(block_positions=positions, sliding_window=sliding_window,
              attention_sinks=sinks, logit_softcap=softcap,
              return_partials=True)
    pools = (k_pool, v_pool)
    if int8:
        # stale rows' NaN values quantize to NaN scales; every stale scale
        # is NaN: the kernel must never load them
        kq, ks = quantize_pool(torch, k_pool)
        vq, vs = quantize_pool(torch, v_pool)
        ks[:, stale] = float("nan")
        vs[:, stale] = float("nan")
        pools = (kq, vq)
        kw.update(k_scale=ks, v_scale=vs)
    o, l, m = pda.paged_decode_attention(q, *pools, tables, cache_len, **kw)
    sync(torch)
    po, pl, pm = pda.paged_decode_attention_plain(q, *pools, tables,
                                                  cache_len, **kw)
    err = check_close("decode o", o, po)
    check_close("decode l", l, pl, rtol=1e-3, atol=1e-6)
    check_close("decode m", m, pm, rtol=0.0, atol=1e-3)
    out = {}
    if int8:   # the int8 kernel against the bf16 twin on the unquantized pool
        full = {k: v for k, v in kw.items() if k not in ("k_scale",
                                                         "v_scale")}
        fo = pda.paged_decode_attention_plain(q, k_pool, v_pool, tables,
                                              cache_len, **full)[0]
        out["cosine_vs_bf16"] = cosine(o, fo)
        if not out["cosine_vs_bf16"] >= MIN_COSINE:
            raise AssertionError(f"int8 decode vs bf16 cosine "
                                 f"{out['cosine_vs_bf16']} < {MIN_COSINE}")
    # rows the masks keep (the data-dependent work of this run)
    pos = (torch.arange(nb, device=DEV)[:, None] * bs +
           torch.arange(bs, device=DEV)).reshape(-1)
    valid = pos[None] < cache_len[:, None]
    if positions is not None:
        valid &= (positions[:, :, None] < pda.POS_PAD).expand(
            B, nb, bs).reshape(B, -1)
    if sliding_window:
        valid &= (pos[None] >= cache_len[:, None] - sliding_window) | \
            (pos[None] < sinks)
    rows = int(valid.sum())
    H = Hkv * G
    row_bytes = (hd + 4) * 2 if int8 else hd * 2 * 2   # K + V (+ scales)
    nbytes = (rows * Hkv * row_bytes + q.numel() * 2 + tables.numel() * 4 +
              (0 if positions is None else positions.numel() * 4) +
              B * 4 + o.numel() * 2 + 2 * l.numel() * 4)
    flops = 4 * rows * H * hd          # QK + PV, per kept (row, query head)
    bound_ms, bound_by = bound(nbytes, flops)

    def kernel():
        return pda.paged_decode_attention(q, *pools, tables, cache_len, **kw)
    kernel_ms = timer.ms(kernel)
    timing = dict(ms_held=timer.ms(kernel, hold=True),
                  host_us=timer.host_us(kernel))
    plain_ms = timer.ms(lambda: pda.paged_decode_attention_plain(
        q, *pools, tables, cache_len, **kw), iters=5)
    library_ms = None
    if library and softcap == 0.0:
        # yardstick only: SDPA over pre-gathered (and, for int8,
        # pre-dequantized) dense K/V; the gather and dequant are not timed
        kc, vc = pda.paged_gather_dense(*pools, tables)
        if int8:
            kc = (kc.float() * pda.paged_gather_scales(
                ks, tables)[..., None]).bfloat16()
            vc = (vc.float() * pda.paged_gather_scales(
                vs, tables)[..., None]).bfloat16()
        kc = torch.where(valid[:, None, :, None], kc, 0).repeat_interleave(
            G, dim=1)
        vc = torch.where(valid[:, None, :, None], vc, 0).repeat_interleave(
            G, dim=1)
        qd = q.reshape(B, H, 1, hd)
        mask = valid[:, None, None, :]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qd, kc, vc, attn_mask=mask)
        library_ms = timer.ms(library)
        timing.update(library_ms_held=timer.ms(library, hold=True),
                      library_host_us=timer.host_us(library))
        del kc, vc
    out.update(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               rows=rows, **timing,
               launch=pda.launch_geometry(B, Hkv, nb,
                                          _cuda.sm_count(q.device), G,
                                          int8))
    return out


def ptxas_summary(text, marker, names):
    """Registers, shared memory and spill of every instantiation in nvcc's
    -Xptxas=-v output of a kernel whose mangled name holds ``marker``, one
    line each, labelled by its template arguments: the element type (int8,
    bf16, f32; none for the Mamba2 scan), then its integer ones under
    ``names`` (("hd", "G") for paged decode, ("N", "W") for the Mamba2
    scan, ("P", "W") for RWKV6)."""
    types = {"a": "int8 ", "13__nv_bfloat16": "bf16 ", "f": "f32 "}
    rows, name, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if marker in line else None
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            t, ints = re.match(r"(a|13__nv_bfloat16|f)?((?:Li\d+E)+)",
                               name.split(marker, 1)[1]).groups()
            args = " ".join(f"{n}={v}" for n, v in
                            zip(names, re.findall(r"Li(\d+)E", ints)))
            rows.append(f"{types.get(t, '')}{args}: "
                        f"{line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return rows


def sass_count(lib_name, opcode, function=None):
    """How many instructions of ``opcode`` (e.g. HMMA, HGMMA) the SASS of a
    built kernel library holds, from the build toolkit's cuobjdump; with
    ``function``, only in the functions whose mangled name holds it."""
    from repro_torch.kernels import _cuda
    tool = Path(_cuda._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "--dump-sass",
                           str(_cuda._target(lib_name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    n, inside = 0, function is None
    for line in sass.splitlines():
        if function is not None and "Function : " in line:
            inside = function in line
        n += inside and opcode in line
    return n


# ---------------------------------------------------------------------------
# phase 3: paged chunk prefill
# ---------------------------------------------------------------------------
def prefill_case(torch, ppa, timer, *, H, Hkv, hd, bs, P, C, seed,
                 int8=False, sliding_window=0, sinks=0, softcap=0.0,
                 plain_iters=5):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nb = P // bs
    NB = nb + 5
    shape = (Hkv, NB, bs, hd)
    k_pool = torch.randn(shape, generator=gen, device=DEV).bfloat16()
    v_pool = torch.randn(shape, generator=gen, device=DEV).bfloat16()
    table = (torch.randperm(NB, generator=gen, device=DEV)[:nb]).int()
    unref = torch.ones(NB, dtype=torch.bool, device=DEV)
    unref[table.long()] = False            # the 5 blocks the table skips
    q = torch.randn((C, H, hd), generator=gen, device=DEV).bfloat16()
    kc = torch.randn((C, Hkv, hd), generator=gen, device=DEV).bfloat16()
    vc = torch.randn((C, Hkv, hd), generator=gen, device=DEV).bfloat16()
    kw = dict(sliding_window=sliding_window, attention_sinks=sinks,
              logit_softcap=softcap)
    pools = (k_pool, v_pool)
    if int8:
        kq, ks = quantize_pool(torch, k_pool)
        vq, vs = quantize_pool(torch, v_pool)
        ks[:, unref] = float("nan")        # the kernel must never load them
        vs[:, unref] = float("nan")
        pools = (kq, vq)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        k_pool[:, unref] = float("nan")    # the kernel must never load them
        v_pool[:, unref] = float("nan")
    out = ppa.paged_prefill_chunk_attention(q, *pools, table, kc, vc, **kw)
    sync(torch)
    ref = ppa.paged_prefill_chunk_attention_plain(q, *pools, table, kc, vc,
                                                  **kw)
    err = check_close("prefill out", out, ref)
    pos_q = P + torch.arange(C, device=DEV)[:, None]
    pos_k = torch.arange(P + C, device=DEV)[None, :]
    valid = pos_k <= pos_q
    if sliding_window:
        valid &= (pos_k > pos_q - sliding_window) | (pos_k < sinks)
    pairs = int(valid.sum())                  # per query head
    kept = int(valid[:, :P].any(0).sum())     # prefix rows the masks keep
    row_bytes = (hd + 4) * 2 if int8 else hd * 2 * 2
    nbytes = (2 * (q.numel() + kc.numel() + vc.numel() + out.numel()) +
              kept * Hkv * row_bytes + nb * 4)
    flops = 4 * pairs * H * hd
    bound_ms, bound_by = bound(nbytes, flops)
    def kernel():
        return ppa.paged_prefill_chunk_attention(q, *pools, table, kc, vc,
                                                 **kw)
    kernel_ms = timer.ms(kernel, iters=9)
    timing = dict(ms_held=timer.ms(kernel, iters=9, hold=True),
                  host_us=timer.host_us(kernel))
    plain_ms = timer.ms(lambda: ppa.paged_prefill_chunk_attention_plain(
        q, *pools, table, kc, vc, **kw), iters=plain_iters,
        warmup=min(plain_iters, 2))
    library_ms = None
    if softcap == 0.0:
        kp, vp = ppa.gather_prefix_dense(*pools, table)
        if int8:   # pre-dequantized; the dequant is not timed
            kp = (kp.float() * ppa.gather_prefix_scales(
                ks, table)[..., None]).bfloat16()
            vp = (vp.float() * ppa.gather_prefix_scales(
                vs, table)[..., None]).bfloat16()
        G = H // Hkv
        kd = torch.cat([kp, kc]).permute(1, 0, 2).repeat_interleave(
            G, dim=0)[None]
        vd = torch.cat([vp, vc]).permute(1, 0, 2).repeat_interleave(
            G, dim=0)[None]
        qd = q.permute(1, 0, 2)[None]
        library_ms = timer.ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=valid[None, None]), iters=9)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=valid[None, None])
        timing.update(library_ms_held=timer.ms(library, iters=9, hold=True),
                      library_host_us=timer.host_us(library))
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                prefix_rows_kept=kept, **timing)


def prefill_design(ppa):
    """The chunk kernel's launch at the main shape (C=512, H=32, Hkv=8,
    hd=128) and the count of HGMMA (wgmma) instructions in its library's
    SASS; raises if there is none (the tensor-core path is missing)."""
    geo = {tag: ppa.launch_geometry(512, 32, 8, 128, int8=tag == "int8")
           for tag in ("bf16", "int8")}
    hgmma = sass_count(ppa._LIB_NAME, "HGMMA")
    if not hgmma:
        raise AssertionError("no HGMMA in the chunk kernel's SASS")
    return json.dumps({"launch_at_C512_H32_Hkv8_hd128": geo,
                       "hgmma_instructions_in_sass": hgmma})


# ---------------------------------------------------------------------------
# phases 4-6: end to end
# ---------------------------------------------------------------------------
def make_requests(prompts, new_tokens):
    from repro_torch.serving import Request, SamplingParams
    return [Request(prompt=list(p), params=SamplingParams(
        max_new_tokens=new_tokens)) for p in prompts]


def serve(torch, eng, reqs, counters):
    """Drive one engine over ``reqs`` with the launch counters zeroed just
    before and read just after. Returns (launches, wall s, peak bytes)."""
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    eng.submit(reqs)
    eng.run()
    sync(torch)
    wall = time.perf_counter() - t0
    return counters.read(), wall, torch.cuda.max_memory_allocated()


def check_finished(cfg, reqs, n):
    from repro_torch.serving import State
    if not all(r.state == State.FINISHED and len(r.output) == n
               for r in reqs):
        raise AssertionError(f"not every request finished with {n} tokens: "
                             f"{[len(r.output) for r in reqs]}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError("sampled token outside the vocabulary")


def expect_launches(launches, want, what):
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} != {want}")
    log(f"{what}: launches {launches} as expected")


def serving_summary(st, reqs, wall, peak, compiled=None, prefill=None):
    n_out = sum(len(r.output) for r in reqs)
    times = sorted(st.step_times)
    out = dict(tok_s=n_out / wall, wall_s=wall,
               ttft_p50_s=st.ttft_percentiles()["p50"],
               tbt_p50_s=st.tbt_percentiles()["p50"],
               peak_gib=peak / 2**30, decode_steps=st.steps,
               decode_step_ms_mean=sum(times) / len(times) * 1e3,
               decode_step_ms_p50=times[len(times) // 2] * 1e3,
               chunks=st.prefill_chunks_run,
               kv_pool_bytes_resident=st.kv_pool_bytes_resident,
               kv_bytes_read_per_step=st.kv_bytes_read_per_step)
    if compiled is not None:
        out.update(compiled_stats(compiled))
    if prefill is not None:
        out["prefill_graphs"] = prefill_stats(prefill)
    return out


def prefill_stats(comp):
    """``compiled_stats`` of each compiled prefill program (chunk,
    one-shot, suffix)."""
    return {kind: compiled_stats(g) for kind, g in comp.programs().items()}


def warm_pass(torch, cfg, eng, prompts, counters, want, what):
    """The same requests again on the warmed engine: launches per the path
    (``want(steps, chunks)``), TTFT p50 of this pass, and the graphs the
    pass captured and replayed per program."""
    st = eng.stats
    progs = dict(eng.compiled_prefill.programs(), decode=eng.compiled)
    before = {k: (g.captures, g.replays) for k, g in progs.items()}
    steps0, chunks0 = st.steps, st.prefill_chunks_run
    n_ttft, n_tbt = len(st.request_ttfts), len(st.request_tbts)
    reqs = make_requests(prompts, 32)
    launches, wall, peak = serve(torch, eng, reqs, counters)
    check_finished(cfg, reqs, 32)
    steps, chunks = st.steps - steps0, st.prefill_chunks_run - chunks0
    expect_launches(launches, want(steps, chunks),
                    f"{what} ({steps} steps / {chunks} chunks)")
    out = dict(wall_s=wall, tok_s=sum(len(r.output) for r in reqs) / wall,
               ttft_p50_s=st._pcts(st.request_ttfts[n_ttft:])["p50"],
               tbt_p50_s=st._pcts(st.request_tbts[n_tbt:])["p50"],
               peak_gib=peak / 2**30, chunks=chunks, decode_steps=steps,
               **{f"{k}_captures": g.captures - before[k][0]
                  for k, g in progs.items()},
               **{f"{k}_replays": g.replays - before[k][1]
                  for k, g in progs.items()})
    log(f"{what}: {json.dumps(out)}")
    return out


def median_wall(torch, fn, n=5):
    """Median synchronized wall of ``fn()`` in ms."""
    ts = []
    for _ in range(n):
        sync(torch)
        t0 = time.perf_counter()
        fn()
        sync(torch)
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[n // 2]


def prefill_gates(torch, cfg, params, kv, counters, kernel, rid=0,
                  oneshot=True):
    """A fresh ``CompiledPrefill`` over ``kv`` (sequence ``rid`` holds at
    least 1536 prompt tokens) against the eager programs: each replay
    equals the program run eagerly at the same padded operands bit for
    bit (warm-up and two replays); a padded replay's logits against the
    eager program on unpadded operands (the engine's path before the
    graphs): row cosine >= MIN_COSINE, and the replay's token at most
    NEAR_TIE_ULPS bf16 ulps under the eager top logit; chunk launches
    through replays = L a call. Reports replayed and eager walls (chunk
    of 512 at nb 0, 32, 64, 96; a partial chunk of 300 padded to 512;
    one-shot prefills of 662 and 2000 tokens; a suffix of 150 after 512
    shared tokens), a profiled replayed chunk (P=1024), and the graphs
    and capture seconds per program."""
    import numpy as np

    from repro_torch.models import transformer
    from repro_torch.serving.compiled import (CompiledPrefill, chunk_bucket,
                                              pad_tokens, prefill_bucket)

    comp = CompiledPrefill(cfg, params, kv, DEV, 512)
    rng = np.random.default_rng(11)
    L, bs = cfg.num_layers, kv.block_size
    scales = {} if kv.k_scale is None else dict(k_scale_pool=kv.k_scale,
                                                v_scale_pool=kv.v_scale)
    result = {}

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=DEV)

    def snap(out):
        return [x.clone() for x in out]

    def bitwise(got, want, what):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                gate(False, f"{what}: replay != eager at the same padded "
                     f"operands (max |diff| "
                     f"{float((g.float() - w.float()).abs().max())})")
                return False
        return True

    def case(what, call, program, ops, unpadded):
        """Three calls (warm-up + 2 replays) against ``program`` run
        eagerly on fresh copies of the padded operands ``ops``."""
        want = snap(program(*[dev(a) for a in ops]))
        counters.reset()
        got = [snap(call()) for _ in range(3)]
        sync(torch)
        n = counters.read()[kernel]
        per = L if what.startswith("chunk") else 0
        gate(n == 3 * per, f"{what}: {n} {kernel} launches in 3 calls "
             f"!= 3 x {per}")
        ok = all(bitwise(g, want, what) for g in got)
        ref = unpadded()
        cos = cosine(got[1][0], ref)
        token = int(got[1][0].argmax())
        arg = token == int(ref.argmax())
        gap = gap_ulps(ref, token)
        gate(cos >= MIN_COSINE and gap <= NEAR_TIE_ULPS,
             f"{what}: padded replay vs eager on unpadded operands: cosine "
             f"{cos}, argmax equal {arg}, the replay's token "
             f"{gap} bf16 ulps under the eager top")
        top2 = ref.float().flatten().topk(2).values.tolist()
        return dict(bitwise=ok, cosine_vs_unpadded=cos, argmax_equal=arg,
                    token_gap_ulps=gap,
                    eager_top2_margin_ulps=(top2[0] - top2[1]) /
                    bf16_ulp(top2[0]),
                    replay_ms=median_wall(torch, call),
                    eager_ms=median_wall(torch, unpadded))

    def eager_chunk(toks, blocks):
        return lambda: transformer.prefill_chunk(
            params, cfg, {"tokens": [toks]}, kv.k_pool, kv.v_pool,
            dev(blocks), device=DEV, **scales)[0]

    table = kv.tables[rid]
    for nb, C in ((0, 512), (32, 512), (64, 512), (96, 512), (32, 300)):
        toks = rng.integers(0, cfg.vocab_size, size=C).tolist()
        blocks = table[:nb]
        width = chunk_bucket(C, 512)
        result[f"chunk_C{C}_nb{nb}"] = case(
            f"chunk C={C} nb={nb}",
            lambda: comp.run_chunk(toks, blocks), comp._chunk,
            (pad_tokens(toks, width), blocks, [C]), eager_chunk(toks, blocks))
    toks = rng.integers(0, cfg.vocab_size, size=512).tolist()
    result["profile_chunk_P1024"] = profile_window(
        torch, lambda: comp.run_chunk(toks, table[:64]), 2, 1)
    suffix = rng.integers(0, cfg.vocab_size, size=150).tolist()
    result["suffix_P512_S150"] = case(
        "suffix P=512 S=150", lambda: comp.run_suffix(suffix, table[:32]),
        comp._suffix, (pad_tokens(suffix, prefill_bucket(150)), table[:32],
                       [150]),
        lambda: transformer.prefill_suffix(
            params, cfg, {"tokens": [suffix]},
            *[x[:, None] for x in kv.gather_prefix(rid, 512)],
            device=DEV)[0])
    if oneshot:
        for S in (662, 2000):
            toks = rng.integers(0, cfg.vocab_size, size=S).tolist()
            result[f"oneshot_S{S}"] = case(
                f"one-shot S={S}", lambda: comp.run_oneshot(toks),
                comp._oneshot, (pad_tokens(toks, prefill_bucket(S)), [S]),
                lambda: transformer.prefill(params, cfg, {"tokens": [toks]},
                                            max_seq=S, device=DEV)[0])
    result["graphs"] = prefill_stats(comp)
    del comp
    return result


def fill_pool(torch, cfg, params, kv, prompt, rid=0):
    """Write ``prompt`` into ``kv`` as sequence ``rid`` by eager chunks of
    512; returns each chunk's synchronized wall (ms) and the last
    logits."""
    from repro_torch.models import transformer

    scales = {} if kv.k_scale is None else dict(k_scale_pool=kv.k_scale,
                                                v_scale_pool=kv.v_scale)
    walls = []
    for c0 in range(0, len(prompt), 512):
        c1 = min(c0 + 512, len(prompt))
        t0 = time.perf_counter()
        logits, cache = transformer.prefill_chunk(
            params, cfg, {"tokens": [prompt[c0:c1]]}, kv.k_pool, kv.v_pool,
            kv.gather_prefix_indices(rid, c0) if c0 else
            torch.zeros((0,), dtype=torch.int32, device=DEV), device=DEV,
            **scales)
        kv.write_prefill_chunk(rid, cache["k"][:, 0], cache["v"][:, 0], c0)
        sync(torch)
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls, logits


def write_launches(torch, cfg, kv_dtype, C=300):
    """Device kernels (and copies) one ``write_prefill_chunk`` of C rows
    into a fresh ``kv_dtype`` pool enqueues, counted by the profiler: the
    pool write the compiled programs leave outside their graphs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import PagedKVCache

    kv = PagedKVCache(cfg, 32, 16, kv_dtype=kv_dtype, device=DEV)
    L, Hkv, _, _, hd = kv.k_pool.shape
    k = torch.randn((L, Hkv, C, hd), device=DEV).to(cfg.dtype)
    sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kv.write_prefill_chunk(0, k, k, 0)
        sync(torch)
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def compiled_stats(comp):
    """What a compiled decode step did: graphs captured (and kept), the
    host seconds its captures took, replays, and the device memory its
    captures reserved."""
    return dict(graphs_captured=comp.captures, graphs_kept=comp.graphs,
                capture_s=comp.capture_s, replays=comp.replays,
                eager_calls=comp.eager_calls,
                graph_reserved_mib=comp.reserved_bytes / 2**20)


def compiled_gates(torch, pl, params, kv, ids, tokens, counters, kernel,
                   per_step, pool_write=False):
    """A fresh compiled step of placement ``pl`` against its eager step at
    one engine state: the replay equals the eager step at the same padded
    operands bit for bit (or, where a library GEMM takes another path under
    capture, within ERR_RTOL/ERR_ATOL and cosine >= MIN_COSINE, reported
    as ``bitwise: false``), twice in a row; greedy tokens equal the eager
    step on unpadded operands and its logits' row cosine >= MIN_COSINE; a
    bucket switch and back replays right; with ``pool_write``, the step's
    K/V stored between replays is seen by the next replay (this advances
    the sequences: cancel them after). Launches through replays equal the
    eager step's. Reports capture seconds, the host enqueue time of a
    replay and the step's synchronized wall, replayed and eager."""
    import numpy as np

    from repro_torch.serving.compiled import (CompiledDecodeStep,
                                              pad_operands)
    from repro_torch.serving.placement import device_operands

    scales = {} if kv.k_scale is None else dict(k_scale_pool=kv.k_scale,
                                                v_scale_pool=kv.v_scale)
    step = pl.decode_fn()

    def eager(toks, tables, lens, extra):
        tk, tb, ln = device_operands(
            [np.asarray(toks, np.int32), tables, lens], DEV)
        return step(params, tk, kv.k_pool, kv.v_pool, tb, ln,
                    *device_operands(extra, DEV), **scales)

    def snap(out):
        return [out[0].clone(), out[1]["k_new"].clone(),
                out[1]["v_new"].clone()]

    result = dict(bitwise=True, max_abs_diff=0.0)

    def same(got, want, what):
        for g, w in zip(got, want):
            if torch.equal(g, w):
                continue
            result["bitwise"] = False
            result["max_abs_diff"] = max(result["max_abs_diff"], float(
                (g.float() - w.float()).abs().max()))
            check_close(f"replay vs eager ({what})", g, w)
            if not cosine(g, w) >= MIN_COSINE:
                raise AssertionError(f"replay vs eager ({what}): cosine "
                                     f"{cosine(g, w)} < {MIN_COSINE}")

    comp = CompiledDecodeStep(step, params, kv.k_pool, kv.v_pool,
                              kv.k_scale, kv.v_scale, DEV,
                              n_shards=kv.n_shards)
    tables, lens = kv.block_table_batch(ids)
    extra = pl.decode_extra_args(kv, ids)
    padded, pextra = pad_operands(tables, extra, kv.num_blocks,
                                  kv.blocks_per_shard)
    want = snap(eager(tokens, padded, lens, pextra))
    ref = snap(eager(tokens, tables, lens, extra))
    counters.reset()
    calls = [snap(comp(tokens, tables, lens, *extra)) for _ in range(3)]
    sync(torch)
    got = counters.read()[kernel]
    if got != 3 * per_step:
        raise AssertionError(f"3 compiled calls: {got} launches != 3 x "
                             f"{per_step}")
    for i, c in enumerate(calls):
        same(c, want, ["warm-up", "replay 1", "replay 2"][i])
    rows = min(cosine(calls[1][0][i], ref[0][i]) for i in range(len(ids)))
    argmax_equal = calls[1][0].argmax(-1).tolist() == \
        ref[0].argmax(-1).tolist()
    if not (rows >= MIN_COSINE and argmax_equal):
        raise AssertionError(f"replay vs eager on unpadded operands: row "
                             f"cosine {rows}, argmax equal {argmax_equal}")
    # a bucket switch (one slot past the bucket) and back
    wide = np.pad(tables, ((0, 0), (0, padded.shape[1] + 1 -
                                    tables.shape[1])))
    wpad, _ = pad_operands(wide, (), kv.num_blocks, kv.blocks_per_shard)
    want_w = snap(eager(tokens, wpad, lens, pextra))
    comp(tokens, wide, lens, *extra)
    same(snap(comp(tokens, wide, lens, *extra)), want_w, "bucket switch")
    same(snap(comp(tokens, tables, lens, *extra)), want, "switch back")
    # host time of one replay call from an idle card (the operand copy
    # and the graph launch enqueued, not run), and synchronized step walls
    ts = []
    for _ in range(10):
        sync(torch)
        t0 = time.perf_counter()
        comp(tokens, tables, lens, *extra)
        ts.append((time.perf_counter() - t0) * 1e6)
    result["replay_host_us"] = sorted(ts)[5]
    walls = {}
    for name, fn in (("replay", lambda: comp(tokens, tables, lens, *extra)),
                     ("eager", lambda: eager(tokens, tables, lens, extra))):
        ts = []
        for _ in range(5):
            sync(torch)
            t0 = time.perf_counter()
            fn()
            sync(torch)
            ts.append((time.perf_counter() - t0) * 1e3)
        walls[name] = sorted(ts)[2]
    result.update(replay_step_ms=walls["replay"],
                  eager_step_ms=walls["eager"], min_row_cosine=rows,
                  argmax_equal=argmax_equal, capture_s=comp.capture_s,
                  graphs=comp.graphs)
    if pool_write:
        logits, upd = comp(tokens, tables, lens, *extra)
        nxt = logits.float().argmax(-1).tolist()
        for rid in ids:
            kv.append_token(rid)
        kv.write_tokens(ids, upd["k_new"], upd["v_new"],
                        [int(n) for n in lens])
        tables2, lens2 = kv.block_table_batch(ids)
        extra2 = pl.decode_extra_args(kv, ids)
        p2, pe2 = pad_operands(tables2, extra2, kv.num_blocks,
                               kv.blocks_per_shard)
        want2 = snap(eager(nxt, p2, lens2, pe2))
        comp(nxt, tables2, lens2, *extra2)      # a new key captures here
        replays = comp.replays
        same(snap(comp(nxt, tables2, lens2, *extra2)), want2, "pool write")
        if comp.replays != replays + 1:
            raise AssertionError("the call after the pool write replayed "
                                 "nothing")
        if torch.equal(want2[0], want[0]):
            raise AssertionError("the next step's logits equal this one's")
    return result


def homogeneous_e2e(torch, np, cfg, params, prompts, counters):
    """Phase 4: the bf16 homogeneous engine on the 8 requests."""
    from repro_torch.models import transformer
    from repro_torch.serving import (EngineConfig, LLMEngine, PagedKVCache,
                                     make_placement)

    econf = EngineConfig(placement="homogeneous", scheduler="fcfs",
                         block_size=16, num_blocks=2048, max_batch=8,
                         prefill_chunk_tokens=512)
    # warm-up (library handles, allocator) on a small pool, not counted
    warm = LLMEngine(cfg, params, econf.replace(num_blocks=64), device=DEV)
    warm.submit(make_requests([list(range(1, 41))], 2))
    warm.run()
    del warm

    reqs = make_requests(prompts, 32)
    eng = LLMEngine(cfg, params, econf, device=DEV)
    launches, wall, peak = serve(torch, eng, reqs, counters)
    st = eng.stats
    check_finished(cfg, reqs, 32)
    cold_tokens = [list(r.output) for r in reqs]
    L = cfg.num_layers
    if st.steps == 0 or st.prefill_chunks_run == 0:
        raise AssertionError("no decode step or no chunk ran")
    expect_launches(launches, {
        "paged_decode_attention": L * st.steps,
        "paged_prefill_chunk_attention": L * st.prefill_chunks_run,
        "paged_decode_attention_int8": 0,
        "paged_prefill_chunk_attention_int8": 0, **NO_NEW_KERNEL},
        f"e2e homogeneous bf16 ({L} layers x {st.steps} steps / "
        f"{st.prefill_chunks_run} chunks)")
    result = serving_summary(st, reqs, wall, peak, eng.compiled,
                             eng.compiled_prefill)
    log(f"e2e homogeneous bf16: {len(reqs)} requests, "
        f"{json.dumps(result)}")
    result["warm_pass"] = warm_pass(
        torch, cfg, eng, prompts, counters, lambda steps, chunks: {
            "paged_decode_attention": L * steps,
            "paged_prefill_chunk_attention": L * chunks,
            "paged_decode_attention_int8": 0,
            "paged_prefill_chunk_attention_int8": 0, **NO_NEW_KERNEL},
        "e2e homogeneous bf16, second pass on the warmed engine")

    # chunked kernel path vs one-shot plain blockwise prefill, one prompt
    prompt = max(prompts, key=len)
    n = len(prompt)
    kv = PagedKVCache(cfg, -(-n // 16) + 1, 16, device=DEV)
    chunk_ms = []
    for c0 in range(0, n, 512):
        c1 = min(c0 + 512, n)
        t0 = time.perf_counter()
        logits_c, cache = transformer.prefill_chunk(
            params, cfg, {"tokens": [prompt[c0:c1]]}, kv.k_pool, kv.v_pool,
            kv.gather_prefix_indices(0, c0) if c0 else
            torch.zeros((0,), dtype=torch.int32, device=DEV), device=DEV)
        kv.write_prefill_chunk(0, cache["k"][:, 0], cache["v"][:, 0], c0)
        sync(torch)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    logits_o, _ = transformer.prefill(params, cfg, {"tokens": [prompt]},
                                      max_seq=n, device=DEV)
    sync(torch)
    oneshot_ms = (time.perf_counter() - t0) * 1e3
    cos = cosine(logits_c, logits_o)
    log(f"e2e: prompt of {n} tokens: {L}-layer prefill chunks of 512 took "
        f"{[round(x, 1) for x in chunk_ms]} ms; one-shot plain prefill "
        f"{oneshot_ms:.1f} ms; chunked (kernel) vs one-shot (plain) last "
        f"logits cosine {cos:.6f} (need >= 0.99), argmax "
        f"{int(logits_c.argmax())} vs {int(logits_o.argmax())}")
    if not cos >= 0.99:
        raise AssertionError(f"chunked vs one-shot cosine {cos} < 0.99")
    result.update(cosine=cos, chunk_ms=chunk_ms, oneshot_prefill_ms=oneshot_ms)
    result["prefill_gates"] = prefill_gates(
        torch, cfg, params, kv, counters, "paged_prefill_chunk_attention")
    result["write_prefill_chunk_launches"] = write_launches(torch, cfg,
                                                           "bf16")
    log(f"e2e homogeneous bf16: compiled prefill vs eager: "
        f"{json.dumps(result['prefill_gates'])}; one write_prefill_chunk "
        f"of 300 rows enqueues {result['write_prefill_chunk_launches']} "
        f"device ops")
    # the third chunk (P=1024, C=512) again, under the profiler: how much of
    # a chunk's wall the card is busy, and with what
    c0 = 1024
    prefix = kv.gather_prefix_indices(0, c0)
    prof = profile_window(torch, lambda: transformer.prefill_chunk(
        params, cfg, {"tokens": [prompt[c0:c0 + 512]]}, kv.k_pool,
        kv.v_pool, prefix, device=DEV), 2, 1)
    log(f"e2e homogeneous bf16: profiled prefill chunk P={c0} C=512: "
        f"{json.dumps(prof)}")
    result["profile_prefill_chunk"] = prof
    prof, gates = profile_decode(
        torch, eng, prompts, at_state=lambda wave: compiled_gates(
            torch, make_placement(cfg, econf, torch.device(DEV)), params,
            eng.kv, [r.rid for r in wave], [r.output[-1] for r in wave],
            counters, "paged_decode_attention", L, pool_write=True))
    log(f"e2e homogeneous bf16: profiled decode-only steps: "
        f"{json.dumps(prof)}")
    log(f"e2e homogeneous bf16: compiled step vs eager at the B=8 state: "
        f"{json.dumps(gates)}")
    result.update(profile=prof, compiled_gates=gates)
    del eng
    torch.cuda.empty_cache()
    result["oneshot_sharing"] = oneshot_sharing(torch, cfg, params)
    log(f"e2e homogeneous bf16: one-shot prefix sharing: "
        f"{json.dumps(result['oneshot_sharing'])}")
    return launches, result, cold_tokens


def oneshot_sharing(torch, cfg, params, prefix_len=512, suffixes=(100, 150),
                    new=16):
    """Two requests sharing a ``prefix_len``-token prompt prefix through
    one-shot prefill (``prefill_chunk_tokens`` unset), with and without
    prefix sharing: equal greedy tokens, the sharing counters, and the
    sharer's suffix prefill (gather_prefix + prefill_suffix) timed against
    its full one-shot prefill at the same state."""
    import numpy as np

    from repro_torch.models import transformer
    from repro_torch.serving import EngineConfig, LLMEngine

    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, size=prefix_len).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in suffixes]
    out, stats, walls = {}, {}, {}
    for share in (False, True):
        eng = LLMEngine(cfg, params, EngineConfig(
            block_size=16, num_blocks=512, max_batch=2,
            prefix_sharing=share), device=DEV)
        donor, sharer = make_requests(prompts, new)
        eng.submit(donor)
        eng.step()                       # the donor's prefill + 1 decode
        if share:
            suffix = sharer.prompt[prefix_len:]
            for what in ("suffix", "full", "suffix", "full"):
                sync(torch)
                t0 = time.perf_counter()
                if what == "suffix":
                    k, v = eng.kv.gather_prefix(donor.rid, prefix_len)
                    transformer.prefill_suffix(
                        params, cfg, {"tokens": [suffix]}, k[:, None],
                        v[:, None], device=DEV)
                else:
                    transformer.prefill(params, cfg,
                                        {"tokens": [sharer.prompt]},
                                        max_seq=len(sharer.prompt),
                                        device=DEV)
                sync(torch)
                walls[what] = (time.perf_counter() - t0) * 1e3
        eng.submit(sharer)
        eng.run()
        check_finished(cfg, [donor, sharer], new)
        out[share] = [donor.output, sharer.output]
        stats[share] = eng.stats
        del eng
    on = stats[True]
    want_skip = prefix_len
    if out[True] != out[False]:
        raise AssertionError(f"one-shot sharing changed greedy tokens: "
                             f"{out[True]} vs {out[False]}")
    if on.prefill_tokens_skipped != want_skip or \
            on.blocks_shared != want_skip // 16 or \
            stats[False].prefill_tokens_skipped:
        raise AssertionError(f"sharing counters: skipped "
                             f"{on.prefill_tokens_skipped}, blocks "
                             f"{on.blocks_shared}")
    return dict(prompt_lens=[len(p) for p in prompts],
                tokens_equal=True,
                prefill_tokens_skipped=on.prefill_tokens_skipped,
                blocks_shared=on.blocks_shared,
                suffix_prefill_ms=walls["suffix"],
                full_prefill_ms=walls["full"])


def lamina_e2e(torch, np, cfg, params, prompts, counters, bf16_resident):
    """Phase 5: Lamina's deployment — attention on 2 workers (head
    partition) reading an int8 pool in place."""
    from repro_torch.serving import (EngineConfig, LLMEngine, PagedKVCache,
                                     make_placement)

    econf = EngineConfig(placement="attention_pool", partition="head",
                         attention_workers=2, kv_dtype="int8",
                         block_size=16, num_blocks=2048, max_batch=8,
                         prefill_chunk_tokens=512)
    warm = LLMEngine(cfg, params, econf.replace(num_blocks=64), device=DEV)
    warm.submit(make_requests([list(range(1, 41))], 2))
    warm.run()
    del warm

    reqs = make_requests(prompts, 32)
    eng = LLMEngine(cfg, params, econf, device=DEV)
    launches, wall, peak = serve(torch, eng, reqs, counters)
    st = eng.stats
    check_finished(cfg, reqs, 32)
    L, n = cfg.num_layers, econf.attention_workers
    expect_launches(launches, {
        "paged_decode_attention": 0,
        "paged_prefill_chunk_attention": 0,
        "paged_decode_attention_int8": L * st.steps * n,
        "paged_prefill_chunk_attention_int8": L * st.prefill_chunks_run,
        **NO_NEW_KERNEL},
        f"e2e Lamina head int8 ({L} layers x {st.steps} steps x {n} "
        f"workers / {st.prefill_chunks_run} chunks)")
    hd = cfg.resolved_head_dim
    ratio = st.kv_pool_bytes_resident / bf16_resident
    e = torch.finfo(cfg.dtype).bits // 8       # 2: the model's bf16
    want = (hd + 4) / (e * hd)
    log(f"e2e Lamina: pool resident {st.kv_pool_bytes_resident} B vs bf16 "
        f"{bf16_resident} B: ratio {ratio:.6f} (expect (hd+4)/({e}·hd) = "
        f"{want:.6f} within 1%)")
    if abs(ratio / want - 1) > 0.01:
        raise AssertionError(f"int8 / bf16 resident ratio {ratio} != {want}")
    got_log = transfer_log_check(cfg, eng, prompts, "int8")
    if not got_log["ok"]:
        raise AssertionError(f"TransferLog {got_log}")
    log(f"e2e Lamina: TransferLog {got_log} = the §3.1 formulas; "
        f"per-worker KV bytes read {eng.pool.per_worker_kv_bytes}")
    result = serving_summary(st, reqs, wall, peak, eng.compiled,
                             eng.compiled_prefill)
    log(f"e2e Lamina head int8: {len(reqs)} requests, {json.dumps(result)}")
    result["warm_pass"] = warm_pass(
        torch, cfg, eng, prompts, counters, lambda steps, chunks: {
            "paged_decode_attention": 0,
            "paged_prefill_chunk_attention": 0,
            "paged_decode_attention_int8": L * steps * n,
            "paged_prefill_chunk_attention_int8": L * chunks,
            **NO_NEW_KERNEL},
        "e2e Lamina head int8, second pass on the warmed engine")
    prof, gates = profile_decode(
        torch, eng, prompts, at_state=lambda wave: compiled_gates(
            torch, make_placement(cfg, econf, torch.device(DEV)), params,
            eng.kv, [r.rid for r in wave], [r.output[-1] for r in wave],
            counters, "paged_decode_attention_int8", L * n, pool_write=True))
    log(f"e2e Lamina head int8: profiled decode-only steps: "
        f"{json.dumps(prof)}")
    log(f"e2e Lamina head int8: compiled step vs eager at the B=8 state: "
        f"{json.dumps(gates)}")
    result.update(resident_ratio=ratio, transfer_log=got_log, profile=prof,
                  compiled_gates=gates)
    del eng
    torch.cuda.empty_cache()
    # the int8 chunk and suffix programs over an int8 pool holding the
    # longest prompt
    prompt = max(prompts, key=len)
    kv = PagedKVCache(cfg, -(-len(prompt) // 16) + 1, 16, kv_dtype="int8",
                      device=DEV)
    fill_pool(torch, cfg, params, kv, prompt)
    result["prefill_gates"] = prefill_gates(
        torch, cfg, params, kv, counters,
        "paged_prefill_chunk_attention_int8", oneshot=False)
    result["write_prefill_chunk_launches"] = write_launches(torch, cfg,
                                                           "int8")
    log(f"e2e Lamina int8 pool: compiled prefill vs eager: "
        f"{json.dumps(result['prefill_gates'])}; one write_prefill_chunk "
        f"of 300 rows enqueues {result['write_prefill_chunk_launches']} "
        f"device ops")
    return launches, result


def transfer_log_check(cfg, eng, prompts, kv_dtype):
    """The attention-pool engine's TransferLog after serving ``prompts``
    against the §3.1 formulas: ``log_iteration`` per decode step (linear
    in the batch; ``expected_transfer_bytes``) and ``log_prefill_chunk``
    per chunk (hd + 4 bytes per token-head for an int8 pool, else 2·hd).
    Returns the log's fields, the decode and chunk tokens, and ``ok``."""
    from repro_torch.serving import expected_transfer_bytes

    st, tlog = eng.stats, eng.transfer_log
    L, hd, Hkv = cfg.num_layers, cfg.resolved_head_dim, cfg.num_kv_heads
    tokens = st.tokens_generated
    chunk_tokens = sum(len(p) for p in prompts)
    per_head = hd + 4 if kv_dtype == "int8" else 2 * hd
    chunk_kv = 2 * chunk_tokens * Hkv * per_head * L
    want = dict(
        q_bytes=tokens * cfg.num_heads * hd * 2 * L,
        kv_bytes=2 * tokens * Hkv * hd * 2 * L + chunk_kv,
        out_bytes=tokens * cfg.num_heads * hd * 2 * L,
        transfers=2 * L * st.steps + L * st.prefill_chunks_run)
    got = dict(q_bytes=tlog.q_bytes, kv_bytes=tlog.kv_bytes,
               out_bytes=tlog.out_bytes, transfers=tlog.transfers)
    ok = got == want and \
        tlog.total == expected_transfer_bytes(cfg, tokens) + chunk_kv
    return dict(got, decode_tokens=tokens, chunk_tokens=chunk_tokens, ok=ok)


def partitions_e2e(torch, np, cfg, params, prompts, counters, kv_dtype):
    """Phase 6: every placement over a ``kv_dtype`` pool, 2 requests."""
    from repro_torch.serving import (EngineConfig, LLMEngine, State,
                                     make_placement)
    from repro_torch.serving.placement import device_operands

    L, workers, new = cfg.num_layers, 2, 8
    base = EngineConfig(kv_dtype=kv_dtype, block_size=16, num_blocks=2048,
                        max_batch=2, prefill_chunk_tokens=512,
                        attention_workers=workers)
    kernel, other = ("paged_decode_attention_int8", "paged_decode_attention")
    if kv_dtype != "int8":
        kernel, other = other, kernel
    confs = {"homogeneous": base.replace(kv_shards=workers),
             "head": base.replace(placement="attention_pool",
                                  partition="head"),
             "request": base.replace(placement="attention_pool",
                                     partition="request"),
             "block": base.replace(placement="attention_pool",
                                   partition="block")}

    # (a) one shared state: a homogeneous int8 engine on a 2-shard pool
    # paused where both requests decode; every placement's decode step
    # computes the next logits from that same pool, tables and tokens
    eng = LLMEngine(cfg, params, confs["homogeneous"], device=DEV)
    reqs = make_requests(prompts, new)
    eng.submit(reqs)
    while not all(r.state == State.RUNNING and eng.sched.prefill_done(r.rid)
                  for r in reqs):
        eng.step()
    ids = [r.rid for r in reqs]
    tables, lens = eng.kv.block_table_batch(ids)
    tokens = [r.output[-1] for r in reqs]
    per_layer = {"homogeneous": 1, "head": workers, "request": workers,
                 "block": workers}
    shared = {}
    logits = {}
    steps = {}
    for name, econf in confs.items():
        pl = make_placement(cfg, econf, torch.device(DEV))
        steps[name] = (pl.decode_fn(), device_operands(
            pl.decode_extra_args(eng.kv, ids), DEV))
    times = {name: [] for name in confs}
    order = list(confs)
    for rnd in range(5):        # alternate the order: host time drifts
        for name in (order if rnd % 2 == 0 else order[::-1]):
            step, extra = steps[name]
            counters.reset()
            sync(torch)
            t0 = time.perf_counter()
            out, _ = step(params, tokens, eng.kv.k_pool, eng.kv.v_pool,
                          tables, lens, *extra, k_scale_pool=eng.kv.k_scale,
                          v_scale_pool=eng.kv.v_scale)
            sync(torch)
            times[name].append((time.perf_counter() - t0) * 1e3)
            got = counters.read()[kernel]
            if got != L * per_layer[name]:
                raise AssertionError(f"shared-state step {name} {kv_dtype}: "
                                     f"{got} launches != {L} x "
                                     f"{per_layer[name]}")
            logits[name] = out.float()
    for name in confs:
        out = logits[name]
        cos = min(cosine(out[i], logits["homogeneous"][i])
                  for i in range(len(ids)))
        shared[name] = dict(min_row_cosine=cos,
                            step_ms=sorted(times[name])[2],
                            argmax=[int(t) for t in out.argmax(-1)])
        if not cos >= MIN_COSINE:
            raise AssertionError(f"{name} logits vs homogeneous {kv_dtype} at "
                                 f"the same state: cosine {cos} < "
                                 f"{MIN_COSINE}")
    log(f"partitions {kv_dtype}, shared state: {kernel} launches per step "
        f"{ {n: L * k for n, k in per_layer.items()} } as expected")
    graphs = {name: compiled_gates(
        torch, make_placement(cfg, econf, torch.device(DEV)), params,
        eng.kv, ids, tokens, counters, kernel, L * per_layer[name])
        for name, econf in confs.items()}
    log(f"partitions {kv_dtype}, shared state: compiled step vs eager: "
        f"{json.dumps(graphs)}")
    log(f"partitions {kv_dtype}, shared state (B={len(ids)}, lens "
        f"{lens.tolist()}): "
        f"{json.dumps(shared)}")
    eng.cancel_all()
    del eng

    # (b) each placement serves the 2 requests itself: tokens, launches,
    # and peak memory over the decode-only steps
    runs = {}
    for name, econf in confs.items():
        eng = LLMEngine(cfg, params, econf, device=DEV)
        reqs = make_requests(prompts, new)
        eng.submit(reqs)
        while not all(r.state == State.RUNNING and
                      eng.sched.prefill_done(r.rid) for r in reqs):
            eng.step()
        sync(torch)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        counters.reset()
        steps0 = eng.stats.steps
        eng.run()
        sync(torch)
        launches = counters.read()
        check_finished(cfg, reqs, new)
        batches = eng.stats.batch_sizes[steps0:]
        if name == "request":   # one launch per worker that has requests
            want = L * sum(min(workers, b) for b in batches)
        else:
            want = L * len(batches) * per_layer[name]
        expect_launches(launches[kernel], want,
                        f"partition run {name} {kv_dtype} ({len(batches)} "
                        f"decode-only steps)")
        if launches[other]:
            raise AssertionError(f"{name} {kv_dtype}: {other} launched")
        runs[name] = dict(
            tokens=[r.output for r in reqs],
            decode_peak_over_resident_mib=(torch.cuda.max_memory_allocated()
                                           - before) / 2**20,
            **compiled_stats(eng.compiled))
        del eng
        torch.cuda.empty_cache()
    ref_tokens = runs["homogeneous"]["tokens"]
    for name, r in runs.items():
        r["tokens_agree_with_homogeneous"] = r["tokens"] == ref_tokens
    log(f"partitions {kv_dtype}, own runs: "
        f"{json.dumps({k: {kk: vv for kk, vv in v.items() if kk != 'tokens'} for k, v in runs.items()})}")
    # the block partition reads the whole layer pool in place: no copy of
    # a shard's slice (one layer's K slice alone is Hkv·NB/n·bs·hd bytes)
    hd, Hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    e = 1 if kv_dtype == "int8" else torch.finfo(cfg.dtype).bits // 8
    slice_mib = (Hkv * base.num_blocks // workers * base.block_size * hd *
                 e / 2**20)
    grow = (runs["block"]["decode_peak_over_resident_mib"] -
            runs["head"]["decode_peak_over_resident_mib"])
    log(f"partitions {kv_dtype}: block decode peak exceeds head's by "
        f"{grow:.2f} MiB "
        f"(one layer's K pool slice is {slice_mib:.1f} MiB)")
    if grow >= slice_mib:
        raise AssertionError(f"block partition's decode peak grew by "
                             f"{grow} MiB >= a pool slice ({slice_mib} MiB)")
    return dict(shared_state=shared, compiled=graphs, runs={
        k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
        for k, v in runs.items()})


def fault_e2e(torch, np, cfg, params, prompts, counters):
    """Phase 10: fault recovery at full width. llama3-8b served on
    Lamina's block partition over an int8 pool (2 workers, so 2 shards),
    chunked prefill of 512, the 8 requests of phase 5, fault-free and
    under two scenarios: a shard death at step 12 with a rejoin at 30, and
    a corrupt partial at step 20 that clears on the third attempt. Gates:
    (1) every request's greedy tokens equal the fault-free run's up to
    its first divergence, if any, and that divergence takes a token that
    ties the fault-free top logit within NEAR_TIE_ULPS bf16 ulps (each
    divergence is reported with the fault-free top-2 margin there);
    (2) the corrupt step's attempts compute the same
    logits bit for bit, the retries as graph replays; (3) after the rejoin
    the pool is whole again; (4) one recovery latency per recovered
    request. Launches: the int8 chunk kernel L per chunk (re-prefills
    included), the int8 decode kernel L x 2 per decode attempt."""
    from repro_torch.serving import (EngineConfig, FaultInjector,
                                     FaultScenario, LLMEngine)

    econf = EngineConfig(placement="attention_pool", partition="block",
                         attention_workers=2, kv_dtype="int8",
                         block_size=16, num_blocks=2048, max_batch=8,
                         prefill_chunk_tokens=512)
    L, n = cfg.num_layers, econf.attention_workers
    scenarios = {"shard_death": "shard_death:shard=1,step=12,rejoin=30",
                 "corrupt": "corrupt:shard=0,step=20,failures=2"}

    class Recording(FaultInjector):
        """The injector, recording every decode attempt's logits at the
        fault step and the decode graph's replay count before each."""

        def __init__(self, scenario, step, eng_ref):
            super().__init__(scenario)
            self.calls, self.at_step = 0, []
            self.fault_step, self.eng_ref = step, eng_ref

        def filter_decode(self, step, logits):
            self.calls += 1
            if step == self.fault_step:
                self.at_step.append((logits.clone(),
                                     self.eng_ref[0].compiled.replays))
            return super().filter_decode(step, logits)

    def run(spec):
        ref = []
        inj = Recording(FaultScenario.parse(spec), 20, ref) if spec else \
            Recording(FaultScenario([]), 20, ref)
        eng = LLMEngine(cfg, params, econf, inj, device=DEV)
        ref.append(eng)
        margins = {}
        sample = eng._sample

        def recorded(reqs, logits):    # the top 8 of every token's logits
            top = logits.float().topk(8, dim=-1)
            for r, v, i in zip(reqs, top.values.tolist(),
                               top.indices.tolist()):
                margins.setdefault(r.rid, []).append((v, i))
            return sample(reqs, logits)
        eng._sample = recorded
        reqs = make_requests(prompts, 32)
        launches, wall, peak = serve(torch, eng, reqs, counters)
        check_finished(cfg, reqs, 32)
        st = eng.stats
        expect_launches(launches, {
            "paged_decode_attention": 0, "paged_prefill_chunk_attention": 0,
            "paged_decode_attention_int8": L * n * inj.calls,
            "paged_prefill_chunk_attention_int8": L * st.prefill_chunks_run,
            **NO_NEW_KERNEL},
            f"fault phase {spec or 'fault-free'} ({inj.calls} decode "
            f"attempts / {st.prefill_chunks_run} chunks)")
        out = dict(wall_s=wall, peak_gib=peak / 2**30,
                   ttft_p50_s=st.ttft_percentiles()["p50"],
                   decode_steps=st.steps, chunks=st.prefill_chunks_run,
                   **{k: getattr(st, k) for k in (
                       "shard_failures", "shard_rejoins", "fault_retries",
                       "transient_faults_recovered", "requests_recovered",
                       "preemptions")},
                   recovery_p50_s=st.recovery_percentiles()["p50"],
                   recovery_latencies_s=list(st.recovery_latencies),
                   event_kinds={k: sum(e.kind == k for e in eng.event_log)
                                for k in ("shard_suspect", "retry",
                                          "shard_down", "shard_up",
                                          "recover", "preempt", "readmit")},
                   decode_graphs=compiled_stats(eng.compiled),
                   prefill_graphs=prefill_stats(eng.compiled_prefill))
        tokens = [r.output for r in reqs]
        rid_margins = [margins[r.rid] for r in reqs]
        return eng, inj, tokens, rid_margins, out

    _, _, ref_tokens, ref_margins, free = run(None)
    gc.collect()
    torch.cuda.empty_cache()
    result = {"fault_free": free}
    for name, spec in scenarios.items():
        eng, inj, tokens, _, out = run(spec)
        st = eng.stats
        # gate 1: greedy tokens through recovery = the fault-free run's
        diverged = []
        for i, (got, want) in enumerate(zip(tokens, ref_tokens)):
            pos = next((j for j, (a, b) in enumerate(zip(got, want))
                        if a != b), None)
            if pos is not None:
                vals, idx = ref_margins[i][pos]
                ulp = bf16_ulp(vals[0])
                mine = vals[idx.index(got[pos])] if got[pos] in idx \
                    else -math.inf
                diverged.append(dict(
                    request=i, position=pos, fault_free_top2=vals[:2],
                    margin_bf16_ulps=(vals[0] - vals[1]) / ulp,
                    faulted_token_gap_bf16_ulps=(vals[0] - mine) / ulp))
        out["tokens_equal_fault_free"] = not diverged
        out["diverged"] = diverged
        # recomputed K/V are not bit-identical to decode-written K/V in
        # bf16: a request may leave the fault-free stream only where the
        # fault-free run's top logits tie (the token it takes lies within
        # NEAR_TIE_ULPS of the top); before that, every token is equal
        gate(all(d["faulted_token_gap_bf16_ulps"] <= NEAR_TIE_ULPS
                 for d in diverged),
             f"fault {name}: greedy tokens leave the fault-free run away "
             f"from a bf16 near-tie: {diverged}")
        # gate 4: one recovery latency per recovered request
        gate(len(st.recovery_latencies) == st.requests_recovered,
             f"fault {name}: {len(st.recovery_latencies)} recovery "
             f"latencies for {st.requests_recovered} recovered requests")
        if name == "shard_death":
            down = [e for e in eng.event_log if e.kind == "shard_down"]
            out["victims"] = down[0].info["victims"] if down else []
            gate(st.shard_failures == 1 and st.shard_rejoins == 1 and
                 st.requests_recovered >= 1 and out["victims"],
                 f"fault {name}: counters {out}")
            # gate 3: the pool is whole again after the rejoin
            gate(eng.kv.quarantined_shards == () and
                 eng.kv.capacity_blocks == econf.num_blocks and
                 eng.kv.num_free == econf.num_blocks and not eng.kv.tables,
                 f"fault {name}: pool after rejoin: quarantined "
                 f"{eng.kv.quarantined_shards}, capacity "
                 f"{eng.kv.capacity_blocks}, free {eng.kv.num_free}")
        else:
            # gate 2: the attempts of the corrupt step are bit-identical,
            # the retries replays of the step's graph
            att = inj.at_step
            same = len(att) == 3 and all(torch.equal(a[0], att[0][0])
                                         for a in att[1:])
            replayed = len(att) == 3 and att[1][1] - att[0][1] == 1 and \
                att[2][1] - att[1][1] == 1
            out.update(attempts=len(att), attempts_bitwise=same,
                       retries_replayed=replayed)
            gate(same and replayed and st.fault_retries == 2 and
                 st.transient_faults_recovered == 1 and
                 st.shard_failures == 0,
                 f"fault {name}: {len(att)} attempts, bit-identical {same}, "
                 f"replayed {replayed}, counters {out}")
        result[name] = out
        log(f"fault phase {name}: {json.dumps(out)}")
        del eng, inj
        gc.collect()                  # the injector and engine reference
        torch.cuda.empty_cache()      # each other
    log(f"fault phase fault-free: {json.dumps(free)}")
    return result


# ---------------------------------------------------------------------------
# phase 11: the disaggregated prefill/decode cluster and the serve CLI
# ---------------------------------------------------------------------------
def record_top(engines, into, k=8):
    """Wrap each engine's ``_sample`` to keep the top ``k`` logits
    (values, ids) of every token it samples, per request id."""
    def wrap(sample):
        def recorded(reqs, logits):
            top = logits.float().topk(k, dim=-1)
            for r, v, i in zip(reqs, top.values.tolist(),
                               top.indices.tolist()):
                into.setdefault(r.rid, []).append((v, i))
            return sample(reqs, logits)
        return recorded
    for eng in engines:
        eng._sample = wrap(eng._sample)


def stream_divergences(reqs, ref_tokens, tops):
    """Per request whose greedy tokens leave ``ref_tokens``: the first
    position, the top-2 of this run's logits there and the bf16 ulps by
    which the reference's token lies under this run's top."""
    out = []
    for i, (r, want) in enumerate(zip(reqs, ref_tokens)):
        pos = next((j for j, (a, b) in enumerate(zip(r.output, want))
                    if a != b), None)
        if pos is None:
            continue
        vals, idx = tops[r.rid][pos]
        ulp = bf16_ulp(vals[0])
        theirs = vals[idx.index(want[pos])] if want[pos] in idx \
            else -math.inf
        out.append(dict(request=i, position=pos, top2=vals[:2],
                        margin_bf16_ulps=(vals[0] - vals[1]) / ulp,
                        reference_token_gap_bf16_ulps=(vals[0] - theirs) /
                        ulp))
    return out


def stream_gate(what, reqs, ref_tokens, tops):
    """Greedy streams against ``ref_tokens``: every request that leaves
    them does so at a bf16 near-tie of this run's logits."""
    diverged = stream_divergences(reqs, ref_tokens, tops)
    gate(all(d["reference_token_gap_bf16_ulps"] <= NEAR_TIE_ULPS
             for d in diverged), f"{what}: greedy streams leave the "
         f"reference's away from a bf16 near-tie: {diverged}")
    return dict(streams_equal=len(reqs) - len(diverged), diverged=diverged)


def engine_graphs(eng):
    """Graphs captured and replayed per compiled program of one engine."""
    progs = dict(eng.compiled_prefill.programs(), decode=eng.compiled)
    return {k: [g.captures, g.replays] for k, g in progs.items()}


def handoff_probe(torch, kv, payload, n=5):
    """The wire on its own, after a cluster run, on a drained decode
    pool: median wall of landing ``payload`` whole (one prealloc, then
    ``write_handoff_blocks`` of every block, synchronised) and of
    exporting it back (``export_seqs`` synchronises itself)."""
    rid = next(iter(payload.tables))
    mapping = kv.prealloc_handoff(payload)
    imp, exp = [], []
    for _ in range(n):
        sync(torch)
        t0 = time.perf_counter()
        kv.write_handoff_blocks(payload, mapping, 0, payload.n_blocks)
        sync(torch)
        imp.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = kv.export_seqs([rid])
        exp.append(time.perf_counter() - t0)
    same = all(torch.equal(a, b) for a, b in zip(
        (back.k_blocks, back.v_blocks, back.k_scales, back.v_scales),
        (payload.k_blocks, payload.v_blocks, payload.k_scales,
         payload.v_scales)) if a is not None)
    kv.free_seq(rid)
    t_imp, t_exp = sorted(imp)[n // 2], sorted(exp)[n // 2]
    return dict(blocks=payload.n_blocks, nbytes=payload.nbytes,
                import_ms=t_imp * 1e3,
                import_ms_per_block=t_imp * 1e3 / payload.n_blocks,
                h2d_gb_s=payload.nbytes / t_imp / 1e9,
                export_ms=t_exp * 1e3,
                d2h_gb_s=payload.nbytes / t_exp / 1e9,
                round_trip_bitwise=same)


def snapshot_landed(torch, dec, landed):
    """Wrap ``dec._advance_transfer``: the moment a handoff completes (before
    a decode step writes its tail block) its blocks are read back through
    the decode pool's table into a device copy, ``landed[rid]``, held
    against the payload after the run (``landed_equal``)."""
    advance = dec._advance_transfer

    def snapped():
        pending = list(dec.transfer_q)
        advance()
        kv = dec.kv
        for h in pending:
            if h.transferred:
                dst = torch.as_tensor(kv.tables[h.rid], device=kv.device)
                landed[h.rid] = [None if pool is None else
                                 pool[:, :, dst].clone()
                                 for pool in (kv.k_pool, kv.v_pool,
                                              kv.k_scale, kv.v_scale)]
    dec._advance_transfer = snapped


def landed_equal(torch, payloads, landed):
    """Per request id: the blocks its decode table held when the transfer
    completed equal its payload's tiles (in table order) bit for bit."""
    out = {}
    for rid, p in payloads.items():
        pos = {b: i for i, b in enumerate(p.block_ids)}
        src = [pos[b] for b in p.tables[rid]]
        got = landed.get(rid)
        out[rid] = got is not None and all(
            (g is None) == (t is None) and
            (t is None or torch.equal(g, t[:, :, src].to(g.device)))
            for g, t in zip(got, (p.k_blocks, p.v_blocks, p.k_scales,
                                  p.v_scales)))
    return out


def cluster_run(torch, cluster, reqs, counters):
    """Serve ``reqs`` through ``cluster`` with the launch counters zeroed
    just before and read just after; every payload the prefill engines
    hand off is kept (with its export wall: ``export_seqs`` synchronises
    before it returns), every landed handoff is read back
    (``snapshot_landed``) and held against its payload after the run. The
    card is synchronised before the handoff latencies are read."""
    payloads, export_s, landed = {}, [], {}
    for rep in cluster.registry:
        pre, dec = rep.prefill, rep.decode
        snapshot_landed(torch, dec, landed)
        export = pre.kv.export_seqs

        def timed(seq_ids, export=export):
            t0 = time.perf_counter()
            p = export(seq_ids)
            export_s.append(time.perf_counter() - t0)
            return p
        pre.kv.export_seqs = timed

        def sink(req, payload, dec=dec):
            payloads[req.rid] = payload
            return dec.enqueue_handoff(req, payload)
        pre.on_handoff = sink
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counters.reset()
    t0 = time.perf_counter()
    cluster.submit(reqs)
    cluster.run()
    sync(torch)
    wall = time.perf_counter() - t0
    return dict(launches=counters.read(), wall=wall, base=base,
                peak=torch.cuda.max_memory_allocated(), payloads=payloads,
                export_s=export_s,
                landed=landed_equal(torch, payloads, landed))


def cluster_report(cluster, reqs, run):
    """The end-to-end numbers of one cluster run."""
    s = cluster.summary()
    ttft = sorted(r.first_token_s - r.arrival_s for r in reqs)
    tbt = sorted(r.tbt_s() for r in reqs)
    exp = sorted(run["export_s"])
    return dict(
        wall_s=run["wall"], peak_gib=run["peak"] / 2**30,
        allocated_before_gib=run["base"] / 2**30,
        tok_s=sum(len(r.output) for r in reqs) / run["wall"],
        ttft_p50_s=ttft[len(ttft) // 2], tbt_p50_s=tbt[len(tbt) // 2],
        handoff_p50_s=s["handoff_p50_s"], handoff_p90_s=s["handoff_p90_s"],
        export_ms_p50=exp[len(exp) // 2] * 1e3, launches=run["launches"],
        **{k: s[k] for k in ("handoffs_completed", "kv_bytes_transferred",
                             "router_affinity_hits",
                             "prefill_tokens_skipped", "blocks_shared",
                             "tokens_generated")},
        graphs={f"{role}{rep.idx}": engine_graphs(getattr(rep, role))
                for rep in cluster.registry
                for role in ("prefill", "decode")})


def lane_gates(cluster, launches, L, workers, kernels, what):
    """Each role in its lane: the prefill engines launch only the chunk
    kernel (L per chunk) and capture no decode graph; the decode engines
    launch only the decode kernel (L × workers per step), run no chunk,
    record no admit / chunk event and capture no prefill graph."""
    decode_k, chunk_k = kernels
    chunks = sum(r.prefill.stats.prefill_chunks_run for r in cluster.registry)
    steps = sum(r.decode.stats.steps for r in cluster.registry)
    want = dict({k: 0 for k in launches}, **{
        decode_k: L * workers * steps, chunk_k: L * chunks})
    gate(launches == want, f"{what}: launches {launches} != {want} "
         f"({chunks} chunks, {steps} decode steps)")
    for rep in cluster.registry:
        pre, dec = rep.prefill, rep.decode
        kinds = {e.kind for e in dec.event_log}
        gate(pre.stats.steps == 0 and pre.compiled.captures == 0 and
             dec.stats.prefill_chunks_run == 0 and
             dec.stats.max_prefill_slab_tokens == 0 and
             not kinds & {"admit", "chunk"} and
             all(g.captures == 0
                 for g in dec.compiled_prefill.programs().values()),
             f"{what}: replica {rep.idx} left its lane: prefill steps "
             f"{pre.stats.steps}, decode graphs on the prefill engine "
             f"{pre.compiled.captures}, decode-side chunks "
             f"{dec.stats.prefill_chunks_run}, slab "
             f"{dec.stats.max_prefill_slab_tokens}, events {sorted(kinds)}")
    return chunks, steps


def cluster_e2e(torch, np, cfg, params, prompts, counters, ref_tokens):
    """Phase 11: the disaggregated cluster at full width and depth.
    (a) one replica over phase 4's bf16 engine, 8 blocks landed a step:
    first tokens equal phase 4's cold run's, every handoff read back
    through the decode table equals its payload bit for bit, the decode
    side's bytes equal the payloads' (2 MiB a block), 8 handoffs, each
    role launches only its own kernels; the greedy streams equal phase
    4's up to a bf16 near-tie (NEAR_TIE_ULPS, reported with the margin).
    (b) Lamina's int8 engine of phase 5 with prefix sharing on 2
    affinity-routed replicas (1024 blocks each), 3 groups × 3 requests
    sharing a 512-token prefix: each group on one replica, 6 affinity
    hits, skipped prefill, int8 payloads at (hd+4)/(2·hd) of the bf16
    bytes (132/256), only the int8 kernels; the wire's export / import
    times on their own."""
    from repro_torch.serving import DisaggConfig, EngineConfig
    from repro_torch.serving.cluster import DisaggCluster

    L = cfg.num_layers
    bf16_block = 2 * L * cfg.num_kv_heads * 16 * cfg.resolved_head_dim * 2
    result = {}
    # (a) parity, bf16, one replica
    econf = EngineConfig(placement="homogeneous", scheduler="fcfs",
                         block_size=16, num_blocks=2048, max_batch=8,
                         prefill_chunk_tokens=512)
    cluster = DisaggCluster(cfg, params, econf, replicas=1, device=DEV,
                            disagg=DisaggConfig(transfer_blocks_per_step=8))
    tops = {}
    record_top([e for rep in cluster.registry
                for e in (rep.prefill, rep.decode)], tops)
    reqs = make_requests(prompts, 32)
    run = cluster_run(torch, cluster, reqs, counters)
    check_finished(cfg, reqs, 32)
    out = cluster_report(cluster, reqs, run)
    chunks, steps = lane_gates(
        cluster, run["launches"], L, 1,
        ("paged_decode_attention", "paged_prefill_chunk_attention"),
        "cluster bf16")
    blocks = sum(p.n_blocks for p in run["payloads"].values())
    nbytes = sum(p.nbytes for p in run["payloads"].values())
    firsts = [r.output[0] == t[0] for r, t in zip(reqs, ref_tokens)]
    diverged = stream_divergences(reqs, ref_tokens, tops)
    largest = max(run["payloads"].values(), key=lambda p: p.n_blocks)
    out.update(chunks=chunks, decode_steps=steps, payload_blocks=blocks,
               payload_bytes=nbytes, bytes_per_block=nbytes / blocks,
               landed_bitwise=sum(run["landed"].values()),
               first_tokens_equal=sum(firsts),
               streams_equal=len(reqs) - len(diverged), diverged=diverged,
               wire=handoff_probe(torch, cluster.registry[0].decode.kv,
                                  largest))
    log(f"cluster bf16 (1 replica): payloads {blocks} blocks (expect 443 "
        f"if each table holds exactly its prompt's blocks), "
        f"{json.dumps(out)}")
    gate(all(firsts), f"cluster bf16: first tokens differ from phase 4's "
         f"cold run: {firsts}")
    gate(len(run["landed"]) == len(reqs) and all(run["landed"].values()),
         f"cluster bf16: landed blocks != payload: {run['landed']}")
    gate(out["kv_bytes_transferred"] == nbytes == blocks * bf16_block,
         f"cluster bf16: decode-side bytes {out['kv_bytes_transferred']} "
         f"vs payloads {nbytes} vs {blocks} x {bf16_block}")
    gate(out["handoffs_completed"] == len(reqs),
         f"cluster bf16: {out['handoffs_completed']} handoffs")
    gate(all(d["reference_token_gap_bf16_ulps"] <= NEAR_TIE_ULPS
             for d in diverged),
         f"cluster bf16: greedy streams leave phase 4's away from a bf16 "
         f"near-tie: {diverged}")
    gate(out["wire"]["round_trip_bitwise"],
         "cluster bf16: the wire probe's round trip is not bit-exact")
    result["bf16_one_replica"] = out
    del cluster, run, reqs, largest
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Lamina int8, prefix sharing, two affinity-routed replicas
    econf = EngineConfig(placement="attention_pool", partition="head",
                         attention_workers=2, kv_dtype="int8",
                         block_size=16, num_blocks=1024, max_batch=8,
                         prefill_chunk_tokens=512, prefix_sharing=True)
    rng = np.random.default_rng(1)
    groups = []
    for _ in range(3):
        prefix = rng.integers(0, cfg.vocab_size, size=512).tolist()
        groups.append([prefix + rng.integers(
            0, cfg.vocab_size, size=int(n)).tolist()
            for n in rng.integers(100, 401, size=3)])
    cluster = DisaggCluster(cfg, params, econf, replicas=2,
                            routing="affinity", device=DEV)
    reqs = make_requests([p for g in groups for p in g], 32)
    run = cluster_run(torch, cluster, reqs, counters)
    check_finished(cfg, reqs, 32)
    out = cluster_report(cluster, reqs, run)
    lane_gates(cluster, run["launches"], L, econf.attention_workers,
               ("paged_decode_attention_int8",
                "paged_prefill_chunk_attention_int8"), "cluster int8")
    homes = [sorted({cluster.replica_of(r.rid) for r in reqs[3 * g:3 * g + 3]})
             for g in range(3)]
    hd = cfg.resolved_head_dim          # int8 / bf16 bytes: (hd + 4) / (2 hd)
    ratios = [p.nbytes * 2 * hd == p.n_blocks * bf16_block * (hd + 4)
              for p in run["payloads"].values()]
    dec = cluster.registry[-1].decode
    last = run["payloads"][reqs[-1].rid]
    out.update(homes=homes, payload_blocks=[p.n_blocks for p in
                                            run["payloads"].values()],
               landed_bitwise=sum(run["landed"].values()),
               wire=handoff_probe(torch, dec.kv, last))
    log(f"cluster Lamina int8 (2 replicas, affinity, prefix sharing): "
        f"{json.dumps(out)}")
    gate(all(len(h) == 1 for h in homes),
         f"cluster int8: a prefix group split across replicas: {homes}")
    gate(out["router_affinity_hits"] == 6,
         f"cluster int8: {out['router_affinity_hits']} affinity hits")
    gate(out["prefill_tokens_skipped"] > 0,
         "cluster int8: no prefill token skipped")
    gate(all(ratios) and len(ratios) == len(reqs),
         f"cluster int8: payload bytes x {2 * hd} != bf16 bytes x "
         f"{hd + 4}: {ratios}")
    gate(all(run["landed"].values()) and len(run["landed"]) == len(reqs)
         and out["wire"]["round_trip_bitwise"],
         f"cluster int8: landed blocks != payload: {run['landed']}, "
         f"round trip {out['wire']['round_trip_bitwise']}")
    result["lamina_int8_two_replicas"] = out
    del cluster, run, reqs, dec, last
    gc.collect()
    torch.cuda.empty_cache()
    return result


def serve_cli(torch, argv):
    """The serve CLI in process (``repro_torch.launch.serve.main``), its
    standard output captured and logged line by line."""
    import contextlib
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    sync(torch)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  serve: {line}")
    if not lines or not lines[0].startswith("mode=router"):
        raise AssertionError(f"serve CLI printed no summary: {lines}")
    return dict(argv=" ".join(argv), wall_s=wall, lines=lines,
                allocated_before_gib=base / 2**30,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def profile_decode(torch, eng, prompts, n_steps=3, at_state=None):
    """Where a decode step's time goes: a second wave of the same prompts
    is driven until every request decodes, two more steps capture the
    graph of that batch, ``n_steps`` decode-only steps (B=8) are timed
    (median wall, ``step_ms_unprofiled``), then ``n_steps`` more run under
    torch.profiler (``profile_window``): replays, with the graphs captured
    and replayed in the window counted. ``at_state(wave)`` then
    runs at that state before the wave is cancelled; returns (profile,
    its result). Runs after the launch counts were read."""
    from repro_torch.serving import State

    wave = make_requests(prompts, 64)
    eng.submit(wave)
    while not all(r.state == State.RUNNING and eng.sched.prefill_done(r.rid)
                  for r in wave):
        eng.step()
    for _ in range(2):
        eng.step()
    comp = eng.compiled
    captures, replays = comp.captures, comp.replays
    walls = []
    for _ in range(n_steps):             # the same steps, unprofiled
        sync(torch)
        t0 = time.perf_counter()
        eng.step()
        sync(torch)
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = profile_window(torch, eng.step, n_steps, len(wave))
    prof.update(step_ms_unprofiled=sorted(walls)[n_steps // 2],
                captures_in_window=comp.captures - captures,
                replays_in_window=comp.replays - replays - n_steps)
    if prof["replays_in_window"] != n_steps:
        raise AssertionError(f"profiled window: {prof['replays_in_window']} "
                             f"replays in {n_steps} decode steps")
    out = at_state(wave) if at_state is not None else None
    eng.cancel_all()
    return prof, out


# cuBLAS / CUTLASS matmul kernels by name (a profile's ``gemm_ms``)
GEMM_MARKERS = ("gemm", "gemv", "nvjet", "xmma", "cutlass")
# the profiler's and the driver's own activities, not operators
PROFILER_OWN = ("Module Loading", "Function Loading", "Activity Buffer")


def profile_window(torch, step, n_steps, batch,
                   kernels=("paged_decode_kernel",)):
    """Run ``step()`` ``n_steps`` times under torch.profiler. Reports host
    wall per step, device-busy time per step (sum of kernel self time), the
    idle share, the top kernels, the top operators by the device time of
    the kernels they launch themselves (``top_ops_ms``: aten::mm,
    aten::mul, ...; a ctypes launch counts under the autograd node around
    it), and per step the device time of the kernels whose names hold each
    of ``kernels`` (``<name>_ms``) and of the matmul kernels (``gemm_ms``,
    by ``GEMM_MARKERS``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        sync(torch)
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies): CPU ops' device totals
    # would count the same kernels a second time
    dev = [(e.key, e.self_device_time_total / 1e3 / n_steps)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t in dev)
    step_ms = wall * 1e3 / n_steps
    top = sorted(dev, key=lambda kv: -kv[1])[:6]
    ops = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0
                  and not any(m in e.key for m in PROFILER_OWN)),
                 key=lambda kv: -kv[1])
    return dict(batch=batch, step_ms_profiled=step_ms,
                device_busy_ms=busy,
                **{f"{name}_ms": sum(t for k, t in dev if name in k)
                   for name in kernels},
                gemm_ms=sum(t for k, t in dev
                            if any(m in k.lower() for m in GEMM_MARKERS)),
                idle_share=1 - busy / step_ms if step_ms else None,
                top_kernels_ms={k[:60]: round(v, 3) for k, v in top},
                top_ops_ms={k[:60]: round(v, 3) for k, v in ops[:10]})


# ---------------------------------------------------------------------------
# phase 7: dense-cache decode and the two scans
# ---------------------------------------------------------------------------
def dense_decode_case(torch, da, timer, *, B, Hkv, G, hd, lens, S, seed,
                      sliding_window=0, sinks=0, softcap=0.0, int8=False):
    """The dense decode kernel vs its twin on a (B, Hkv, S, hd) cache whose
    slots no mask keeps (past each cache_len, outside the window and
    sinks) hold NaN (NaN scales too, for an int8 cache); o alone and the
    (o, l, m) triple. The int8 entry is also held against the bf16 twin
    on the unquantized cache (cosine)."""
    from repro_torch.kernels import _cuda
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shape = (B, Hkv, S, hd)
    k = torch.randn(shape, generator=gen, device=DEV).bfloat16()
    v = torch.randn(shape, generator=gen, device=DEV).bfloat16()
    cache_len = torch.tensor(lens, dtype=torch.int32, device=DEV)
    pos = torch.arange(S, device=DEV)
    stale = pos[None] >= cache_len[:, None]                      # (B, S)
    if sliding_window:
        stale |= (pos[None] < cache_len[:, None] - sliding_window) & \
            (pos[None] >= sinks)
    stale3 = stale[:, None].expand(B, Hkv, S)
    k[stale3] = float("nan")
    v[stale3] = float("nan")
    q = torch.randn((B, Hkv, G, hd), generator=gen, device=DEV).bfloat16()
    kw = dict(sliding_window=sliding_window, attention_sinks=sinks,
              logit_softcap=softcap)
    caches = (k, v)
    if int8:
        kq, ks = quantize_pool(torch, k)
        vq, vs = quantize_pool(torch, v)
        ks[stale3] = float("nan")          # the kernel must never load them
        vs[stale3] = float("nan")
        caches = (kq, vq)
        kw.update(k_scale=ks, v_scale=vs)
    o1 = da.decode_attention(q, *caches, cache_len, **kw)
    o, l, m = da.decode_attention(q, *caches, cache_len,
                                  return_partials=True, **kw)
    sync(torch)
    po, pl, pm = da.decode_attention_plain(q, *caches, cache_len,
                                           return_partials=True, **kw)
    err = check_close("dense decode o", o, po)
    check_close("dense decode o (no partials)", o1, po)
    check_close("dense decode l", l, pl, rtol=1e-3, atol=1e-6)
    check_close("dense decode m", m, pm, rtol=0.0, atol=1e-3)
    out = {}
    if int8:   # the int8 kernel against the bf16 twin on the unquantized cache
        full = {x: y for x, y in kw.items() if x not in ("k_scale",
                                                         "v_scale")}
        out["cosine_vs_bf16"] = cosine(o, da.decode_attention_plain(
            q, k, v, cache_len, **full))
        if not out["cosine_vs_bf16"] >= MIN_COSINE:
            raise AssertionError(f"int8 dense decode vs bf16 cosine "
                                 f"{out['cosine_vs_bf16']} < {MIN_COSINE}")
    valid = pos[None] < cache_len[:, None]
    if sliding_window:
        valid &= (pos[None] >= cache_len[:, None] - sliding_window) | \
            (pos[None] < sinks)
    rows = int(valid.sum())
    H = Hkv * G
    row_bytes = (hd + 4) * 2 if int8 else hd * 2 * 2   # K + V (+ scales)
    nbytes = (rows * Hkv * row_bytes + q.numel() * 2 + B * 4 +
              o.numel() * 2 + 2 * l.numel() * 4)
    flops = 4 * rows * H * hd
    bound_ms, bound_by = bound(nbytes, flops)
    out.update(max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
               rows=rows)

    def kernel():
        return da.decode_attention(q, *caches, cache_len,
                                   return_partials=True, **kw)
    kernel_ms = timer.ms(kernel)
    timing = dict(ms_held=timer.ms(kernel, hold=True),
                  host_us=timer.host_us(kernel))
    plain_ms = timer.ms(lambda: da.decode_attention_plain(
        q, *caches, cache_len, return_partials=True, **kw), iters=5)
    library_ms = None
    if softcap == 0.0:
        # yardstick only: SDPA on the same dense cache (pre-dequantized for
        # int8, not timed) with a boolean mask (the NaN slots zeroed first,
        # not timed: SDPA's 0 weight times NaN would poison its output)
        kf, vf = k, v
        if int8:
            kf = (kq.float() * ks[..., None]).bfloat16()
            vf = (vq.float() * vs[..., None]).bfloat16()
        kd = torch.where(valid[:, None, :, None], kf, 0).repeat_interleave(
            G, dim=1)
        vd = torch.where(valid[:, None, :, None], vf, 0).repeat_interleave(
            G, dim=1)
        qd = q.reshape(B, H, 1, hd)
        mask = valid[:, None, None, :]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask)
        library_ms = timer.ms(library)
        timing.update(library_ms_held=timer.ms(library, hold=True),
                      library_host_us=timer.host_us(library))
        del kd, vd
    out.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               **timing, launch=da.launch_geometry(
                   B, Hkv, S, _cuda.sm_count(q.device), G))
    return out


# the dense kernel's two designs, by the mangled names of their kernels
DENSE_MARKERS = [("dense_tc_kernelI", ("hd", "G")),
                 ("dense_lanes_kernelI", ("hd", "G"))]


def dense_design(torch, da, _cuda):
    """The dense kernel's split-KV design at glm4-9b's decode shapes (B=8,
    Hkv=2, G=16, hd=128 at 2K and 16K): its launch geometry and the CTAs
    an SM holds, bf16 and int8; the HMMA count of the library's SASS
    (raises if there is none: the tensor-core design is not in the build);
    registers, shared memory and spill of every instantiation."""
    sm = _cuda.sm_count(torch.device(DEV))
    launch = {}
    for name, S in (("glm4-9b 2K", 2048), ("glm4-9b 16K", 16384)):
        launch[name] = dict(**da.launch_geometry(8, 2, S, sm, 16),
                            ctas_per_sm={
                                t: da.ctas_per_sm(t == "int8", 128, 16)
                                for t in ("bf16", "int8")})
    hmma = sass_count(da._LIB_NAME, "HMMA")
    if not hmma:
        raise AssertionError("the decode_attention library holds no HMMA")
    ptxas = [f"{marker[:-1]} {row}" for marker, names in DENSE_MARKERS
             for row in ptxas_summary(_cuda.BUILD_LOG.get(da._LIB_NAME, ""),
                                      marker, names)]
    return dict(launch=launch, sm_count=sm, hmma=hmma, ptxas=ptxas)


def instantiation_sweep(torch, pda, da, ppa, timer):
    """Every instantiation of the three attention kernels (pool or cache
    dtype × head size × group size; the chunk kernel's group size is a
    launch value, swept at 1, 2 and 16) once against its plain twin at a
    small shape, with a softcap and NaN past every cache_len (values, or
    scales for int8). Returns the checks run and the largest error per
    kernel (toy shapes: the times are not reported)."""
    worst = {"paged_decode": 0.0, "dense_decode": 0.0, "chunk": 0.0}
    n = 0
    for int8 in (False, True):
        for hd in pda.HEAD_DIMS:
            for G in pda.GROUPS:
                kw = dict(B=3, Hkv=2, G=G, hd=hd, lens=[200, 37, 1],
                          seed=G + hd, int8=int8, softcap=30.0)
                r = decode_case(torch, pda, timer, bs=16, library=False,
                                **kw)
                worst["paged_decode"] = max(worst["paged_decode"],
                                            r["max_abs_err"])
                r = dense_decode_case(torch, da, timer, S=200, **kw)
                worst["dense_decode"] = max(worst["dense_decode"],
                                            r["max_abs_err"])
                n += 2
            for G in (1, 2, 16):
                r = prefill_case(torch, ppa, timer, H=2 * G, Hkv=2, hd=hd,
                                 bs=16, P=64, C=70, seed=G + hd, int8=int8,
                                 softcap=30.0)
                worst["chunk"] = max(worst["chunk"], r["max_abs_err"])
                n += 1
    return dict(checks=n, max_abs_err=worst)


def check_scan(name, got, want):
    scale = float(want.abs().max())
    return check_close(name, got, want, rtol=SCAN_RTOL,
                       atol=SCAN_RTOL * max(1.0, scale))


def edge_decays(torch, gen, a):
    """Exact 0 (5 %) and exact 1.0 (25 %) decays sprinkled into ``a``, and a
    run of 1.0 over the whole second 16-step tile of the chunked kernels."""
    pick = torch.rand(a.shape, generator=gen, device=DEV)
    a = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.75, 1.0, a))
    a[:, 16:32] = 1.0
    return a.contiguous()


def ssm_case(torch, ssm, timer, *, B, S, H, P, N, seed, edges=False,
             timed=True):
    """The Mamba2 scan kernel vs its step twin at a prefill shape; inputs
    shaped like the model's (dt-scaled x, decay = exp(-dt)); ``edges`` puts
    exact 0 and 1.0 among the decays. ``timed``: also its times, held and
    unheld, the host time of a call, and its bounds."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=DEV) - 1.0)
    x = torch.randn((B, S, H, P), generator=gen, device=DEV) * dt[..., None]
    Bi = torch.randn((B, S, N), generator=gen, device=DEV)
    Ci = torch.randn((B, S, N), generator=gen, device=DEV)
    decay = torch.exp(-dt)
    if edges:
        decay = edge_decays(torch, gen, decay)
    y = ssm.ssm_scan(x, Bi, Ci, decay)
    sync(torch)
    want = ssm.ssm_scan_plain(x, Bi, Ci, decay)
    out = dict(max_abs_err=check_scan("ssm_scan y", y, want),
               y_scale=float(want.abs().max()))
    if not timed:
        return out
    nbytes = 4 * (x.numel() + Bi.numel() + Ci.numel() + decay.numel() +
                  y.numel())
    # the chunked form's products, one bf16 pass: h·Cᵀ and X̃ᵀB (2·P·N each
    # a step and head), the diagonal block (16·P) and C·Bᵀ (16·N, per step)
    flops = B * S * (H * (4 * P * N + 32 * P) + 32 * N)
    bound_ms, bound_by = bound(nbytes, flops)

    def kernel():
        return ssm.ssm_scan(x, Bi, Ci, decay)
    out.update(
        ms=timer.ms(kernel, iters=9), ms_held=timer.ms(kernel, iters=9,
                                                       hold=True),
        host_us=timer.host_us(kernel),
        # the same launch without the autograd Function around it
        host_us_no_function=timer.host_us(
            lambda: ssm._ssm_scan_forward(x, Bi, Ci, decay)),
        plain_ms=timer.ms(lambda: ssm.ssm_scan_plain(x, Bi, Ci, decay),
                          iters=3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, bytes=nbytes,
        flops=flops,
        # the sequential form's bound, kept for comparison: its fp32 FMAs on
        # the CUDA cores (h·a, x·B, +, and the FMA with C)
        seq_fp32_ops_ms=5 * B * S * H * P * N / FP32_FLOP_PER_S * 1e3)
    return out


def rwkv_case(torch, rwkv, timer, *, B, S, H, P, seed, decays="randn",
              timed=True, twin=None, plain_iters=3):
    """The RWKV6 scan kernel vs its step twin at a prefill shape, bf16
    inputs (the model dtype). ``decays``: "randn", w = exp(-exp(N(0,1) - 2));
    "model", the layer's w = exp(-exp(-6 + noise)) in bf16 (mostly 0.996 or
    exactly 1.0) with exact 0 among them. ``timed``: also its times, held
    and unheld, the host time of a call, and its bounds. ``twin``: the
    plain scan held against (the step twin by default), timed over
    ``plain_iters`` calls (0: the checking call's own time, for a twin
    that runs for seconds)."""
    twin = twin or rwkv.rwkv6_scan_plain
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shape = (B, S, H, P)
    r, k, v = (torch.randn(shape, generator=gen, device=DEV).bfloat16()
               for _ in range(3))
    noise = torch.randn(shape, generator=gen, device=DEV)
    if decays == "model":
        w = torch.exp(-torch.exp(-6.0 + 0.5 * noise))
        pick = torch.rand(shape, generator=gen, device=DEV)
        w = torch.where(pick < 0.02, 0.0, w).bfloat16()
    else:
        w = torch.exp(-torch.exp(noise - 2.0)).bfloat16()
    u = torch.randn((H, P), generator=gen, device=DEV) * 0.5
    y = rwkv.rwkv6_scan(r, k, v, w, u)
    sync(torch)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    want = twin(r, k, v, w, u)
    b.record()
    b.synchronize()
    out = dict(max_abs_err=check_scan("rwkv6_scan y", y, want),
               y_scale=float(want.abs().max()))
    del want
    if not timed:
        return out
    nbytes = 2 * 4 * r.numel() + 4 * u.numel() + 4 * y.numel()
    # the chunked form's tensor-core products, one bf16 pass: r̃·S and
    # k̃ᵀv (2·P² each a step and head), G·v (16·P) and G's cross block (8·P)
    flops = B * S * H * (4 * P * P + 40 * P)
    bound_ms, bound_by = bound(nbytes, flops)

    def kernel():
        return rwkv.rwkv6_scan(r, k, v, w, u)
    out.update(
        ms=timer.ms(kernel, iters=9), ms_held=timer.ms(kernel, iters=9,
                                                       hold=True),
        host_us=timer.host_us(kernel),
        host_us_no_function=timer.host_us(
            lambda: rwkv._rwkv6_scan_forward(r, k, v, w, u)),
        plain_ms=timer.ms(lambda: twin(r, k, v, w, u), iters=plain_iters,
                          warmup=1) if plain_iters else a.elapsed_time(b),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, bytes=nbytes,
        flops=flops,
        # the sequential form's bound, kept for comparison: its fp32
        # operations on the CUDA cores (r·S, w·S + k⊗v; the bonus)
        seq_fp32_ops_ms=B * S * H * (5 * P * P + 5 * P) / FP32_FLOP_PER_S
        * 1e3)
    return out


def scan_design(ssm, rwkv):
    """The count of HMMA (mma.sync) instructions in each scan library's
    SASS; raises if one has none (the tensor-core path is missing)."""
    hmma = {lib: sass_count(lib, "HMMA")
            for lib in (ssm._LIB_NAME, rwkv._LIB_NAME)}
    if not all(hmma.values()):
        raise AssertionError(f"no HMMA in a scan kernel's SASS: {hmma}")
    return json.dumps({"hmma_instructions_in_sass": hmma})


# ---------------------------------------------------------------------------
# phases 8-9: recurrent models end to end; the card against the CPU
# ---------------------------------------------------------------------------
def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def generate(transformer, cfg, params, batch, n_steps, max_seq, device):
    """prefill of ``batch`` ({"tokens"}, and "frames" for an
    encoder-decoder), then ``n_steps`` greedy decode_step +
    apply_decode_updates. Returns (per-step logits list (prefill's first),
    cache)."""
    logits, cache = transformer.prefill(params, cfg, batch, max_seq,
                                        device=device)
    out = [logits]
    for _ in range(n_steps):
        logits, upd = transformer.decode_step(
            params, cfg, logits.argmax(-1).int(), cache, device=device)
        cache = transformer.apply_decode_updates(cache, upd)
        out.append(logits)
    return out, cache


def recurrent_e2e(torch, np, transformer, cfg, counters, want_launches):
    """Phase 8: one model at full width and depth: 8 prompts of 2048
    tokens, prefill, 32 greedy decode steps, then 3 profiled steps and one
    profiled prefill (device busy, the scan kernel's device time).
    ``want_launches(n)``: every kernel's launches for prefill + n steps."""
    B, S, n_new = 8, 2048, 32
    t0 = time.perf_counter()
    params = transformer.init_params(0, cfg, device=DEV)
    sync(torch)
    weights = torch.cuda.memory_allocated()
    log(f"e2e {cfg.name}: L={cfg.num_layers} d={cfg.d_model} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} weights "
        f"{weights / 2**30:.2f} GiB init {time.perf_counter() - t0:.1f} s")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               size=(B, S)).tolist()
    max_seq = S + n_new + 3
    # warm-up (library handles, allocator) on a short prompt, not counted
    generate(transformer, cfg, params, {"tokens": [t[:64] for t in
                                            tokens[:2]]}, 2,
             64 + 2, DEV)
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(params, cfg, {"tokens": tokens},
                                        max_seq, device=DEV)
    sync(torch)
    prefill_s = time.perf_counter() - t0
    after_prefill = counters.read()
    step_ms = []
    out = [logits]
    for _ in range(n_new):
        t1 = time.perf_counter()
        logits, upd = transformer.decode_step(
            params, cfg, logits.argmax(-1).int(), cache, device=DEV)
        cache = transformer.apply_decode_updates(cache, upd)
        sync(torch)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        out.append(logits)
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated()
    expect_launches(after_prefill, want_launches(0), f"e2e {cfg.name} prefill")
    expect_launches(launches, want_launches(n_new),
                    f"e2e {cfg.name} (prefill + {n_new} decode steps)")
    for i, lg in enumerate(out):
        if lg.shape != (B, cfg.vocab_size) or \
                not bool(torch.isfinite(lg.float()).all()):
            raise AssertionError(f"{cfg.name}: logits {i} of shape "
                                 f"{tuple(lg.shape)} not finite")
    if int(cache["len"].min()) != S + n_new:
        raise AssertionError(f"{cfg.name}: cache len {cache['len'].tolist()}")
    state = {k: v for k, v in cache.items() if k != "len"}
    decode_s = sum(step_ms) / 1e3
    result = dict(
        batch=B, prompt_tokens=S, new_tokens=n_new, prefill_s=prefill_s,
        prefill_tok_s=B * S / prefill_s,
        decode_step_ms_median=sorted(step_ms)[len(step_ms) // 2],
        decode_step_ms=[round(t, 2) for t in step_ms],
        decode_tok_s=B * n_new / decode_s, peak_gib=peak / 2**30,
        weights_gib=weights / 2**30, cache_bytes=tree_bytes(state),
        cache_shapes={k: list(v.shape) for k, v in state.items()},
        tokens_first_row=[int(lg[0].argmax()) for lg in out[1:9]])

    def step():
        nonlocal logits, cache
        logits, upd = transformer.decode_step(
            params, cfg, logits.argmax(-1).int(), cache, device=DEV)
        cache = transformer.apply_decode_updates(cache, upd)

    result["profile"] = profile_window(torch, step, 3, B,
                                       kernels=("dense_decode_kernel",))
    del logits, cache, out, upd, state
    torch.cuda.empty_cache()
    result["prefill_profile"] = profile_window(
        torch, lambda: transformer.prefill(params, cfg, {"tokens": tokens},
                                           max_seq, device=DEV),
        1, B, kernels=("ssm_scan_kernel", "rwkv6_scan_kernel"))
    log(f"e2e {cfg.name}: {json.dumps(result)}")
    return launches, result


def card_vs_cpu(torch, np, transformer, cfg, counters, S=128, frames=0):
    """Phase 9: the same calls on the card and on the CPU (the plain twins)
    at full width and reduced depth, same bf16 weights: B=2, S tokens
    (after ``frames`` stub frame rows of an encoder-decoder), then 4
    greedy decode steps fed the card's tokens. Every step's logits must
    agree by row cosine."""
    from repro_torch.tree import tree_map
    B, n_new = 2, 4
    params = transformer.init_params(1, cfg, device=DEV)
    cpu_params = tree_map(lambda a: a.cpu(), params)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, S)).tolist()}
    if frames:
        batch["frames"] = rng.standard_normal(
            (B, frames, cfg.d_model)).astype(np.float32)
    counters.reset()
    gpu, gcache = generate(transformer, cfg, params, batch, n_new,
                           S + n_new, DEV)
    launches = {k: n for k, n in counters.read().items() if n}
    # the CPU decodes the card's greedy tokens, so both see the same inputs
    logits, cache = transformer.prefill(cpu_params, cfg, batch, S + n_new,
                                        device="cpu")
    cpu = [logits]
    for lg in gpu[:-1]:
        logits, upd = transformer.decode_step(
            cpu_params, cfg, lg.argmax(-1).int().cpu(), cache, device="cpu")
        cache = transformer.apply_decode_updates(cache, upd)
        cpu.append(logits)
    cos = [min(cosine(g[i].cpu(), c[i]) for i in range(B))
           for g, c in zip(gpu, cpu)]
    log(f"card vs CPU {cfg.name} (L={cfg.num_layers}, full width, B={B}, "
        f"S={S}, {n_new} steps): min row cosine per step "
        f"{[round(c, 6) for c in cos]} (need >= {MIN_COSINE}); card "
        f"launches {launches}")
    if not min(cos) >= MIN_COSINE:
        raise AssertionError(f"card vs CPU {cfg.name}: cosine {min(cos)} < "
                             f"{MIN_COSINE}")
    del params, cpu_params, gcache, cache
    return dict(min_row_cosine=cos, launches=launches)


# ---------------------------------------------------------------------------
# phases 13-16: the registry's other dense archs at full width, the
# dense-cache path and speculative decoding
# ---------------------------------------------------------------------------
def n_params(params):
    from repro_torch.tree import tree_leaves
    return sum(a.numel() for a in tree_leaves(params))


def load_model(torch, registry, transformer, arch, seed=0, **overrides):
    """A registry config (with ``overrides``: the depth a phase cuts) and
    random bf16 weights from ``seed`` on the card."""
    cfg = registry.get_config(arch).replace(**overrides)
    t0 = time.perf_counter()
    params = transformer.init_params(seed, cfg, device=DEV)
    sync(torch)
    log(f"{arch}: L={cfg.num_layers} d={cfg.d_model} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}: {n_params(params) / 1e9:.2f}"
        f" B parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, init {time.perf_counter() - t0:.1f} s")
    return cfg, params


def release(torch):
    """Return the memory of what the caller just deleted to the card (the
    phases never hold two full-width models at once)."""
    gc.collect()
    torch.cuda.empty_cache()


def engine_run(torch, cfg, params, econf, prompts, counters, new=32,
               tops=None):
    """``prompts`` through a fresh LLMEngine (compiled graphs) after a
    small warm-up engine: every request finishes with ``new`` tokens.
    Returns the engine, the requests, the launches and the serving
    summary; ``tops`` records the top logits of every sampled token."""
    from repro_torch.serving import LLMEngine

    warm = LLMEngine(cfg, params, econf.replace(num_blocks=64), device=DEV)
    warm.submit(make_requests([list(range(1, 41))], 2))
    warm.run()
    del warm
    reqs = make_requests(prompts, new)
    eng = LLMEngine(cfg, params, econf, device=DEV)
    if tops is not None:
        record_top([eng], tops)
    launches, wall, peak = serve(torch, eng, reqs, counters)
    check_finished(cfg, reqs, new)
    return eng, reqs, launches, serving_summary(
        eng.stats, reqs, wall, peak, eng.compiled, eng.compiled_prefill)


def paged_want(L, steps, chunks, workers=1, int8=False):
    """The launches of an engine run: L × steps × workers decode and L ×
    chunks chunk launches of the pool's kernels, nothing else."""
    dec, chunk = ("paged_decode_attention_int8",
                  "paged_prefill_chunk_attention_int8") if int8 else \
        ("paged_decode_attention", "paged_prefill_chunk_attention")
    want = {"paged_decode_attention": 0, "paged_prefill_chunk_attention": 0,
            "paged_decode_attention_int8": 0,
            "paged_prefill_chunk_attention_int8": 0, **NO_NEW_KERNEL}
    want.update({dec: L * steps * workers, chunk: L * chunks})
    return want


def launch_gate(launches, eng, L, workers, int8, what):
    st = eng.stats
    want = paged_want(L, st.steps, st.prefill_chunks_run, workers, int8)
    return gate(launches == want, f"{what}: launches {launches} != {want} "
                f"({st.steps} steps, {st.prefill_chunks_run} chunks)")


def glm4_e2e(torch, np, registry, transformer, counters):
    """Phase 13: glm4-9b at full width and depth (40 layers, d 4096, 32
    heads over 2 kv heads: G = 16; vocab 151552) through LLMEngine with
    compiled graphs, 8 requests of 300-2000 prompt tokens and 32 new: (a)
    homogeneous bf16; (b) attention_pool head over 2 workers (one kv head,
    16 query heads each) on an int8 pool; (c) the block partition over 4
    workers, bf16. Then (d) glm4-9b-sinks (window 8192, 4 sinks, the same
    weights): one request of 9216 prompt tokens and 16 decode steps, with
    one layer's decode and one chunk's attention over the real pool held
    against their plain twins at the last step."""
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.serving import EngineConfig, State

    cfg, params = load_model(torch, registry, transformer, "glm4-9b")
    L, hd = cfg.num_layers, cfg.resolved_head_dim
    prng = np.random.default_rng(13)
    plens = prng.integers(300, 2001, size=8)
    prompts = [prng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in plens]
    base = EngineConfig(block_size=16, num_blocks=2048, max_batch=8,
                        prefill_chunk_tokens=512)
    out = {"prompt_lengths": plens.tolist(), "parameters": n_params(params)}

    eng, reqs, launches, summ = engine_run(torch, cfg, params, base, prompts,
                                           counters)
    launch_gate(launches, eng, L, 1, False, "glm4-9b (a) homogeneous bf16")
    ref_tokens = [list(r.output) for r in reqs]
    bf16_resident = eng.stats.kv_pool_bytes_resident
    out["a_homogeneous_bf16"] = summ
    log(f"glm4-9b (a) homogeneous bf16: {json.dumps(summ)}")
    del eng, reqs
    release(torch)

    econf = base.replace(placement="attention_pool", partition="head",
                         attention_workers=2, kv_dtype="int8")
    eng, reqs, launches, summ = engine_run(torch, cfg, params, econf,
                                           prompts, counters)
    launch_gate(launches, eng, L, 2, True, "glm4-9b (b) head int8")
    ratio = eng.stats.kv_pool_bytes_resident / bf16_resident
    e = torch.finfo(cfg.dtype).bits // 8       # 2: the model's bf16
    want = (hd + 4) / (e * hd)
    gate(abs(ratio / want - 1) <= 0.01, f"glm4-9b (b): int8 / bf16 pool "
         f"bytes {ratio} != (hd+4)/({e}·hd) = {want}")
    tlog = transfer_log_check(cfg, eng, prompts, "int8")
    gate(tlog["ok"], f"glm4-9b (b): TransferLog {tlog} != the §3.1 formulas")
    summ.update(resident_ratio=ratio, transfer_log=tlog,
                per_worker_kv_bytes=eng.pool.per_worker_kv_bytes)
    out["b_head_int8"] = summ
    log(f"glm4-9b (b) attention_pool head x2 int8: {json.dumps(summ)}")
    del eng, reqs
    release(torch)

    econf = base.replace(placement="attention_pool", partition="block",
                         attention_workers=4)
    tops = {}
    eng, reqs, launches, summ = engine_run(torch, cfg, params, econf,
                                           prompts, counters, tops=tops)
    launch_gate(launches, eng, L, 4, False, "glm4-9b (c) block x4 bf16")
    streams = stream_gate("glm4-9b (c) vs (a)", reqs, ref_tokens, tops)
    tlog = transfer_log_check(cfg, eng, prompts, "bf16")
    gate(tlog["ok"], f"glm4-9b (c): TransferLog {tlog} != the §3.1 formulas")
    summ.update(**streams, transfer_log=tlog, kv_shards=eng.kv.n_shards,
                per_worker_kv_bytes=eng.pool.per_worker_kv_bytes)
    out["c_block4_bf16"] = summ
    log(f"glm4-9b (c) attention_pool block x4 bf16: {json.dumps(summ)}")
    del eng, reqs
    release(torch)

    # (d) the sinks variant: window and sinks bite on a 9216-token prompt
    scfg = registry.get_config("glm4-9b", variant="sinks")
    sw, sinks = scfg.sliding_window, scfg.attention_sinks
    prompt = prng.integers(0, cfg.vocab_size, size=9216).tolist()
    econf = base.replace(num_blocks=1024, max_batch=1)
    from repro_torch.serving import LLMEngine
    eng = LLMEngine(scfg, params, econf, device=DEV)
    req, = make_requests([prompt], 16)
    counters.reset()
    sync(torch)
    t0 = time.perf_counter()
    eng.submit([req])
    while len(req.output) < 15:
        eng.step()
    sync(torch)
    wall = time.perf_counter() - t0
    launches = counters.read()
    tables, lens = eng.kv.block_table_batch([req.rid])
    gen = torch.Generator(device=DEV).manual_seed(14)
    layer = L - 1
    tbl = torch.as_tensor(tables, device=DEV)
    clen = torch.as_tensor(lens, device=DEV)
    q = torch.randn((1, cfg.num_kv_heads, cfg.gqa_group, hd), generator=gen,
                    device=DEV).bfloat16()
    # the kernel's window: the serving window less the incoming token
    kw = dict(sliding_window=sw - 1, attention_sinks=sinks,
              return_partials=True)
    pools = (eng.kv.k_pool[layer], eng.kv.v_pool[layer])
    o, l_, m = pda.paged_decode_attention(q, *pools, tbl, clen, **kw)
    po, pl, pm = pda.paged_decode_attention_plain(q, *pools, tbl, clen, **kw)
    dec = dict(cache_len=int(lens[0]), max_abs_err=check_close(
        "sinks decode o", o, po))
    check_close("sinks decode l", l_, pl, rtol=1e-3, atol=1e-6)
    check_close("sinks decode m", m, pm, rtol=0.0, atol=1e-3)
    P, C = 540 * 16, 512              # a chunk at [8640, 9152)
    table = eng.kv.gather_prefix_indices(req.rid, P)
    qc = torch.randn((C, cfg.num_heads, hd), generator=gen,
                     device=DEV).bfloat16()
    kc = torch.randn((C, cfg.num_kv_heads, hd), generator=gen,
                     device=DEV).bfloat16()
    vc = torch.randn_like(kc)
    ckw = dict(sliding_window=sw, attention_sinks=sinks)
    got = ppa.paged_prefill_chunk_attention(qc, *pools, table, kc, vc, **ckw)
    want = ppa.paged_prefill_chunk_attention_plain(qc, *pools, table, kc, vc,
                                                   **ckw)
    chunk = dict(P=P, C=C, max_abs_err=check_close("sinks chunk", got, want))
    eng.step()
    st = eng.stats
    gate(req.state == State.FINISHED and len(req.output) == 16,
         f"glm4-9b-sinks: the request did not finish: {len(req.output)}")
    want_l = paged_want(L, st.steps - 1, st.prefill_chunks_run)
    gate(launches == want_l, f"glm4-9b-sinks: launches {launches} != "
         f"{want_l}")
    out["d_sinks"] = dict(prompt=len(prompt), window=sw, sinks=sinks,
                          wall_s_15_tokens=wall, ttft_s=st.request_ttfts[0]
                          if st.request_ttfts else None,
                          chunks=st.prefill_chunks_run, decode_steps=st.steps,
                          decode_vs_twin=dec, chunk_vs_twin=chunk,
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"glm4-9b-sinks (d): {json.dumps(out['d_sinks'])}")
    del eng, req
    release(torch)
    return cfg, params, out


def dense_cache_e2e(torch, np, transformer, cfg, params, counters):
    """Phase 14: the dense-cache path at glm4-9b's width. ``attend`` with
    head and request partitions (2 workers each) over one dense bf16 cache
    and an int8 one (B=8, S=4096): the partitions agree with each other and
    with the plain twins on the CPU, ``per_worker_kv_bytes`` follows the
    reference formula; then ``prefill`` -> ``decode_step`` ->
    ``apply_decode_updates`` over an int8 dense cache with glm4-9b's first
    4 layers against the bf16 full forward (cosine >= 0.999, the same
    argmax), and the same steps through the listed layout equal the
    stacked ones bit for bit."""
    from repro_torch.kernels.decode_attention import decode_attention_int8
    from repro_torch.models.kv_quant import quantize_kv
    from repro_torch.serving import AttentionWorkerPool
    from repro_torch.tree import tree_map

    out = {}
    B, S, Hkv, H, hd = 8, 4096, cfg.num_kv_heads, cfg.num_heads, \
        cfg.resolved_head_dim
    gen = torch.Generator(device=DEV).manual_seed(15)
    q = torch.randn((B, H, hd), generator=gen, device=DEV).bfloat16()
    kc = torch.randn((B, Hkv, S, hd), generator=gen, device=DEV).bfloat16()
    vc = torch.randn_like(kc)
    kn = torch.randn((B, Hkv, hd), generator=gen, device=DEV).bfloat16()
    vn = torch.randn_like(kn)
    lens = torch.tensor(np.random.default_rng(15).integers(1, S + 1, size=B),
                        dtype=torch.int32, device=DEV)
    kq, ks = quantize_kv(kc)
    vq, vs = quantize_kv(vc)
    for tag, caches, skw in (("bf16", (kc, vc), {}),
                             ("int8", (kq, vq), dict(k_scale=ks,
                                                     v_scale=vs))):
        res, outs = {}, {}
        for part in ("head", "request"):
            pool = AttentionWorkerPool(cfg, n_workers=2, partition=part)
            counters.reset()
            outs[part] = pool.attend(q, *caches, lens, kn, vn, **skw)
            sync(torch)
            res[part] = dict(launches={k: n for k, n in
                                       counters.read().items() if n},
                             per_worker_kv_bytes=pool.per_worker_kv_bytes)
            per = 2 * caches[0].numel() // 2 * 2
            gate(pool.per_worker_kv_bytes == [per, per],
                 f"attend {tag} {part}: per_worker_kv_bytes "
                 f"{pool.per_worker_kv_bytes} != [{per}, {per}]")
        cpu = AttentionWorkerPool(cfg, n_workers=2, partition="head").attend(
            *(t.cpu() for t in (q, *caches, lens, kn, vn)),
            **{k: v.cpu() for k, v in skw.items()})
        res["head_vs_request_max_abs_err"] = check_close(
            f"attend {tag} head vs request", outs["head"], outs["request"])
        res["head_vs_cpu_twin_max_abs_err"] = check_close(
            f"attend {tag} head vs the CPU twin", outs["head"].cpu(), cpu)
        kernel = "decode_attention_int8" if skw else "decode_attention"
        for part in ("head", "request"):
            gate(res[part]["launches"] == {kernel: 2},
                 f"attend {tag} {part}: launches {res[part]['launches']}")
        out[f"attend_{tag}"] = res
        log(f"attend {tag} B={B} S={S} glm4-9b width: {json.dumps(res)}")
    del kc, vc, kq, vq, ks, vs

    # an int8 dense cache through the serve step, 4 layers
    c4 = cfg.replace(num_layers=4)
    c8 = c4.replace(kv_cache_bits=8)
    p4 = dict(params, layers=tree_map(lambda a: a[:4], params["layers"]))
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size,
                                              size=(2, 258)).tolist()
    with torch.inference_mode():
        full, _ = transformer.forward(p4, c4, {"tokens": toks},
                                      device=DEV)
        counters.reset()
        _, cache = transformer.prefill(p4, c8, {"tokens": [t[:-2] for t in
                                                           toks]},
                                       max_seq=264, device=DEV)
        lg1, upd = transformer.decode_step(p4, c8, [t[-2] for t in toks],
                                           cache, device=DEV)
        cache = transformer.apply_decode_updates(cache, upd)
        lg2, _ = transformer.decode_step(p4, c8, [t[-1] for t in toks],
                                         cache, device=DEV)
        sync(torch)
        launches = {k: n for k, n in counters.read().items() if n}
        # the listed layout: the same prefill and first step, bit for bit
        listed = dict(p4, layers=[transformer._layer(p4["layers"], i)
                                  for i in range(4)])
        _, lcache = transformer.prefill(listed, c8, {"tokens": [
            t[:-2] for t in toks]}, max_seq=264, device=DEV)
        l_lg1, _ = transformer.decode_step(listed, c8, [t[-2] for t in toks],
                                           lcache, device=DEV)
        _, scache = transformer.prefill(p4, c8, {"tokens": [
            t[:-2] for t in toks]}, max_seq=264, device=DEV)
        s_lg1, _ = transformer.decode_step(p4, c8, [t[-2] for t in toks],
                                           scache, device=DEV)
    cos = [min(cosine(a[i], b[i]) for i in range(2))
           for a, b in ((full[:, -2], lg1), (full[:, -1], lg2))]
    same = bool((full[:, -1].argmax(-1) == lg2.argmax(-1)).all())
    bitwise = torch.equal(l_lg1, s_lg1) and all(
        torch.equal(torch.stack(lcache[k]), scache[k])
        for k in ("k", "v", "k_scale", "v_scale"))
    res = dict(min_row_cosine=cos, same_argmax=same, launches=launches,
               listed_equals_stacked_bitwise=bitwise,
               cache_dtype=str(cache["k"].dtype))
    gate(min(cos) >= MIN_COSINE and same, f"int8 dense cache vs the bf16 "
         f"forward: cosine {cos}, same argmax {same}")
    gate(launches == {"decode_attention_int8": 2 * c4.num_layers},
         f"int8 dense serve step: launches {launches}")
    gate(bitwise, "the listed layout's step differs from the stacked one")
    out["int8_dense_serve_step"] = res
    log(f"int8 dense cache, glm4-9b width, 4 layers, B=2 S=256: "
        f"{json.dumps(res)}")
    # the int8 entry's launches on this path: attend (both partitions)
    # and the serve step
    return out, launches.get("decode_attention_int8", 0) + sum(
        out["attend_int8"][p]["launches"].get("decode_attention_int8", 0)
        for p in ("head", "request"))


def dense_step_timing(torch, np, transformer, cfg, params, counters,
                      n_steps=10):
    """Phase 14's timed dense-cache decode step: ``decode_step`` of the
    model in ``params`` (glm4-9b at full depth) over a bf16 and an int8
    dense cache of B = 8 sequences whose lengths are drawn in 1-2048
    (``default_rng(17)``), random K/V (the int8 cache as ``quantize_kv``
    stores them). Each step reads the same cache (its updates are not
    applied). Reports the step's wall p50 over ``n_steps`` steps, one
    step's launches (one dense launch a layer, gated), finite logits
    (gated), and a profiled window of 3 steps: device-busy ms, idle share
    and the dense kernel's device ms a step."""
    from repro_torch.models.kv_quant import quantize_kv

    B, max_seq = 8, 2048
    lens = np.random.default_rng(17).integers(1, max_seq + 1, size=B)
    tokens = np.random.default_rng(18).integers(0, cfg.vocab_size,
                                                size=B).tolist()
    out = {"lens": lens.tolist()}
    for tag in ("bf16", "int8"):
        c = cfg.replace(kv_cache_bits=8) if tag == "int8" else cfg
        cache = transformer.init_cache(c, B, max_seq, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(19)
        for i in range(c.num_layers):        # a layer at a time
            for key in ("k", "v"):
                x = torch.randn(cache[key].shape[1:], generator=gen,
                                device=DEV)
                if tag == "int8":
                    cache[key][i], cache[f"{key}_scale"][i] = quantize_kv(x)
                else:
                    cache[key][i] = x
        cache["len"] = torch.tensor(lens, dtype=torch.int32, device=DEV)
        cache_gib = sum(t.numel() * t.element_size() for k, t in
                        cache.items() if k != "len") / 2**30
        kernel = "decode_attention_int8" if tag == "int8" \
            else "decode_attention"

        def step():
            return transformer.decode_step(params, c, tokens, cache,
                                           device=DEV)
        with torch.inference_mode():
            counters.reset()
            logits, _ = step()
            sync(torch)
            launches = {k: n for k, n in counters.read().items() if n}
            gate(launches == {kernel: c.num_layers},
                 f"timed dense step {tag}: launches {launches}")
            gate(bool(torch.isfinite(logits).all()),
                 f"timed dense step {tag}: non-finite logits")
            walls = []
            for _ in range(n_steps):
                sync(torch)
                t0 = time.perf_counter()
                step()
                sync(torch)
                walls.append((time.perf_counter() - t0) * 1e3)
            prof = profile_window(torch, step, 3, B, kernels=("dense_",))
        prof["dense_kernel_ms"] = prof.pop("dense__ms")
        out[tag] = dict(step_ms_p50=sorted(walls)[n_steps // 2],
                        step_ms=[round(w, 3) for w in walls],
                        launches=launches, cache_gib=cache_gib, **prof)
        log(f"timed dense-cache step {tag}, {cfg.name} L={c.num_layers} "
            f"B={B}: {json.dumps(out[tag])}")
        del cache, logits
        torch.cuda.empty_cache()
    return out


def dense_step_main(src) -> int:
    """``chip_smoke.py --dense-step SRC``: phase 14's timed dense-cache
    step alone, on the ``repro_torch`` of the checkout whose ``src/`` is
    SRC (a parent commit unpacked with ``git archive``), with glm4-9b's
    weights of its own: the same figures from two trees on one card."""
    sys.path.insert(0, str(Path(src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import registry
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import rwkv6_scan as rwkv
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.models import transformer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"repro_torch from {Path(repro_torch.__file__).parent}")
    cfg, params = load_model(torch, registry, transformer, "glm4-9b")
    out = dense_step_timing(torch, np, transformer, cfg, params,
                            Launches(pda, ppa, da, ssm, rwkv))
    log(json.dumps({"dense_step": out, "src": str(src)}))
    if FAILED:
        raise AssertionError(f"{len(FAILED)} gate(s) failed: {FAILED}")
    return 0


def other_dense_e2e(torch, np, registry, transformer, counters):
    """Phase 15: llama3-70b (the paper's model) at full width and 8 of 80
    layers through LLMEngine, attention_pool head over 4 workers (2 kv
    heads each) on an int8 pool; pixtral-12b at full width and 8 layers
    through ``prefill`` with 1024 frontend embeddings, then 8 dense
    ``decode_step`` s; tinyllama-1.1b at full width and depth, homogeneous
    bf16. Every request finishes and the launch counts hold."""
    from repro_torch.serving import EngineConfig

    out = {}
    prng = np.random.default_rng(17)
    base = EngineConfig(block_size=16, num_blocks=1024, max_batch=8,
                        prefill_chunk_tokens=512)

    cfg, params = load_model(torch, registry, transformer, "llama3-70b",
                             num_layers=8)
    prompts = [prng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in prng.integers(300, 1201, size=8)]
    econf = base.replace(placement="attention_pool", partition="head",
                         attention_workers=4, kv_dtype="int8")
    eng, reqs, launches, summ = engine_run(torch, cfg, params, econf,
                                           prompts, counters, new=16)
    launch_gate(launches, eng, cfg.num_layers, 4, True,
                "llama3-70b (8 layers) head x4 int8")
    tlog = transfer_log_check(cfg, eng, prompts, "int8")
    gate(tlog["ok"], f"llama3-70b: TransferLog {tlog}")
    summ.update(parameters=n_params(params), transfer_log=tlog)
    out["llama3_70b_8_layers_head4_int8"] = summ
    log(f"llama3-70b, 8 of 80 layers, head x4 int8: {json.dumps(summ)}")
    del eng, reqs, params
    release(torch)

    cfg, params = load_model(torch, registry, transformer, "pixtral-12b",
                             num_layers=8)
    B, S, F, n_new = 2, 128, cfg.frontend_tokens, 8
    gen = torch.Generator(device=DEV).manual_seed(18)
    front = torch.randn((B, F, cfg.d_model), generator=gen,
                        device=DEV).bfloat16()
    toks = prng.integers(0, cfg.vocab_size, size=(B, S)).tolist()
    counters.reset()
    sync(torch)
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, cache = transformer.prefill(
            params, cfg, {"tokens": toks, "frontend": front},
            max_seq=F + S + n_new, device=DEV)
        sync(torch)
        prefill_s = time.perf_counter() - t0
        finite = bool(torch.isfinite(logits).all())
        for _ in range(n_new):
            logits, upd = transformer.decode_step(
                params, cfg, logits.argmax(-1), cache, device=DEV)
            cache = transformer.apply_decode_updates(cache, upd)
            finite &= bool(torch.isfinite(logits).all())
    sync(torch)
    launches = {k: n for k, n in counters.read().items() if n}
    res = dict(parameters=n_params(params), frontend_tokens=F,
               prompt_tokens=S, prefill_s=prefill_s,
               wall_s=time.perf_counter() - t0,
               cache_len=cache["len"].tolist(),
               finite=finite, launches=launches)
    gate(finite and logits.shape == (B, cfg.vocab_size) and
         cache["len"].tolist() == [F + S + n_new] * B,
         f"pixtral-12b: logits {tuple(logits.shape)} finite {finite} "
         f"len {cache['len'].tolist()}")
    gate(launches == {"decode_attention": cfg.num_layers * n_new},
         f"pixtral-12b: launches {launches}")
    out["pixtral_12b_8_layers"] = res
    log(f"pixtral-12b, 8 of 40 layers, {F} frontend embeddings: "
        f"{json.dumps(res)}")
    del cache, logits, upd, front, params
    release(torch)

    cfg, params = load_model(torch, registry, transformer, "tinyllama-1.1b")
    prompts = [prng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in prng.integers(300, 2001, size=8)]
    eng, reqs, launches, summ = engine_run(torch, cfg, params, base, prompts,
                                           counters)
    launch_gate(launches, eng, cfg.num_layers, 1, False,
                "tinyllama-1.1b homogeneous bf16")
    summ["parameters"] = n_params(params)
    out["tinyllama_1_1b_homogeneous_bf16"] = summ
    log(f"tinyllama-1.1b, full depth, homogeneous bf16: {json.dumps(summ)}")
    del eng, reqs, params
    release(torch)
    return out


def speculative_e2e(torch, np, registry, transformer):
    """Phase 16: greedy speculative decoding. Target: llama3-8b at full
    width and 4 layers; draft: the same config at 1 layer (the target's
    first layer, its embeddings and head: the same vocabulary). The
    speculative tokens must equal plain greedy decoding of the target, or
    part from it only at a bf16 near-tie of the target's logits."""
    from repro_torch.serving.speculative import (greedy_generate,
                                                 speculative_generate)
    from repro_torch.tree import tree_map

    cfg, params = load_model(torch, registry, transformer, "llama3-8b",
                             num_layers=4)
    dcfg = cfg.replace(num_layers=1)
    dparams = dict(params, layers=tree_map(lambda a: a[:1],
                                           params["layers"]))
    prompt = np.random.default_rng(19).integers(0, cfg.vocab_size,
                                                size=64).tolist()
    n_new = 24
    sync(torch)
    t0 = time.perf_counter()
    want = greedy_generate(params, cfg, prompt, n_new, device=DEV)
    greedy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, stats = speculative_generate(params, cfg, dparams, dcfg, prompt,
                                      n_new, k=4, device=DEV)
    spec_s = time.perf_counter() - t0
    pos = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
               None)
    tie = None
    if pos is not None:     # the target's logits where the two part
        with torch.inference_mode():
            lg = transformer.forward(params, cfg, {"tokens": [
                prompt + want[:pos]]}, device=DEV)[0][0, -1]
        tie = dict(position=pos, greedy=want[pos], speculative=got[pos],
                   gap_bf16_ulps=gap_ulps(lg, got[pos]))
    res = dict(tokens=n_new, equal=got == want, first_difference=tie,
               stats=dict(dataclasses.asdict(stats),
                          acceptance_rate=stats.acceptance_rate,
                          tokens_per_target_call=stats.tokens_per_target_call),
               greedy_s=greedy_s, speculative_s=spec_s)
    gate(len(got) == n_new and (tie is None or
                                tie["gap_bf16_ulps"] <= NEAR_TIE_ULPS),
         f"speculative vs greedy: {res}")
    log(f"speculative decoding, llama3-8b 4 layers / draft 1 layer: "
        f"{json.dumps(res)}")
    del params, dparams
    release(torch)
    return res


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phases 17-18: the moe family (qwen3-moe, kimi-k2) and gemma2-27b
# ---------------------------------------------------------------------------
# qwen3's prompt lengths: at most 256 or multiples of 256, the lengths whose
# routing groups divide them (moe_forward refuses the rest, as the
# reference asserts)
MOE_PROMPT_LENGTHS = (128, 200, 256, 512, 768, 1024, 1536, 2048)


def moe_transfer_check(cfg, eng):
    """The moe_offload engine's two wire logs after a run without chunks:
    the attention pool's against the §3.1 formula
    (``expected_transfer_bytes`` of the decode tokens, 2·L transfers a
    step) and the expert pool's against ``transfer_bytes_moe`` of the
    decode tokens (2·L transfers a step)."""
    from repro_torch.serving import (expected_transfer_bytes,
                                     transfer_bytes_moe)

    st = eng.stats
    tokens, L = st.tokens_generated, cfg.num_layers
    alog, elog = eng.transfer_log, eng.expert_pool.log
    got = dict(attention_bytes=alog.total,
               attention_transfers=alog.transfers,
               expert_bytes=elog.total, expert_transfers=elog.transfers)
    want = dict(attention_bytes=expected_transfer_bytes(cfg, tokens),
                attention_transfers=2 * L * st.steps,
                expert_bytes=transfer_bytes_moe(cfg, tokens),
                expert_transfers=2 * L * st.steps)
    return dict(got, decode_tokens=tokens, ok=got == want)


def eager_step(torch, pl, params, kv, ids, tokens):
    """The placement's decode step run eagerly at the engine's state."""
    import numpy as np

    from repro_torch.serving.placement import device_operands

    scales = {} if kv.k_scale is None else dict(k_scale_pool=kv.k_scale,
                                                v_scale_pool=kv.v_scale)
    tables, lens = kv.block_table_batch(ids)
    extra = pl.decode_extra_args(kv, ids)
    tk, tb, ln = device_operands([np.asarray(tokens, np.int32), tables,
                                  lens], DEV)
    return pl.decode_fn()(params, tk, kv.k_pool, kv.v_pool, tb, ln,
                          *device_operands(extra, DEV), **scales)


def moe_layers_vs_cpu(torch, cfg, params, step):
    """Each MoE layer's output on the card against the CPU at one decode
    state: ``step()`` runs one eager decode step with every
    ``moe_forward`` call's input and output recorded; each layer's input
    then runs through ``moe_forward`` on the CPU with that layer's
    weights (bf16 both). Returns the cosine of every layer."""
    from repro_torch.models import blocks, moe

    seen = []
    orig = blocks.moe_forward

    def recorded(p, c, x, group_size=256):
        y, aux = orig(p, c, x, group_size)
        seen.append((x.cpu(), y.cpu()))
        return y, aux

    blocks.moe_forward = recorded
    try:
        step()
    finally:
        blocks.moe_forward = orig
    if len(seen) != cfg.num_layers:
        raise AssertionError(f"{len(seen)} MoE calls in a step of "
                             f"{cfg.num_layers} layers")
    cos = []
    for i, (x, y) in enumerate(seen):
        layer = {k: v[i].cpu() for k, v in params["layers"]["moe"].items()}
        yc, _ = moe.moe_forward(layer, cfg, x)
        cos.append(cosine(y, yc))
    return cos


def moe_prefill_gates(torch, cfg, params, kv, counters, lengths, seed=19):
    """A fresh ``CompiledPrefill`` of a moe model: its one-shot program at
    each length runs eagerly at the exact length (no pad row joins a
    routing group) and captures no graph; three calls against the eager
    unpadded prefill, bit for bit; no attention-kernel launch. Reports
    the program's wall at each length: the prefill share of a moe
    prompt's TTFT, whether or not its length was seen before."""
    import numpy as np

    from repro_torch.models import transformer
    from repro_torch.serving.compiled import CompiledPrefill

    comp = CompiledPrefill(cfg, params, kv, DEV, None)
    rng = np.random.default_rng(seed)
    out = {}
    for S in lengths:
        toks = rng.integers(0, cfg.vocab_size, size=S).tolist()

        def eager():
            logits, cache = transformer.prefill(
                params, cfg, {"tokens": [toks]}, max_seq=S, device=DEV)
            return logits, cache["k"][:, 0], cache["v"][:, 0]

        want = [t.clone() for t in eager()]
        counters.reset()
        got = [[t.clone() for t in comp.run_oneshot(toks)]
               for _ in range(3)]
        sync(torch)
        launched = {k: n for k, n in counters.read().items() if n}
        bitwise = all(torch.equal(g, w) for call in got
                      for g, w in zip(call, want))
        gate(bitwise and not launched and got[0][1].shape[2] == S,
             f"moe one-shot S={S}: program vs unpadded eager bitwise "
             f"{bitwise}, launches {launched}, K/V rows "
             f"{got[0][1].shape[2]}")
        out[f"S{S}"] = dict(bitwise=bitwise, program_ms=median_wall(
            torch, lambda: comp.run_oneshot(toks), n=3))
    out["graphs"] = compiled_stats(comp.oneshot)
    gate(comp.oneshot.captures == 0,
         f"moe one-shot: {comp.oneshot.captures} graphs captured")
    del comp
    return out


def length_recurrence(window, n=1000, seed=0):
    """How often a moe prompt's exact length recurs within the last
    ``window`` distinct lengths (a graph cache of that many graphs, least
    recently used out), over the prompts of each of the port's traces
    (``data/traces.py``, seed ``seed``, ``n`` requests) that a moe model
    takes: at most 256 tokens or a multiple of 256. Host arithmetic; at
    the serve CLI's default length scale (0.02), 0.1 and the traces' own
    (1.0). Returns {trace: {scale: [servable prompts, recurring share]}}."""
    import collections

    import numpy as np

    from repro_torch.data import traces

    out = {}
    for name, spec in traces.TRACES.items():
        out[name] = {}
        for scale in (0.02, 0.1, 1.0):
            lengths = traces._lognormal_lengths(
                np.random.default_rng(seed),
                max(spec.mean_prompt * scale, 2), n, lo=2)
            seen, hits, kept = collections.OrderedDict(), 0, 0
            for S in lengths.tolist():
                if S > 256 and S % 256:
                    continue
                kept += 1
                if S in seen:
                    hits += 1
                    seen.move_to_end(S)
                    continue
                seen[S] = None
                if len(seen) > window:
                    seen.popitem(last=False)
            out[name][str(scale)] = [kept, hits / kept if kept else None]
    return out


def moe_dense_step(torch, np, transformer, cfg, params, counters, B=4,
                   S=256):
    """The MoE dense-cache serve step at the model's full depth:
    ``prefill`` of B prompts of S tokens (B·S a multiple of the 256-token
    routing group) into a dense cache, then two ``decode_step`` s with
    ``apply_decode_updates`` between, over a bf16 and an int8 cache. The
    counts are reset just before each cache's prefill and read after its
    second step: the dense kernel (row 5) launches once a layer a step.
    Each step's logits against the same step with the kernel's plain twin
    in its place on the card, at row cosine >= MIN_COSINE."""
    from repro_torch.kernels import decode_attention as da

    L = cfg.num_layers
    toks = np.random.default_rng(23).integers(0, cfg.vocab_size,
                                              size=(B, S + 2)).tolist()
    out = {}
    for tag, c in (("bf16", cfg), ("int8", cfg.replace(kv_cache_bits=8))):
        kernel = "decode_attention_int8" if tag == "int8" else \
            "decode_attention"
        t0 = time.perf_counter()
        with torch.inference_mode():
            counters.reset()
            _, cache = transformer.prefill(
                params, c, {"tokens": [t[:S] for t in toks]},
                max_seq=S + 2, device=DEV)
            lg1, upd = transformer.decode_step(
                params, c, [t[S] for t in toks], cache, device=DEV)
            cache2 = transformer.apply_decode_updates(cache, upd)
            lg2, _ = transformer.decode_step(
                params, c, [t[S + 1] for t in toks], cache2, device=DEV)
            sync(torch)
            launches = {k: n for k, n in counters.read().items() if n}
            # the plain twin on the same caches: the step reads a cache
            # only below its length, so the row step 1 wrote is masked
            orig = da.decode_attention
            da.decode_attention = da.decode_attention_plain
            try:
                pl1, _ = transformer.decode_step(
                    params, c, [t[S] for t in toks], cache, device=DEV)
                pl2, _ = transformer.decode_step(
                    params, c, [t[S + 1] for t in toks], cache2, device=DEV)
            finally:
                da.decode_attention = orig
        cos = [min(cosine(a[i], b[i]) for i in range(B))
               for a, b in ((lg1, pl1), (lg2, pl2))]
        finite = bool(torch.isfinite(lg1).all() and torch.isfinite(lg2).all())
        res = dict(launches=launches, min_row_cosine_vs_plain=cos,
                   same_argmax=bool((lg2.argmax(-1) == pl2.argmax(-1)).all()),
                   finite=finite, wall_s=time.perf_counter() - t0)
        gate(launches == {kernel: 2 * L}, f"qwen3-moe dense-cache {tag} "
             f"step: launches {launches} != {{{kernel}: {2 * L}}}")
        gate(finite and min(cos) >= MIN_COSINE, f"qwen3-moe dense-cache "
             f"{tag} step vs its plain twin: cosine {cos}, finite {finite}")
        out[tag] = res
        log(f"qwen3-moe dense-cache {tag} step, {L} layers, B={B} S={S}: "
            f"{json.dumps(res)}")
        del cache, cache2, upd
    return out


def moe_e2e(torch, np, registry, transformer, counters):
    """Phase 17: (a)-(b) qwen3-moe-30b-a3b at full width and depth (48
    layers, 128 experts top-8, d 2048, 32 / 4 heads of 128: G = 8;
    random bf16 weights from seed 0, capacity factor 1.25) through
    LLMEngine with compiled graphs, 8 requests of 32 greedy tokens:
    (a) homogeneous bf16, (b) moe_offload (attention head × 2, experts on
    2 workers) over an int8 pool. Prompts run one-shot (no chunk). Then
    (c) kimi-k2-1t-a32b at full width (d 7168, 384 experts, 64 heads over
    8 kv heads, hd = 112) and 1 of 61 layers, homogeneous bf16, 4
    requests of 16 tokens."""
    from repro_torch.serving import EngineConfig, make_placement
    from repro_torch.serving.compiled import MAX_GRAPHS

    cfg, params = load_model(torch, registry, transformer,
                             "qwen3-moe-30b-a3b")
    L = cfg.num_layers
    prng = np.random.default_rng(0)
    plens = prng.choice(MOE_PROMPT_LENGTHS, size=8)
    prompts = [prng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in plens]
    base = EngineConfig(block_size=16, num_blocks=1280, max_batch=8,
                        prefill_chunk_tokens=512)
    moe = params["layers"]["moe"]
    expert_bytes = sum(tree_bytes(moe[k]) for k in ("w_gate", "w_up",
                                                    "w_down"))
    out = {"prompt_lengths": plens.tolist(), "parameters": n_params(params),
           "weight_bytes": tree_bytes(params), "expert_bytes": expert_bytes,
           "expert_byte_floor_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
           "weight_byte_floor_ms": tree_bytes(params) / HBM_BYTES_PER_S *
           1e3, "capacity_factor": cfg.capacity_factor}
    log(f"qwen3-moe: prompt lengths {plens.tolist()}; a decode step reads "
        f"{expert_bytes / 1e9:.2f} GB of expert weights: "
        f"{out['expert_byte_floor_ms']:.2f} ms at 3.35 TB/s (all weights "
        f"{out['weight_byte_floor_ms']:.2f} ms)")

    t0 = time.perf_counter()
    tops_a = {}
    eng, reqs, launches, summ = engine_run(torch, cfg, params, base, prompts,
                                           counters, tops=tops_a)
    launch_gate(launches, eng, L, 1, False, "qwen3-moe (a) homogeneous bf16")
    gate(eng.stats.prefill_chunks_run == 0 and eng._chunk_tokens is None,
         f"qwen3-moe (a): {eng.stats.prefill_chunks_run} chunks ran")
    ref_tokens = [list(r.output) for r in reqs]
    pl = make_placement(cfg, base, torch.device(DEV))

    def at_state(wave):
        ids = [r.rid for r in wave]
        toks = [r.output[-1] for r in wave]
        gates = compiled_gates(torch, pl, params, eng.kv, ids, toks,
                               counters, "paged_decode_attention", L)
        cos = moe_layers_vs_cpu(torch, cfg, params, lambda: eager_step(
            torch, pl, params, eng.kv, ids, toks))
        gate(min(cos) >= MIN_COSINE, f"qwen3-moe: a MoE layer on the card "
             f"vs the CPU at cosine {min(cos)} < {MIN_COSINE}")
        return dict(compiled_gates=gates, moe_layer_cosine_min=min(cos),
                    moe_layer_cosine_mean=sum(cos) / len(cos))

    prof, state = profile_decode(torch, eng, prompts, at_state=at_state)
    summ.update(profile=prof, **state,
                device_busy_over_expert_floor=prof["device_busy_ms"] /
                out["expert_byte_floor_ms"],
                prefill_gates=moe_prefill_gates(
                    torch, cfg, params, eng.kv, counters, (200, 1536)))
    summ["wall_s_phase"] = time.perf_counter() - t0
    out["a_homogeneous_bf16"] = summ
    log(f"qwen3-moe (a) homogeneous bf16: {json.dumps(summ)}")
    del eng, reqs
    release(torch)

    t0 = time.perf_counter()
    econf = base.replace(placement="moe_offload", partition="head",
                         attention_workers=2, expert_workers=2,
                         kv_dtype="int8")
    tops_b = {}
    eng, reqs, launches, summ = engine_run(torch, cfg, params, econf,
                                           prompts, counters, tops=tops_b)
    launch_gate(launches, eng, L, 2, True, "qwen3-moe (b) moe_offload int8")
    gate(eng.stats.prefill_chunks_run == 0,
         f"qwen3-moe (b): {eng.stats.prefill_chunks_run} chunks ran")
    tlog = moe_transfer_check(cfg, eng)
    gate(tlog["ok"], f"qwen3-moe (b): wire logs {tlog} != the §3.1 and "
         f"transfer_bytes_moe formulas")
    summ.update(transfer_logs=tlog,
                per_worker_kv_bytes=eng.pool.per_worker_kv_bytes,
                **stream_gate("qwen3-moe (b) vs (a)", reqs, ref_tokens,
                              tops_b))
    summ["wall_s_phase"] = time.perf_counter() - t0
    out["b_moe_offload_head2_int8"] = summ
    log(f"qwen3-moe (b) moe_offload head x2 int8: {json.dumps(summ)}")
    del eng, reqs
    release(torch)
    out["dense_cache_step"] = moe_dense_step(torch, np, transformer, cfg,
                                             params, counters)
    out["length_recurrence"] = length_recurrence(MAX_GRAPHS)
    log(f"moe prompt lengths recurring within {MAX_GRAPHS} graphs: "
        f"{json.dumps(out['length_recurrence'])}")
    del params, moe
    release(torch)

    t0 = time.perf_counter()
    kcfg, kparams = load_model(torch, registry, transformer,
                               "kimi-k2-1t-a32b", num_layers=1)
    kprng = np.random.default_rng(1)
    klens = kprng.choice(MOE_PROMPT_LENGTHS[:4], size=4)
    kprompts = [kprng.integers(0, kcfg.vocab_size, size=int(n)).tolist()
                for n in klens]
    eng, reqs, launches, summ = engine_run(
        torch, kcfg, kparams, EngineConfig(block_size=16, num_blocks=256,
                                           max_batch=4), kprompts,
        counters, new=16)
    # the engine refuses to sample from non-finite logits: finished
    # streams are finite ones
    launch_gate(launches, eng, 1, 1, False, "kimi-k2 (c) 1 layer, hd 112")
    summ.update(prompt_lengths=klens.tolist(), parameters=n_params(kparams),
                head_dim=kcfg.resolved_head_dim,
                wall_s_phase=time.perf_counter() - t0)
    out["c_kimi_k2_1_layer"] = summ
    log(f"kimi-k2, 1 of 61 layers, homogeneous bf16: {json.dumps(summ)}")
    del eng, reqs, kparams
    release(torch)
    return out


def gemma2_e2e(torch, np, registry, transformer, counters):
    """Phase 18: gemma2-27b at full width and depth (46 layers, alternating
    local (window 4096) and global layers, attention and final logit
    softcaps, post-norms, tied embeddings; random bf16 weights from seed 0)
    through LLMEngine with compiled graphs and chunked prefill, 8 requests
    of 300-2000 prompt tokens and one of 6144, 32 new each: (a)
    homogeneous bf16, (b) attention_pool head over 2 workers on an int8
    pool. At one decode state of the 6144-token request on (a)'s warmed
    engine, the decode and chunk attention over the real pool against
    their plain twins for a local and a global layer."""
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.serving import EngineConfig, State

    cfg, params = load_model(torch, registry, transformer, "gemma2-27b")
    L, hd, sw = cfg.num_layers, cfg.resolved_head_dim, cfg.sliding_window
    prng = np.random.default_rng(18)
    plens = prng.integers(300, 2001, size=8).tolist() + [6144]
    prompts = [prng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in plens]
    base = EngineConfig(block_size=16, num_blocks=1280, max_batch=9,
                        prefill_chunk_tokens=512)
    out = {"prompt_lengths": plens, "parameters": n_params(params)}

    t0 = time.perf_counter()
    eng, reqs, launches, summ = engine_run(torch, cfg, params, base, prompts,
                                           counters)
    launch_gate(launches, eng, L, 1, False, "gemma2-27b (a) homogeneous bf16")
    ref_tokens = [list(r.output) for r in reqs]
    # the long request again on the warmed engine, paused after 4 tokens
    req, = make_requests([prompts[-1]], 8)
    eng.submit([req])
    while len(req.output) < 4:
        eng.step()
    tables, lens = eng.kv.block_table_batch([req.rid])
    tbl = torch.as_tensor(tables, device=DEV)
    clen = torch.as_tensor(lens, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(18)
    P, C = 320 * 16, 512                   # a chunk at [5120, 5632)
    table = eng.kv.gather_prefix_indices(req.rid, P)
    twins = {}
    for layer in (0, 1):                   # local, then global
        local = layer % 2 == 0
        pools = (eng.kv.k_pool[layer], eng.kv.v_pool[layer])
        q = torch.randn((1, cfg.num_kv_heads, cfg.gqa_group, hd),
                        generator=gen, device=DEV).bfloat16()
        # the kernel's window: the serving window less the incoming token
        kw = dict(sliding_window=sw - 1 if local else 0,
                  logit_softcap=cfg.attn_logit_softcap, return_partials=True)
        o, l_, m = pda.paged_decode_attention(q, *pools, tbl, clen, **kw)
        po, pl_, pm = pda.paged_decode_attention_plain(q, *pools, tbl, clen,
                                                       **kw)
        dec = check_close(f"gemma2 layer {layer} decode o", o, po)
        check_close(f"gemma2 layer {layer} decode l", l_, pl_, rtol=1e-3,
                    atol=1e-6)
        check_close(f"gemma2 layer {layer} decode m", m, pm, rtol=0.0,
                    atol=1e-3)
        qc = torch.randn((C, cfg.num_heads, hd), generator=gen,
                         device=DEV).bfloat16()
        kc = torch.randn((C, cfg.num_kv_heads, hd), generator=gen,
                         device=DEV).bfloat16()
        vc = torch.randn_like(kc)
        ckw = dict(sliding_window=sw if local else 0,
                   logit_softcap=cfg.attn_logit_softcap)
        got = ppa.paged_prefill_chunk_attention(qc, *pools, table, kc, vc,
                                                **ckw)
        want = ppa.paged_prefill_chunk_attention_plain(qc, *pools, table, kc,
                                                       vc, **ckw)
        twins[f"layer{layer}_{'local' if local else 'global'}"] = dict(
            cache_len=int(lens[0]), decode_max_abs_err=dec,
            chunk_P=P, chunk_max_abs_err=check_close(
                f"gemma2 layer {layer} chunk", got, want))
    eng.cancel_all()
    summ.update(twins_at_6144=twins, wall_s_phase=time.perf_counter() - t0)
    out["a_homogeneous_bf16"] = summ
    log(f"gemma2-27b (a) homogeneous bf16: {json.dumps(summ)}")
    del eng, reqs, req
    release(torch)

    t0 = time.perf_counter()
    econf = base.replace(placement="attention_pool", partition="head",
                         attention_workers=2, kv_dtype="int8")
    tops = {}
    eng, reqs, launches, summ = engine_run(torch, cfg, params, econf,
                                           prompts, counters, tops=tops)
    launch_gate(launches, eng, L, 2, True, "gemma2-27b (b) head x2 int8")
    gate(all(r.state == State.FINISHED for r in reqs),
         "gemma2-27b (b): a request did not finish")
    tlog = transfer_log_check(cfg, eng, prompts, "int8")
    gate(tlog["ok"], f"gemma2-27b (b): TransferLog {tlog} != the §3.1 "
         f"formulas")
    summ.update(transfer_log=tlog,
                **stream_gate("gemma2-27b (b) vs (a)", reqs, ref_tokens,
                              tops),
                wall_s_phase=time.perf_counter() - t0)
    out["b_head2_int8"] = summ
    log(f"gemma2-27b (b) attention_pool head x2 int8: {json.dumps(summ)}")
    del eng, reqs, params
    release(torch)
    return out


# ---------------------------------------------------------------------------
# phase 19: the audio family (seamless-m4t-medium) end to end
# ---------------------------------------------------------------------------
AUDIO_ENC_LENGTHS = (512, 2048)


def audio_run(torch, np, transformer, cfg, params, counters, S_enc, B=8,
              prompt=8, n_new=64):
    """One seamless run at full width and depth: B stub frame sequences of
    S_enc rows (bf16, seeded on the card) and decoder prompts of ``prompt``
    tokens, ``prefill`` then ``n_new`` greedy steps. Every step: row 5
    launches 2 L times (self and cross, counted around the step alone);
    its logits against the same step with row 5's plain twin on the same
    cache (cosine >= MIN_COSINE, the same argmax or a NEAR_TIE_ULPS tie);
    at the first step the listed layout's step = the stacked one bit for
    bit. Then a profiled window of 3 steps."""
    from repro_torch.kernels import decode_attention as da

    L = cfg.num_layers
    gen = torch.Generator(device=DEV).manual_seed(S_enc)
    frames = torch.randn((B, S_enc, cfg.d_model), generator=gen,
                         device=DEV).bfloat16()
    tokens = np.random.default_rng(S_enc).integers(
        0, cfg.vocab_size, size=(B, prompt)).tolist()
    batch = {"frames": frames, "tokens": tokens}
    max_seq = prompt + n_new + 4
    listed = dict(params)
    listed["layers"] = [transformer._layer(params["layers"], i)
                        for i in range(L)]
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(params, cfg, batch, max_seq,
                                        device=DEV)
    sync(torch)
    prefill_s = time.perf_counter() - t0
    prefill_launches = {k: n for k, n in counters.read().items() if n}
    gate(not prefill_launches, f"seamless S_enc={S_enc} prefill launched "
         f"{prefill_launches} (its attention is the plain blockwise path)")
    cross_bytes = tree_bytes({k: cache[k] for k in ("ck", "cv")})
    want = {"decode_attention": 2 * L}
    step_ms, cos, launch_bad, ties, listed_equal = [], [], [], [], None
    for step in range(n_new):
        tok = logits.argmax(-1).int()
        sync(torch)
        counters.reset()
        t1 = time.perf_counter()
        logits, upd = transformer.decode_step(params, cfg, tok, cache,
                                              device=DEV)
        sync(torch)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        got = {k: n for k, n in counters.read().items() if n}
        if got != want:
            launch_bad.append((step, got))
        orig = da.decode_attention
        da.decode_attention = da.decode_attention_plain
        try:
            plain, _ = transformer.decode_step(params, cfg, tok, cache,
                                               device=DEV)
        finally:
            da.decode_attention = orig
        cos.append(min(cosine(logits[i], plain[i]) for i in range(B)))
        for i in range(B):
            t = int(logits[i].argmax())
            if t != int(plain[i].argmax()):
                ties.append((step, i, gap_ulps(plain[i], t)))
        if step == 0:
            lcache = {k: v if k == "len" else list(v)
                      for k, v in cache.items()}
            llg, lupd = transformer.decode_step(listed, cfg, tok, lcache,
                                                device=DEV)
            listed_equal = bool(torch.equal(llg, logits) and all(
                torch.equal(torch.stack(lupd[k]), upd[k])
                for k in ("k_new", "v_new")))
            del lcache, llg, lupd
        cache = transformer.apply_decode_updates(cache, upd)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits.float()).all())
    gate(not launch_bad, f"seamless S_enc={S_enc}: steps whose row-5 "
         f"launches != {want}: {launch_bad[:4]}")
    gate(min(cos) >= MIN_COSINE and finite, f"seamless S_enc={S_enc}: "
         f"step logits vs the plain twin's min cosine {min(cos)}, finite "
         f"{finite}")
    gate(all(g <= NEAR_TIE_ULPS for _, _, g in ties), f"seamless "
         f"S_enc={S_enc}: argmax left the plain twin's away from a tie: "
         f"{ties[:4]}")
    gate(listed_equal, f"seamless S_enc={S_enc}: the listed step differs "
         f"from the stacked one")
    gate(int(cache["len"].min()) == prompt + n_new, f"seamless cache len "
         f"{cache['len'].tolist()}")

    def step():
        nonlocal logits, cache
        logits, upd = transformer.decode_step(
            params, cfg, logits.argmax(-1).int(), cache, device=DEV)
        cache = transformer.apply_decode_updates(cache, upd)

    prof = profile_window(torch, step, 3, B, kernels=("dense_lanes_kernel",))
    res = dict(batch=B, S_enc=S_enc, prompt_tokens=prompt, new_tokens=n_new,
               prefill_s=prefill_s,
               decode_step_ms_p50=sorted(step_ms)[len(step_ms) // 2],
               decode_step_ms_first=[round(t, 2) for t in step_ms[:4]],
               decode_tok_s=B * n_new / (sum(step_ms) / 1e3),
               row5_launches_per_step=2 * L, min_cosine_vs_plain=min(cos),
               argmax_ties=ties, listed_equals_stacked=listed_equal,
               peak_gib=peak / 2**30, cross_kv_bytes=cross_bytes,
               cross_kv_shape=list(cache["ck"].shape), profile=prof)
    log(f"seamless S_enc={S_enc}: {json.dumps(res)}")
    del cache, logits, frames
    release(torch)
    return res


def audio_e2e(torch, np, registry, transformer, counters):
    """Phase 19: seamless-m4t-medium at full width and depth (12 encoder
    and 12 decoder layers, d 1024, 16 / 16 heads of 64, d_ff 4096, vocab
    256206; random bf16 weights from seed 0): ``audio_run`` at S_enc = 512
    and 2048; row 5 at the cross shape (B=8, Hkv=16, G=1, hd=64, 2048 live
    rows) against its twin, timed beside SDPA on the same cache and its
    bound; the card against the CPU at 2 + 2 layers (``card_vs_cpu``)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.kernels import decode_attention as da

    t0 = time.perf_counter()
    cfg, params = load_model(torch, registry, transformer,
                             "seamless-m4t-medium")
    out = dict(params_cost_model=cm.param_count(cfg),
               params=n_params(params),
               weights_gib=tree_bytes(params) / 2**30)
    # warm-up (library handles, allocator) at a short input, not counted
    generate(transformer, cfg, params, {
        "frames": torch.zeros((2, 64, cfg.d_model), device=DEV),
        "tokens": [[1, 2], [3, 4]]}, 2, 6, DEV)
    for S_enc in AUDIO_ENC_LENGTHS:
        out[f"S_enc_{S_enc}"] = audio_run(torch, np, transformer, cfg,
                                          params, counters, S_enc)
    del params
    release(torch)
    timer = Timer(torch)
    out["row5_cross_shape"] = dense_decode_case(
        torch, da, timer, B=8, Hkv=16, G=1, hd=64, lens=[2048] * 8, S=2048,
        seed=40)
    log(f"dense decode seamless cross B=8 Hkv=16 G=1 hd=64 S_enc=2048: "
        f"{json.dumps(out['row5_cross_shape'])}")
    del timer
    release(torch)
    out["card_vs_cpu"] = card_vs_cpu(
        torch, np, transformer, cfg.replace(num_layers=2, encoder_layers=2),
        counters, S=8, frames=64)
    release(torch)
    out["wall_s_phase"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 20: the analytic core on the card
# ---------------------------------------------------------------------------
def converter_attention(torch, da, cfg, kc, vc):
    """The converter's attention callback over a dense bf16 cache (B, Hkv,
    S, hd) holding S - 1 tokens: it writes the step's k/v at row S - 1 and
    launches row 5 over all S rows (a decode step's attention). Returns
    (callback, the (q, o) of each call, cache_len)."""
    B, Hkv, S, hd = kc.shape
    G = cfg.gqa_group
    lens = torch.full((B,), S, dtype=torch.int32, device=DEV)
    calls = []

    def attn_fn(name, env):
        kc[:, :, S - 1] = env["k_proj"].bfloat16()
        vc[:, :, S - 1] = env["v_proj"].bfloat16()
        q = env["q_proj"].bfloat16().reshape(B, Hkv, G, hd)
        o = da.decode_attention(q, kc, vc, lens)
        calls.append((q, o))
        return o.float().reshape(B, Hkv * G, hd)
    return attn_fn, calls, lens


def unsliced(graph, inputs, attn_fn):
    """Every op of ``graph`` in graph order, attention inline (the order
    the converter's slices must reproduce)."""
    env = dict(inputs)
    for name in graph.order:
        op = graph.ops[name]
        if op.kind == "attention":
            env[name] = attn_fn(name, env)
        elif op.kind != "input":
            env[name] = op.fn(*[env[i] for i in op.inputs])
    return env


def analytic_e2e(torch, np, registry, counters, profile, mean_ctx):
    """Phase 20: (a) the converter on the card: llama3-8b's block (d 4096,
    32 / 8 heads of 128, d_ff 14336; fp32 weights from seed 0) as a graph
    at batch 8, split at its attention (slices, programs, sends and cut
    bytes = the CPU port's), run sliced with row 5 as the attention (a
    dense bf16 cache of 2047 tokens plus the step's): residual2 = the
    unsliced order bit for bit, the callback's output vs the plain twin;
    (b) ``run_rotational`` over 4 batches of 8: each = its direct run bit
    for bit, replica = (j + k) mod 3; (c) the cost model on ``h100``
    beside phase 4's measured step (printed, not gated)."""
    from repro_torch.core import converter, pipeline
    from repro_torch.core import costmodel as cm
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import blocks
    from repro_torch.serving.worker_pool import min_bandwidth_moe

    t0 = time.perf_counter()
    cfg = registry.get_config("llama3-8b")
    B, S, hd = 8, 2048, cfg.resolved_head_dim
    gen = torch.Generator(device=DEV).manual_seed(0)
    w = blocks.init_dense_block(gen, cfg.replace(dtype=torch.float32), DEV)
    g = converter.build_block_graph(cfg, weights=w, batch=B, device=DEV)
    sp = converter.split_at_attention(g)
    ref = converter.split_at_attention(converter.build_block_graph(
        cfg, batch=B, device="cpu"))

    def shape_of(prog):
        return [(sl.program, sl.context_in, sl.context_out, sl.sends,
                 sl.recv_attn) for sl in prog.slices]
    gate(shape_of(sp) == shape_of(ref) and sp.cut_bytes == ref.cut_bytes ==
         [B * cfg.d_model * 2], f"converter on the card: slices or cut "
         f"bytes {sp.cut_bytes} differ from the CPU port's")
    kc = torch.randn((B, cfg.num_kv_heads, S, hd), generator=gen,
                     device=DEV).bfloat16()
    vc = torch.randn((B, cfg.num_kv_heads, S, hd), generator=gen,
                     device=DEV).bfloat16()
    attn_fn, calls, lens = converter_attention(torch, da, cfg, kc, vc)
    x = {"x": torch.randn((B, cfg.d_model), generator=gen, device=DEV)}
    sp.run(x, attn_fn)                       # warm-up (cuBLAS handles)
    sync(torch)
    counters.reset()
    t1 = time.perf_counter()
    trace = []
    env = sp.run(x, attn_fn, trace=trace)
    sync(torch)
    sliced_ms = (time.perf_counter() - t1) * 1e3
    launches = {k: n for k, n in counters.read().items() if n}
    direct = unsliced(g, x, attn_fn)
    sync(torch)
    bit = all(torch.equal(env[n], direct[n]) for n in g.order)
    q, o = calls[1]
    plain = da.decode_attention_plain(q, kc, vc, lens)
    conv = dict(slices=len(sp.slices), cut_bytes=sp.cut_bytes,
                programs=[sl.program for sl in sp.slices],
                sends=sp.slices[0].sends, trace=trace,
                launches=launches, sliced_wall_ms=sliced_ms,
                residual2_equal=bit, callback_cosine_vs_plain=cosine(o, plain),
                callback_max_abs_err=float((o.float() - plain.float())
                                           .abs().max()))
    gate(launches == {"decode_attention": 1}, f"converter sliced run "
         f"launches {launches} != {{decode_attention: 1}}")
    gate(bit, "converter on the card: sliced != unsliced bit for bit")
    gate(conv["callback_cosine_vs_plain"] >= MIN_COSINE, f"converter "
         f"callback vs row 5's plain twin cosine "
         f"{conv['callback_cosine_vs_plain']}")
    log(f"converter llama3-8b block B={B} on the card: {json.dumps(conv)}")
    # (b) rotational staggered pipelining over 4 batches
    n = 4
    xs = [{"x": torch.randn((B, cfg.d_model), generator=gen, device=DEV)}
          for _ in range(n)]
    directs = [sp.run(xj, attn_fn)["residual2"] for xj in xs]
    sync(torch)
    counters.reset()
    envs, rlog = pipeline.run_rotational(
        [sp] * n, xs, lambda j, name, env: attn_fn(name, env))
    sync(torch)
    rot_launches = {k: n_ for k, n_ in counters.read().items() if n_}
    rot = dict(batches=n, log=rlog, launches=rot_launches,
               equal_direct=[bool(torch.equal(e["residual2"], d))
                             for e, d in zip(envs, directs)],
               schedule=pipeline.validate(pipeline.rotational_schedule(
                   n, len(sp.slices))),
               throughput_speedup=pipeline.throughput_speedup(n))
    gate(all(rot["equal_direct"]), f"run_rotational != direct runs: "
         f"{rot['equal_direct']}")
    gate(len(rlog) == n * len(sp.slices) and
         all(r == (j + k) % (n - 1) for j, k, r in rlog),
         f"rotation law broken: {rlog}")
    gate(rot_launches == {"decode_attention": n}, f"rotational launches "
         f"{rot_launches}")
    log(f"rotational pipeline, 4 batches of {B}: {json.dumps(rot)}")
    del w, g, sp, kc, vc, calls, env, direct, envs, directs
    release(torch)
    # (c) the cost model on the card's constants beside phase 4's step
    h100, h20 = cm.HARDWARE["h100"], cm.HARDWARE["h20"]
    l70 = registry.get_config("llama3-70b")
    qwen = registry.get_config("qwen3-moe-30b-a3b")
    lam = cm.estimate_lamina(l70, 4096, h100, h20, (2, 4))
    cost = dict(
        llama3_8b_B8=dict(
            context=mean_ctx,
            mtime_ms=cm.mtime(cfg, 8, h100, efficiency=1.0) * 1e3,
            atime_ms=cm.atime(cfg, 8, mean_ctx, h100, efficiency=1.0) * 1e3,
            mfu_nonattention=cm.mfu_nonattention(cfg, 8, h100),
            measured_gemm_ms=profile.get("gemm_ms"),
            measured_decode_kernel_ms=profile.get("paged_decode_kernel_ms"),
            measured_device_busy_ms=profile.get("device_busy_ms"),
            measured_step_ms=profile.get("step_ms_unprofiled")),
        llama3_70b=dict(
            minimum_bandwidth_gbs={B_: cm.minimum_bandwidth(
                l70, B_, 4096, h100, h20, dop=(2, 4)) / 1e9
                for B_ in (32, 100, 300, lam.batch)},
            vllm_4xh100=dataclasses.asdict(cm.estimate_vllm(l70, 4096, h100,
                                                            4)),
            lamina_dop_2_4=dataclasses.asdict(lam)),
        qwen3_moe_min_bandwidth_gbs=min_bandwidth_moe(
            qwen, 128, 8192, h100, h20) / 1e9)
    log(f"cost model (h100 at efficiency 1.0; printed, not gated): "
        f"{json.dumps(cost)}")
    return dict(converter=conv, rotational=rot, cost_model=cost,
                wall_s_phase=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 21: training (tinyllama-1.1b at full width and depth; the scans'
# backward kernels through zamba2-1.2b and rwkv6-7b)
# ---------------------------------------------------------------------------
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 30        # (a)
REC_B, REC_S, REC_STEPS, RWKV_LAYERS = 4, 2048, 5, 8   # (c)
BWD_B, BWD_S, BWD_H, BWD_P = 8, 2048, 64, 64      # (d): the forward's shape
# gradient agreement per leaf (cosine, and max |err| over the leaf's
# largest entry): card vs CPU, both fp32 (cuBLAS fp32 products, no TF32);
# scan kernels vs their plain twins on the card, fp32 (the forward's
# three-pass bf16 products, ~1e-5 of each) and bf16 (one bf16 rounding
# of the scan's output and of every later activation)
GRAD_COS_CPU, GRAD_REL_CPU = 0.99999, 1e-3
GRAD_COS_F32, GRAD_COS_BF16 = 0.9999, 0.999
SMOKE_LOSS_RTOL = 1e-4


def grad_agreement(got, want):
    """(min cosine, max |got - want| / max |want|) over the leaves whose
    gradient is not zero."""
    cos, rel = [], []
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float().cpu()
        scale = float(w.abs().max())
        if scale == 0.0 and float(g.abs().max()) == 0.0:
            continue
        cos.append(cosine(g, w))
        rel.append(float((g - w).abs().max()) / max(scale, 1e-30))
    return min(cos), max(rel)


def leaf_names(tree, prefix=""):
    """Dotted names of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", range(len(tree)))
        return [n for f, v in zip(fields, tree)
                for n in leaf_names(v, f"{prefix}{f}.")]
    return [prefix[:-1]]


def train_walls(history):
    """Per-step walls (s) from ``train``'s history logged every step."""
    walls = [history[0]["wall_s"]]
    walls += [b["wall_s"] - a["wall_s"] for a, b in zip(history, history[1:])]
    return walls


def param_count_no_embed(cfg, params):
    """Parameters that a token's forward multiplies (the embedding table is
    a lookup; a tied table is counted once, as the head)."""
    n = n_params(params)
    return n if cfg.tie_embeddings else n - cfg.vocab_size * cfg.d_model


def train_tinyllama(torch, np, registry, transformer, counters):
    """(a) tinyllama-1.1b at full width and depth, bf16 weights from seed
    0: 30 steps of B=8 x S=512 ``packed_batches`` through ``train`` (lr
    1e-3, 5 warmup steps), timed per step; then the same 30 batches as 15
    steps, a checkpoint, a restore and 15 more: equal to the uninterrupted
    run bit for bit. One step profiled."""
    from repro_torch.data.synthetic import packed_batches
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step, train
    from repro_torch.tree import tree_leaves

    cfg = registry.get_config("tinyllama-1.1b")
    t0 = time.perf_counter()
    data = packed_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0,
                          device=DEV)
    batches = list(itertools.islice(data, TRAIN_STEPS))
    sync(torch)
    data_s = time.perf_counter() - t0
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    params = transformer.init_params(0, cfg, device=DEV)
    N = n_params(params)
    adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=5,
                            total_steps=TRAIN_STEPS)
    counters.reset()
    full_p, full_s, hist = train(cfg, adamw, iter(batches), TRAIN_STEPS,
                                 params=params, log_every=1, device=DEV)
    sync(torch)
    launches = {k: n for k, n in counters.read().items() if n}
    peak = torch.cuda.max_memory_allocated() / 2**30
    walls = train_walls(hist)
    p50 = float(np.median(walls[1:]))
    tokens = TRAIN_B * TRAIN_S
    n_mult = param_count_no_embed(cfg, params)
    model_flops = 6 * n_mult * tokens
    remat_flops = 2 * n_mult * tokens
    losses = [h["loss"] for h in hist]
    out = dict(parameters=N, parameters_multiplied=n_mult,
               batch=TRAIN_B, seq=TRAIN_S, steps=TRAIN_STEPS,
               data_gen_s_per_batch=data_s / TRAIN_STEPS,
               first_step_s=walls[0], step_wall_p50_s=p50,
               step_wall_min_s=float(min(walls[1:])),
               tokens_per_s=tokens / p50, peak_gib=peak,
               # held beside the steps: what earlier phases left allocated,
               # and this function's copy of the initial weights (kept for
               # the resumed run), alive past the first step
               held_before_gib=held_before / 2**30,
               initial_weights_gib=tree_bytes(params) / 2**30,
               loss_step1=losses[0], loss_last=losses[-1],
               grad_norm_step1=hist[0]["grad_norm"],
               grad_norm_last=hist[-1]["grad_norm"],
               mfu_6nt=model_flops / p50 / BF16_FLOP_PER_S,
               mfu_with_remat_8nt=(model_flops + remat_flops) / p50
               / BF16_FLOP_PER_S,
               model_tflop_per_step=model_flops / 1e12,
               remat_tflop_per_step=remat_flops / 1e12,
               launches=launches)
    gate(all(math.isfinite(x) for x in losses),
         f"tinyllama train: non-finite loss {losses}")
    # the corpus's successors are uniform over 32000 tokens, so 30 steps
    # see each bigram a few times: the loss falls slowly from ~ln(32000)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    out.update(loss_mean_first5=first, loss_mean_last5=last)
    gate(last < first, f"tinyllama train: mean loss of the last 5 steps "
         f"{last:.4f} not below the first 5's {first:.4f}")
    gate(not launches, f"tinyllama train launched {launches} (its "
         f"attention is the plain blockwise path)")
    # resumed: 15 steps with a checkpoint, a restore, 15 more
    half = TRAIN_STEPS // 2
    saved = {}
    save = ckpt.save

    def timed_save(*a, **kw):
        t = time.perf_counter()
        path = save(*a, **kw)
        saved["save_s"] = time.perf_counter() - t
        saved["path"] = path
        return path
    data_b = iter(batches)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save = timed_save
        try:
            p_half, s_half, _ = train(cfg, adamw, data_b, half,
                                      params=params, log_every=half,
                                      checkpoint_dir=d,
                                      checkpoint_every=half, device=DEV)
        finally:
            ckpt.save = save
        size = sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d))
        template = {"params": p_half, "opt": s_half}
        del p_half, s_half
        t = time.perf_counter()
        tree, step = ckpt.restore(d, template)
        sync(torch)
        restore_s = time.perf_counter() - t
    del template
    res_p, res_s, hist_b = train(cfg, adamw, data_b, TRAIN_STEPS - half,
                                 params=tree["params"], state=tree["opt"],
                                 log_every=TRAIN_STEPS - half, device=DEV)
    del tree
    sync(torch)
    names = leaf_names({"params": res_p, "opt": res_s})
    differ = [(n, float((a.float() - b.float()).abs().max()))
              for n, a, b in zip(names,
                                 tree_leaves({"params": res_p,
                                                  "opt": res_s}),
                                 tree_leaves({"params": full_p,
                                                  "opt": full_s}))
              if not torch.equal(a, b)]
    out.update(checkpoint_step=step, checkpoint_bytes=size,
               checkpoint_save_s=saved.get("save_s"),
               checkpoint_restore_s=restore_s,
               resumed_loss_last=hist_b[-1]["loss"],
               resumed_equal_bit_for_bit=not differ,
               resumed_leaves_differing=differ[:8])
    gate(step == half and not differ, f"tinyllama resumed run != "
         f"uninterrupted run: {len(differ)} leaves differ, first "
         f"{differ[:4]}")
    # one step profiled, from the trained state
    step_fn = make_train_step(cfg, adamw)
    out["profile"] = profile_window(
        torch, lambda: step_fn(full_p, full_s, batches[0]), 1, TRAIN_B,
        kernels=("elementwise", "reduce"))
    del full_p, full_s, res_p, res_s, params, batches
    release(torch)
    log(f"train tinyllama-1.1b: {json.dumps(out)}")
    return out


def train_grads_vs_cpu(torch, registry, transformer):
    """(b) one batch's loss and gradients of tinyllama-1.1b at full width
    (2 of 22 layers, fp32) on the card against the CPU port."""
    from repro_torch.data.synthetic import packed_batches
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.tree import tree_map

    cfg = registry.get_config("tinyllama-1.1b").replace(
        num_layers=2, dtype=torch.float32)
    gate(not torch.backends.cuda.matmul.allow_tf32,
         "train grads vs CPU: TF32 matmuls are on")
    params = transformer.init_params(1, cfg, device=DEV)
    cpu_params = tree_map(lambda a: a.cpu(), params)
    batch = next(packed_batches(cfg.vocab_size, 2, 128, seed=1))
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(params, cfg, {k: v.to(DEV) for k, v in
                                                  batch.items()}, DEV)
    sync(torch)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    closs, _, cgrads = loss_and_grads(cpu_params, cfg, batch, "cpu")
    cpu_s = time.perf_counter() - t0
    cos, rel = grad_agreement(grads, cgrads)
    loss_rel = abs(float(loss) - float(closs)) / abs(float(closs))
    out = dict(layers=2, batch=2, seq=128, loss_card=float(loss),
               loss_cpu=float(closs), loss_rel_err=loss_rel,
               min_leaf_cosine=cos, max_leaf_rel_err=rel,
               leaves=len(grads), card_s=card_s, cpu_s=cpu_s)
    gate(loss_rel <= 1e-5 and cos >= GRAD_COS_CPU and rel <= GRAD_REL_CPU,
         f"train grads card vs CPU: loss rel {loss_rel:.2e}, min cosine "
         f"{cos:.7f} (need {GRAD_COS_CPU}), max rel {rel:.2e} (need "
         f"{GRAD_REL_CPU})")
    del params, cpu_params, grads, cgrads
    release(torch)
    log(f"train grads card vs CPU: {json.dumps(out)}")
    return out


@contextlib.contextmanager
def plain_scans(ssm, rwkv):
    """The scans' autograd Functions run their plain twins on the card,
    forward and backward (the kernels' references), inside the block."""
    saved = (ssm._ssm_scan_forward, ssm.ssm_scan_bwd,
             rwkv._rwkv6_scan_forward, rwkv.rwkv6_scan_bwd)
    ssm._ssm_scan_forward = ssm.ssm_scan_plain
    ssm.ssm_scan_bwd = ssm.ssm_scan_bwd_plain
    rwkv._rwkv6_scan_forward = rwkv.rwkv6_scan_plain
    rwkv.rwkv6_scan_bwd = rwkv.rwkv6_scan_bwd_plain
    try:
        yield
    finally:
        (ssm._ssm_scan_forward, ssm.ssm_scan_bwd,
         rwkv._rwkv6_scan_forward, rwkv.rwkv6_scan_bwd) = saved


def train_recurrent(torch, np, registry, transformer, counters, arch,
                    layers, B, S, steps, per_step, scan):
    """(c) ``steps`` training steps of a recurrent arch at full width
    (``layers`` of them; None = full depth), B x S packed batches, bf16,
    through ``train``: the scans' forward (and remat recompute) and
    backward kernels launch ``per_step`` times a step. Then one more step
    profiled: the device time of the ``scan`` kernels (forward, the
    backward's two passes and its partial sums) and their share of the
    step, beside the elementwise and reduction kernels' and the top
    operators'."""
    from repro_torch.data.synthetic import packed_batches
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step, train

    over = {} if layers is None else {"num_layers": layers}
    cfg, params = load_model(torch, registry, transformer, arch, **over)
    data = packed_batches(cfg.vocab_size, B, S, seed=2, device=DEV)
    adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    new_p, new_s, hist = train(cfg, adamw, data, steps, params=params,
                               log_every=1, device=DEV)
    sync(torch)
    launches = {k: n for k, n in counters.read().items() if n}
    del params
    walls = train_walls(hist)
    p50 = float(np.median(walls[1:]))
    want = {k: n * steps for k, n in per_step.items()}
    out = dict(layers=cfg.num_layers, batch=B, seq=S, steps=steps,
               parameters=n_params(new_p), first_step_s=walls[0],
               step_wall_p50_s=p50, tokens_per_s=B * S / p50,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               loss_step1=hist[0]["loss"], loss_last=hist[-1]["loss"],
               launches=launches, launches_per_step=per_step)
    gate(launches == want, f"train {arch}: launches {launches} != {want}")
    gate(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
             for h in hist), f"train {arch}: non-finite loss or norm")
    step_fn, batch = make_train_step(cfg, adamw), next(data)
    marks = (f"{scan}_kernel", f"{scan}_bwd_states_kernel",
             f"{scan}_bwd_kernel", "sum_partials")
    prof = profile_window(torch, lambda: step_fn(new_p, new_s, batch), 1, B,
                          kernels=marks + ("elementwise", "reduce"))
    # the backward's two passes (its sums apart)
    prof["bwd_ms"] = (prof[f"{scan}_bwd_states_kernel_ms"] +
                      prof[f"{scan}_bwd_kernel_ms"])
    prof["scan_kernels_ms"] = sum(prof[f"{m}_ms"] for m in marks)
    prof["scan_share_of_step"] = prof["scan_kernels_ms"] / \
        prof["step_ms_profiled"]
    prof["scan_share_of_busy"] = prof["scan_kernels_ms"] / \
        prof["device_busy_ms"]
    out["profile"] = prof
    del new_p, new_s
    release(torch)
    log(f"train {arch}: {json.dumps(out)}")
    return out


def train_scan_grads_vs_plain(torch, registry, transformer, counters, ssm,
                              rwkv, arch, dtype, B=2, S=512, **over):
    """(c) one batch's loss and gradients of a recurrent arch at full width
    and 2 layers on the card, through the scan kernels and through their
    plain twins."""
    from repro_torch.data.synthetic import packed_batches
    from repro_torch.training.train_loop import loss_and_grads

    cfg = registry.get_config(arch).replace(num_layers=2, dtype=dtype,
                                            **over)
    params = transformer.init_params(3, cfg, device=DEV)
    batch = next(packed_batches(cfg.vocab_size, B, S, seed=3, device=DEV))
    counters.reset()
    loss, _, grads = loss_and_grads(params, cfg, batch, DEV)
    sync(torch)
    launches = {k: n for k, n in counters.read().items() if n}
    with plain_scans(ssm, rwkv):
        ploss, _, pgrads = loss_and_grads(params, cfg, batch, DEV)
        sync(torch)
    cos, rel = grad_agreement(grads, pgrads)
    loss_rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    need = GRAD_COS_F32 if dtype == torch.float32 else GRAD_COS_BF16
    out = dict(arch=arch, dtype=str(dtype).split(".")[-1], layers=2,
               batch=B, seq=S, loss_kernels=float(loss),
               loss_plain=float(ploss), loss_rel_err=loss_rel,
               min_leaf_cosine=cos, max_leaf_rel_err=rel, launches=launches)
    gate(bool(launches) and cos >= need and loss_rel <= 1e-3,
         f"train {arch} {out['dtype']} kernels vs plain twins: launches "
         f"{launches}, loss rel {loss_rel:.2e}, min cosine {cos:.6f} (need "
         f"{need})")
    del params, grads, pgrads
    release(torch)
    log(f"train grads kernels vs plain {arch} {out['dtype']}: "
        f"{json.dumps(out)}")
    return out


def ssm_bwd_case(torch, ssm, timer, *, B, S, H, P, N, seed, edges=False,
                 timed=True):
    """The Mamba2 backward kernel vs its plain backward at a shape of the
    forward's (model-like inputs, a random dy); two calls bit for bit."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=DEV) - 1.0)
    x = torch.randn((B, S, H, P), generator=gen, device=DEV) * dt[..., None]
    Bi = torch.randn((B, S, N), generator=gen, device=DEV)
    Ci = torch.randn((B, S, N), generator=gen, device=DEV)
    decay = torch.exp(-dt)
    if edges:
        decay = edge_decays(torch, gen, decay)
    dy = torch.randn((B, S, H, P), generator=gen, device=DEV)
    ops = (x, Bi, Ci, decay, dy)
    got = ssm.ssm_scan_bwd(*ops)
    again = ssm.ssm_scan_bwd(*ops)
    sync(torch)
    want = ssm.ssm_scan_bwd_plain(*ops)
    errs = [check_scan(f"ssm_scan_bwd {n}", g, w) for n, g, w in
            zip(("dx", "dB", "dC", "ddecay"), got, want)]
    out = dict(max_abs_err=max(errs),
               grad_scale=max(float(w.abs().max()) for w in want),
               deterministic=all(torch.equal(a, b)
                                 for a, b in zip(got, again)))
    gate(out["deterministic"], "ssm_scan_bwd: two calls differ")
    if not timed:
        return out
    nbytes = 4 * (3 * x.numel() + 4 * Bi.numel() + 2 * decay.numel())
    # the rule of rows 6-7: the chunked form's products at L-step tiles, one
    # bf16 pass on the tensor cores. Per step and head: the boundary states,
    # the adjoint's, and the cross-tile products of y (for ddecay), dx, dB
    # and dC (12·P·N), their in-tile blocks (8·L·P); per step C·Bᵀ (2·L·N)
    L = ssm.CHUNK
    flops = B * S * (H * (12 * P * N + 8 * L * P) + 2 * L * N)
    bound_ms, bound_by = bound(nbytes, flops)

    def kernel():
        return ssm.ssm_scan_bwd(*ops)
    out.update(ms=timer.ms(kernel, iters=5),
               ms_held=timer.ms(kernel, iters=5, hold=True),
               host_us=timer.host_us(kernel, calls=10),
               plain_ms=timer.ms(lambda: ssm.ssm_scan_bwd_plain(*ops),
                                 iters=1, warmup=0),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               bytes=nbytes, flops=flops)
    return out


def rwkv_bwd_case(torch, rwkv, timer, *, B, S, H, P, seed, dtype,
                  decays="model", timed=True):
    """The RWKV6 backward kernel vs its plain backward at a shape of the
    forward's, in ``dtype`` (the model's decays, exact 0 among them, or
    "randn"); two calls bit for bit."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shape = (B, S, H, P)
    r, k, v = (torch.randn(shape, generator=gen, device=DEV).to(dtype)
               for _ in range(3))
    noise = torch.randn(shape, generator=gen, device=DEV)
    if decays == "model":
        w = torch.exp(-torch.exp(-6.0 + 0.5 * noise))
        pick = torch.rand(shape, generator=gen, device=DEV)
        w = torch.where(pick < 0.02, 0.0, w)
    else:
        w = torch.exp(-torch.exp(noise - 2.0))
    w = w.to(dtype).contiguous()
    u = torch.randn((H, P), generator=gen, device=DEV) * 0.5
    dy = torch.randn(shape, generator=gen, device=DEV)
    ops = (r, k, v, w, u, dy)
    got = rwkv.rwkv6_scan_bwd(*ops)
    again = rwkv.rwkv6_scan_bwd(*ops)
    sync(torch)
    want = rwkv.rwkv6_scan_bwd_plain(*ops)
    errs = []
    for n, g, wnt in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        if g.dtype == torch.bfloat16:
            errs.append(check_close(
                f"rwkv6_scan_bwd {n}", g, wnt, rtol=ERR_RTOL,
                atol=ERR_ATOL * max(1.0, float(wnt.abs().max()))))
        else:
            errs.append(check_scan(f"rwkv6_scan_bwd {n}", g, wnt))
    out = dict(max_abs_err=max(errs),
               grad_scale=max(float(w.abs().max()) for w in want),
               deterministic=all(torch.equal(a, b)
                                 for a, b in zip(got, again)))
    gate(out["deterministic"], "rwkv6_scan_bwd: two calls differ")
    if not timed:
        return out
    e = r.element_size()
    nbytes = e * 8 * r.numel() + 4 * dy.numel() + 4 * 2 * u.numel()
    # the rule of rows 6-7 (see ssm_bwd_case): per step and head the
    # boundary states, the adjoint's and the cross-tile products of dr, dk
    # and dv (10·P²); the in-tile blocks of dr, dk, dv and dw and the two
    # score blocks they need (12·L·P)
    L = rwkv.CHUNK
    flops = B * S * H * (10 * P * P + 12 * L * P)
    bound_ms, bound_by = bound(nbytes, flops)

    def kernel():
        return rwkv.rwkv6_scan_bwd(*ops)
    out.update(ms=timer.ms(kernel, iters=5),
               ms_held=timer.ms(kernel, iters=5, hold=True),
               host_us=timer.host_us(kernel, calls=10),
               plain_ms=timer.ms(lambda: rwkv.rwkv6_scan_bwd_plain(*ops),
                                 iters=1, warmup=0),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               bytes=nbytes, flops=flops)
    return out


def bwd_sweep(torch, ssm, rwkv, timer):
    """Every instantiation of the two backward kernels once against its
    plain backward twin, untimed, at a small B and a ragged S with exact 0
    and 1.0 decays: row 6-bwd at N in STATE_SIZES and P in {8, 32, 64, 256}
    (CTAs of 1, 2 and 4 warps; four row slices at 256), row 7-bwd at P in
    HEAD_SIZES in bf16 and fp32 (the model's decays, exact 0 among them).
    Each case also gates two calls bit for bit. Returns the checks run and
    the largest error per kernel."""
    worst = {"ssm_scan_bwd": 0.0, "rwkv6_scan_bwd": 0.0}
    n = 0
    for N in ssm.STATE_SIZES:
        for P in (8, 32, 64, 256):
            r = ssm_bwd_case(torch, ssm, timer, B=2, S=37, H=3, P=P, N=N,
                             seed=N + P, edges=True, timed=False)
            worst["ssm_scan_bwd"] = max(worst["ssm_scan_bwd"],
                                        r["max_abs_err"])
            n += 1
    for P in rwkv.HEAD_SIZES:
        for dtype in (torch.bfloat16, torch.float32):
            r = rwkv_bwd_case(torch, rwkv, timer, B=2, S=37, H=3, P=P,
                              seed=P, dtype=dtype, decays="model",
                              timed=False)
            worst["rwkv6_scan_bwd"] = max(worst["rwkv6_scan_bwd"],
                                          r["max_abs_err"])
            n += 1
    return dict(checks=n, max_abs_err=worst)


def bwd_design(torch, ssm, rwkv, shapes):
    """The backward kernels' design numbers at ``shapes`` (name -> B, S, H,
    P): warps a CTA, the grid, dynamic shared bytes and CTAs an SM of both
    passes, the scratch bytes of the tile-boundary states and of the
    partials; the HMMA (mma.sync) count in the SASS of each pass of each
    backward (raises if one has none: the tensor-core design is not in
    the build); registers, shared memory and spill of every instantiation
    of both passes (ptxas)."""
    from repro_torch.kernels import _cuda
    out = {"launch": {}}
    for name, (B, S, H, P) in shapes.items():
        out["launch"][name] = {
            "ssm_scan_bwd": ssm.bwd_design(B, S, H, P, P),
            "rwkv6_scan_bwd bf16": rwkv.bwd_design(B, S, H, P,
                                                   torch.bfloat16),
            "rwkv6_scan_bwd f32": rwkv.bwd_design(B, S, H, P,
                                                  torch.float32)}
    out["hmma_in_sass"] = {
        f"{lib} pass {i}": sass_count(lib, "HMMA", f"{lib}_bwd_{kernel}")
        for lib in (ssm._LIB_NAME, rwkv._LIB_NAME)
        for i, kernel in ((1, "states_kernel"), (2, "kernel"))}
    if not all(out["hmma_in_sass"].values()):
        raise AssertionError(f"no HMMA in a backward kernel's SASS: "
                             f"{out['hmma_in_sass']}")
    out["ptxas"] = [
        f"{marker[:-1]} {row}"
        for lib, marker, names in (
            (ssm._LIB_NAME, "ssm_scan_bwd_states_kernelI", ("N", "W")),
            (ssm._LIB_NAME, "ssm_scan_bwd_kernelI", ("N", "W")),
            (rwkv._LIB_NAME, "rwkv6_scan_bwd_states_kernelI", ("P",)),
            (rwkv._LIB_NAME, "rwkv6_scan_bwd_kernelI", ("P",)))
        for row in ptxas_summary(_cuda.BUILD_LOG.get(lib, ""), marker,
                                 names)]
    return out


def train_smoke_archs(torch, np, registry, transformer, counters):
    """(e) one smoke-size train step (fp32) of every assigned arch on the
    card against the same step on the CPU port: the loss and the gradient
    norm."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import tree_map

    out, bad = {}, []
    for arch in registry.ASSIGNED:
        cfg = registry.get_smoke_config(arch).replace(dtype=torch.float32)
        params = transformer.init_params(5, cfg, device="cpu")
        rng = np.random.default_rng(5)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 32)).astype(np.int32))}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, 24, cfg.d_model)).astype(np.float32))
        if cfg.modality == "vision":
            batch["frontend"] = torch.from_numpy(rng.standard_normal(
                (2, 8, cfg.d_model)).astype(np.float32))
        adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
        step = make_train_step(cfg, adamw)
        _, _, cm = step(params, opt.init_opt_state(params), batch)
        gp = tree_map(lambda a: a.to(DEV), params)
        counters.reset()
        _, _, gm = step(gp, opt.init_opt_state(gp),
                        {k: v.to(DEV) for k, v in batch.items()})
        sync(torch)
        launches = {k: n for k, n in counters.read().items() if n}
        rel = {k: abs(float(gm[k]) - float(cm[k])) / max(abs(float(cm[k])),
                                                         1e-30)
               for k in ("loss", "grad_norm")}
        out[arch] = dict(loss_card=float(gm["loss"]),
                         loss_cpu=float(cm["loss"]), rel_err=rel,
                         launches=launches)
        if rel["loss"] > SMOKE_LOSS_RTOL or rel["grad_norm"] > 1e-3:
            bad.append(arch)
        if cfg.family in ("ssm", "hybrid") and not launches:
            bad.append(f"{arch}: no scan kernel launched")
    gate(not bad, f"train smoke archs card vs CPU: {bad}")
    log(f"train smoke archs card vs CPU: {json.dumps(out)}")
    return out


def train_e2e(torch, np, registry, transformer, counters, ssm, rwkv, timer):
    """Phase 21: (a)-(e) of the training path. Returns (summary, the
    backward kernels' rows, their launches on (c)'s runs)."""
    t0 = time.perf_counter()
    out = {"card": card_line()}
    out["tinyllama"] = train_tinyllama(torch, np, registry, transformer,
                                       counters)
    out["grads_vs_cpu"] = train_grads_vs_cpu(torch, registry, transformer)
    zcfg = registry.get_config("zamba2-1.2b")
    n_super = zcfg.num_layers // zcfg.shared_attn_period
    in_super = n_super * zcfg.shared_attn_period
    out["zamba2"] = train_recurrent(
        torch, np, registry, transformer, counters, "zamba2-1.2b", None,
        REC_B, REC_S, REC_STEPS,
        {"ssm_scan": zcfg.num_layers + in_super,
         "ssm_scan_bwd": zcfg.num_layers}, "ssm_scan")
    rl = RWKV_LAYERS
    out["rwkv6"] = train_recurrent(
        torch, np, registry, transformer, counters, "rwkv6-7b", rl, REC_B,
        REC_S, REC_STEPS,
        {"rwkv6_scan": 2 * rl, "rwkv6_scan_bwd": rl}, "rwkv6_scan")
    out["scan_grads_vs_plain"] = [
        train_scan_grads_vs_plain(torch, registry, transformer, counters,
                                  ssm, rwkv, "zamba2-1.2b", torch.float32,
                                  shared_attn_period=2),
        train_scan_grads_vs_plain(torch, registry, transformer, counters,
                                  ssm, rwkv, "rwkv6-7b", torch.bfloat16),
        train_scan_grads_vs_plain(torch, registry, transformer, counters,
                                  ssm, rwkv, "rwkv6-7b", torch.float32)]
    rows = {}
    shape = dict(B=BWD_B, S=BWD_S, H=BWD_H, P=BWD_P)
    ragged = dict(shape, B=max(BWD_B // 2, 1), S=BWD_S - 1)
    tag = " ".join(f"{k}={v}" for k, v in shape.items())
    rows["ssm_scan_bwd"] = ssm_bwd_case(torch, ssm, timer, N=BWD_P, seed=40,
                                        **shape)
    log(f"ssm_scan_bwd zamba2 shape {tag} N={BWD_P}: "
        f"{json.dumps(rows['ssm_scan_bwd'])}")
    r = ssm_bwd_case(torch, ssm, timer, N=BWD_P, seed=41, edges=True,
                     timed=False, **ragged)
    log(f"ssm_scan_bwd ragged S={ragged['S']}, decays with exact 0 and "
        f"1.0: {json.dumps(r)}")
    rows["rwkv6_scan_bwd"] = rwkv_bwd_case(torch, rwkv, timer, seed=42,
                                           dtype=torch.bfloat16, **shape)
    log(f"rwkv6_scan_bwd rwkv6 shape {tag} bf16: "
        f"{json.dumps(rows['rwkv6_scan_bwd'])}")
    r = rwkv_bwd_case(torch, rwkv, timer, seed=43, dtype=torch.float32,
                      **shape)
    rows["rwkv6_scan_bwd_f32"] = r
    log(f"rwkv6_scan_bwd rwkv6 shape {tag} f32: {json.dumps(r)}")
    r = rwkv_bwd_case(torch, rwkv, timer, seed=44, dtype=torch.bfloat16,
                      decays="model", timed=False, **ragged)
    log(f"rwkv6_scan_bwd ragged S={ragged['S']}, the model's bf16 decays "
        f"with exact 0: {json.dumps(r)}")
    out["backward_sweep"] = bwd_sweep(torch, ssm, rwkv, timer)
    log(f"backward kernels, every instantiation vs the plain twins: "
        f"{json.dumps(out['backward_sweep'])}")
    out["backward_design"] = bwd_design(
        torch, ssm, rwkv, {"(d) " + tag: (BWD_B, BWD_S, BWD_H, BWD_P),
                           "(c) B=%d S=%d" % (REC_B, REC_S):
                               (REC_B, REC_S, BWD_H, BWD_P)})
    log(f"backward kernels, chunked tensor-core design: "
        f"{json.dumps(out['backward_design'])}")
    out["backward_kernels"] = rows
    out["smoke_archs"] = train_smoke_archs(torch, np, registry, transformer,
                                           counters)
    launches = {"ssm_scan_bwd": out["zamba2"]["launches"].get(
                    "ssm_scan_bwd", 0),
                "rwkv6_scan_bwd": out["rwkv6"]["launches"].get(
                    "rwkv6_scan_bwd", 0)}
    out["wall_s_phase"] = time.perf_counter() - t0
    return out, rows, launches


# ---------------------------------------------------------------------------
# phase 22: the mesh and the collective attention backends
# ---------------------------------------------------------------------------
COLL_WORLD = 4              # ranks of the attention pool, all on the card
COLL_ITERS = 20             # timed calls of each split (wall p50)
COLL_BS, COLL_NB = 16, 2048
COLL_TIMEOUT_S = 300        # a rank that waits longer on a collective fails
PLACED_LAYERS, PLACED_B, PLACED_S, PLACED_STEPS = 2, 8, 512, 3


def coll_close(got, want, rtol=ERR_RTOL, atol=ERR_ATOL):
    """(within 2 bf16 ulps + floor, as ``check_close``; max abs err)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all()) and \
        bool(got.isfinite().all())
    return ok, float(err.max())


def coll_pool(torch, cfg, int8, seed):
    """A pool at ``cfg``'s attention width (one layer, 2048 blocks of 16, 4
    block shards) holding 8 sequences of 300-2000 tokens that
    ``PagedKVCache`` allocates round-robin over the shards; random bf16 K/V
    from ``seed`` (int8: ``quantize_kv`` of them). Every rank makes the
    same pool, tables and queries."""
    import numpy as np
    from repro_torch.models.kv_quant import quantize_kv
    from repro_torch.serving.kvcache import PagedKVCache
    kv = PagedKVCache(cfg.replace(num_layers=1), num_blocks=COLL_NB,
                      block_size=COLL_BS, n_shards=COLL_WORLD,
                      kv_dtype="int8" if int8 else "bf16", device=DEV)
    lens = np.random.default_rng(22).integers(300, 2001, size=8)
    ids = list(range(len(lens)))
    for i, n in enumerate(lens):
        kv.allocate(i, int(n))
    g = torch.Generator(device=DEV).manual_seed(seed)
    shape = kv.k_pool.shape[1:]
    k = torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
    c = dict(ks=None, vs=None, kp=k, vp=v)
    if int8:
        c["kp"], c["ks"] = quantize_kv(k)
        c["vp"], c["vs"] = quantize_kv(v)
    bt, clen = kv.block_table_batch(ids)
    lt, lp, _ = kv.block_table_shards(ids)
    dev = lambda a: torch.as_tensor(a, device=DEV)  # noqa: E731
    c.update(bt=dev(bt), clen=dev(clen), lt=dev(lt), lp=dev(lp),
             npb=kv.blocks_per_shard, lens=lens.tolist())
    c["q"] = torch.randn((len(lens), cfg.num_heads, cfg.resolved_head_dim),
                         generator=g, device=DEV).to(torch.bfloat16)
    return c


def coll_placed(full, mesh, spec):
    """``full`` (the same on every rank) placed at ``spec``: this rank's
    chunk, taken without a collective and made contiguous, as the kernel
    reads it."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.core.disagg import placements
    pl = placements(spec, mesh)
    t = distribute_tensor(full, mesh, pl, src_data_rank=None)
    if not t.to_local().is_contiguous():
        t = DTensor.from_local(t.to_local().contiguous(), mesh, pl,
                               run_check=False)
    return t


def coll_local(full, mesh, placements):
    """This rank's chunk of ``full`` at ``placements``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, mesh, placements,
                             src_data_rank=None).to_local()


def coll_slices(torch, pda, c, rows, heads):
    """The in-process partition over the same slices: one launch per
    (batch range, kv-head range) of the whole operands, the slices
    ``AttentionWorkerPool`` cuts (kv heads ``[w·Hkv/n, (w+1)·Hkv/n)``,
    ``request_splits`` of the batch), put together."""
    from repro_torch.serving.worker_pool import request_splits
    q = c["q"]
    B, H, hd = q.shape
    Hkv = c["kp"].shape[0]
    G, hk = H // Hkv, Hkv // heads
    out = torch.empty_like(q).view(B, Hkv, G, hd)
    for lo, hi in request_splits(B, rows):
        for w in range(heads):
            sl = slice(w * hk, (w + 1) * hk)
            skw = {} if c["ks"] is None else dict(k_scale=c["ks"][sl],
                                                  v_scale=c["vs"][sl])
            out[lo:hi, sl] = pda.paged_decode_attention(
                q[lo:hi].reshape(hi - lo, Hkv, G, hd)[:, sl].contiguous(),
                c["kp"][sl], c["vp"][sl], c["bt"][lo:hi].contiguous(),
                c["clen"][lo:hi].contiguous(), **skw)
    return out.view(B, H, hd)


def coll_worker_pool(torch, cfg, c, partition, n):
    """``AttentionWorkerPool(n, partition).attend_paged`` over the same pool
    as the engine calls it, the last stored token of every sequence served
    as the incoming one (its K/V read back from the pool, int8
    dequantized). That call merges the incoming token's partial into each
    worker's prefix partial; the collective backends take the stored
    tokens only, as the reference's do. So the two agree to bf16 rounding,
    not bit for bit."""
    from repro_torch.serving.worker_pool import AttentionWorkerPool
    last = c["clen"].long() - 1
    blk = c["bt"].long().gather(1, (last // COLL_BS)[:, None])[:, 0]
    off = last % COLL_BS

    def incoming(pool, scale):
        x = pool[:, blk, off].float()              # (Hkv, B, hd)
        if scale is not None:
            x = x * scale[:, blk, off][..., None]
        return x.transpose(0, 1).to(torch.bfloat16).contiguous()

    k_new, v_new = incoming(c["kp"], c["ks"]), incoming(c["vp"], c["vs"])
    pool = AttentionWorkerPool(cfg, n, partition,
                               "bf16" if c["ks"] is None else "int8")
    kw = {} if c["ks"] is None else dict(k_scale=c["ks"], v_scale=c["vs"])
    if partition == "block":
        base = (torch.arange(n, device=DEV, dtype=torch.int32)
                * c["npb"])[:, None, None]
        kw.update(shard_tables=c["lt"] + base, shard_positions=c["lp"])
    clen = c["clen"] - 1
    return lambda: pool.attend_paged(c["q"], c["kp"], c["vp"], c["bt"],
                                     clen, k_new, v_new, **kw)


def coll_cases():
    """Phase 22's paged calls: (name, arch, mesh shape, mesh axes, split,
    axis, batch axis, int8)."""
    out = []
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        for arch, name, shape, axes, split, axis, baxis in (
                ("llama3-8b", "head (2, 2), batch over data", (2, 2),
                 ("data", "model"), "head", "model", "data"),
                ("llama3-8b", "head x 4", (4,), ("model",), "head", "model",
                 None),
                ("llama3-8b", "request x 2", (2, 2), ("data", "model"),
                 "request", "data", None),
                ("llama3-8b", "request x 4", (4,), ("data",), "request",
                 "data", None),
                ("llama3-8b", "block x 4", (4,), ("attn",), "block", "attn",
                 None),
                ("glm4-9b", "G=16 head x 2", (2, 2), ("data", "model"),
                 "head", "model", None),
                ("glm4-9b", "G=16 block x 4", (4,), ("attn",), "block",
                 "attn", None)):
            out.append((f"{arch} {name} {tag}", arch, shape, axes, split,
                        axis, baxis, int8))
    return out


def coll_rank(rank, world, store, out_dir, dev):
    """One rank of phase 22's attention pool, a spawned process sharing the
    card: loads the libraries phase 1 built (it never builds), drives every
    split over its shards, and saves its gates' numbers for the parent."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    global DEV
    DEV = dev                     # the parent's (a CPU rehearsal sets it)
    if DEV == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLL_TIMEOUT_S))
    try:
        res = coll_rank_run(torch, np, dist, rank)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def coll_rank_run(torch, np, dist, rank):
    from repro_torch.configs import registry
    from repro_torch.core import attention_parallel as ap
    from repro_torch.core import combine as C
    from repro_torch.core.disagg import P
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.launch.mesh import make_test_mesh

    for lib in (pda._LIB_NAME, da._LIB_NAME):
        if DEV == "cuda" and not _cuda._target(lib).exists():
            raise RuntimeError(f"{_cuda._target(lib)} is missing: phase 1 "
                               f"builds the libraries, a rank never does")
    from torch.distributed.tensor.debug import CommDebugMode
    sent = {"bytes": 0, "calls": 0, "others": 0}
    all_reduce = dist.all_reduce

    def counted(t, *a, **k):                 # what this rank hands over
        sent["bytes"] += t.numel() * t.element_size()
        sent["calls"] += 1
        return all_reduce(t, *a, **k)
    dist.all_reduce = counted
    fns = (pda.paged_decode_attention, pda.paged_decode_attention_int8,
           da.decode_attention, da.decode_attention_int8)

    def gated(fn):
        """``fn()`` with every launch counter at 0 before it, read after:
        its launches, the bytes it hands to ``all_reduce`` and the count
        of every other collective it issues (``CommDebugMode`` sees the
        functional ones DTensor's redistribute uses too)."""
        sync(torch)
        dist.barrier()
        for f in fns:
            f.launches = 0
        sent.update(bytes=0, calls=0)
        with CommDebugMode() as mode:
            out = fn()
        sync(torch)
        sent["others"] = mode.get_total_counts() - sent["calls"]
        return out, {f.__name__: f.launches for f in fns}, dict(sent)

    def wall_p50(fn):
        return coll_wall_p50(torch, np, fn, dist.barrier)

    def alone_p50(fn):
        """The in-process pool's wall, rank 0 alone on the card."""
        dist.barrier()
        p50 = coll_wall_p50(torch, np, fn) if rank == 0 else None
        dist.barrier()
        return p50

    pools, meshes, res = {}, {}, {}
    for name, arch, shape, axes, split, axis, baxis, int8 in coll_cases():
        cfg = registry.get_config(arch)
        if (arch, int8) not in pools:
            pools[(arch, int8)] = coll_pool(torch, cfg, int8, seed=7 + int8)
        c = pools[(arch, int8)]
        if (shape, axes) not in meshes:
            meshes[(shape, axes)] = make_test_mesh(shape, axes,
                                                   device_type=DEV)
        mesh = meshes[(shape, axes)]
        sizes = dict(zip(axes, shape))
        n = sizes[axis]
        B, H, hd = c["q"].shape
        if split == "head":
            spec, sspec = P(axis, None, None, None), P(axis, None, None)
        elif split == "request":
            spec = sspec = P()
        else:
            spec, sspec = P(None, axis, None, None), P(None, axis, None)
        kv = [coll_placed(c["kp"], mesh, spec),
              coll_placed(c["vp"], mesh, spec)]
        skw = {} if c["ks"] is None else dict(
            k_scale=coll_placed(c["ks"], mesh, sspec),
            v_scale=coll_placed(c["vs"], mesh, sspec))
        if split == "head":
            def fn(kv=kv, skw=skw, mesh=mesh, axis=axis, baxis=baxis, c=c):
                return ap.head_parallel_paged_decode_attention(
                    mesh, axis, c["q"], *kv, c["bt"], c["clen"],
                    batch_axis=baxis, **skw)
        elif split == "request":
            def fn(kv=kv, skw=skw, mesh=mesh, axis=axis, c=c):
                return ap.request_parallel_paged_decode_attention(
                    mesh, axis, c["q"], *kv, c["bt"], c["clen"], **skw)
        else:
            def fn(kv=kv, skw=skw, mesh=mesh, axis=axis, c=c):
                return ap.block_parallel_paged_decode_attention(
                    mesh, axis, c["q"], *kv, c["lt"], c["lp"], c["clen"],
                    **skw)
        out, launches, coll = gated(fn)
        entry = ("paged_decode_attention_int8" if int8
                 else "paged_decode_attention")
        r = dict(launches=launches, bytes=coll["bytes"],
                 other_collectives=coll["others"],
                 want_launches={f.__name__: int(f.__name__ == entry)
                                for f in fns},
                 want_bytes=(B * H * (hd + 2) * 4 if split == "block"
                             else 0),
                 placements=[repr(p) for p in out.placements])
        got = out.to_local()
        # the references, in this process (their launches not counted)
        if split == "block":
            skw_full = {} if c["ks"] is None else dict(k_scale=c["ks"],
                                                       v_scale=c["vs"])
            base = (torch.arange(n, device=DEV, dtype=torch.int32)
                    * c["npb"])[:, None, None]
            inproc = C.finalize(C.combine_many([
                ops.paged_decode_partial_pos(
                    c["q"], c["kp"], c["vp"], (c["lt"] + base)[w],
                    c["lp"][w], c["clen"], **skw_full) for w in range(n)]))
            single = pda.paged_decode_attention(
                c["q"].reshape(B, cfg.num_kv_heads, -1, hd), c["kp"],
                c["vp"], c["bt"], c["clen"], **skw_full).reshape(B, H, hd)
            r["in_process_block"] = coll_close(got, inproc)
            r["single_launch"] = coll_close(got, single)
        else:
            rows = sizes[baxis] if split == "head" and baxis else (
                n if split == "request" else 1)
            heads = n if split == "head" else 1
            want = coll_local(coll_slices(torch, pda, c, rows, heads), mesh,
                              out.placements)
            r["equal_in_process_slices"] = bool(torch.equal(got, want))
        pool_fn = coll_worker_pool(torch, cfg, c, split, n)
        r["worker_pool"] = coll_close(
            got, coll_local(pool_fn(), mesh, out.placements))
        r["wall_ms_p50"] = wall_p50(fn)
        r["worker_pool_wall_ms_p50"] = alone_p50(pool_fn)
        res[name] = r
    res["dense"] = coll_dense(torch, np, ap, C, P, make_test_mesh(
        (COLL_WORLD,), ("model",), device_type=DEV), gated, wall_p50)
    return res


def coll_wall_p50(torch, np, fn, before=lambda: None):
    """Median wall (ms) of ``fn`` to the card's end, over COLL_ITERS calls
    after a warm one; ``before`` runs ahead of each (the ranks' barrier)."""
    fn()
    sync(torch)
    times = []
    for _ in range(COLL_ITERS):
        before()
        t0 = time.perf_counter()
        fn()
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def coll_dense(torch, np, ap, C, P, mesh, gated, wall_p50):
    """The three dense splits x 4 on a (8, 2048, 8, 128) bf16 seq-major
    cache (llama3-8b's attention width): seq against the whole cache's
    partial computed in this process (2 bf16 ulps), head and request
    against the same slices computed in this process (bit for bit). They
    launch no kernel; only seq's triple crosses ranks."""
    g = torch.Generator(device=DEV).manual_seed(23)
    B, S, Hkv, hd, H = 8, 2048, 8, 128, 32
    n = COLL_WORLD
    q = torch.randn((B, H, hd), generator=g, device=DEV).to(torch.bfloat16)
    kc = torch.randn((B, S, Hkv, hd), generator=g,
                     device=DEV).to(torch.bfloat16)
    vc = torch.randn((B, S, Hkv, hd), generator=g,
                     device=DEV).to(torch.bfloat16)
    clen = torch.as_tensor(np.random.default_rng(22).integers(
        300, 2001, size=B), dtype=torch.int32, device=DEV)
    pos = torch.arange(S, device=DEV)[None]

    def attend(qs, ks, vs, cl):
        return C.finalize(ap._masked_partial(
            qs, ks, vs, pos < cl[:, None])).to(torch.bfloat16)

    res = {}
    for split, fn_, spec in (
            ("seq", ap.seq_parallel_decode_attention,
             P(None, "model", None, None)),
            ("head", ap.head_parallel_decode_attention,
             P(None, None, "model", None)),
            ("request", ap.request_parallel_decode_attention,
             P("model", None, None, None))):
        kv = (coll_placed(kc, mesh, spec), coll_placed(vc, mesh, spec))

        def fn(f=fn_, kv=kv):
            return f(mesh, "model", q, *kv, clen)
        out, launches, coll = gated(fn)
        got = out.to_local()
        r = dict(launches=launches, bytes=coll["bytes"],
                 other_collectives=coll["others"],
                 want_launches={k: 0 for k in launches},
                 want_bytes=B * H * (hd + 2) * 4 if split == "seq" else 0,
                 placements=[repr(p) for p in out.placements])
        if split == "seq":
            r["whole_cache"] = coll_close(got, coll_local(
                attend(q, kc, vc, clen), mesh, out.placements))
        elif split == "head":
            want = torch.cat([attend(
                q[:, w * H // n:(w + 1) * H // n],
                kc[:, :, w * Hkv // n:(w + 1) * Hkv // n],
                vc[:, :, w * Hkv // n:(w + 1) * Hkv // n], clen)
                for w in range(n)], dim=1)
            r["equal_in_process_slices"] = bool(torch.equal(
                got, coll_local(want, mesh, out.placements)))
        else:
            want = torch.cat([attend(
                q[w * B // n:(w + 1) * B // n],
                kc[w * B // n:(w + 1) * B // n],
                vc[w * B // n:(w + 1) * B // n],
                clen[w * B // n:(w + 1) * B // n]) for w in range(n)])
            r["equal_in_process_slices"] = bool(torch.equal(
                got, coll_local(want, mesh, out.placements)))
        r["wall_ms_p50"] = wall_p50(fn)
        res[f"dense {split} x 4 bf16"] = r
    return res


def collective_e2e(torch):
    """Phase 22 (a): the collective attention backends, 4 spawned ranks of
    one gloo world sharing the card. Gates every rank's launches, the bytes
    it hands to the all-reduces, the count of its other collectives, and
    its output against the in-process partition. Returns (summary, row 1 / row 3 launches of the gated calls
    summed over the ranks)."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    log("phase 22: 4 ranks on one H100, one gloo world: NCCL refuses two "
        "ranks on one device, and gloo's all-reduce stages CUDA tensors "
        "through host memory, so the collective walls below are no network "
        "figure (4 processes also time-share the card)")
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(coll_rank, args=(COLL_WORLD, os.path.join(
            d, "store"), d, DEV), nprocs=COLL_WORLD, start_method="spawn")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(COLL_WORLD)]
    cases = {k: [r[k] for r in ranks] for k in ranks[0] if k != "dense"}
    cases.update({k: [r["dense"][k] for r in ranks]
                  for k in ranks[0]["dense"]})
    totals = {"paged_decode_attention": 0, "paged_decode_attention_int8": 0}
    out = {}
    for name, per in cases.items():
        for i, r in enumerate(per):
            gate(r["launches"] == r["want_launches"],
                 f"phase 22 {name} rank {i}: launches {r['launches']}, "
                 f"want {r['want_launches']}")
            gate(r["bytes"] == r["want_bytes"],
                 f"phase 22 {name} rank {i}: {r['bytes']} bytes to the "
                 f"all-reduces, want {r['want_bytes']}")
            gate(r["other_collectives"] == 0,
                 f"phase 22 {name} rank {i}: {r['other_collectives']} "
                 f"collectives besides the all-reduces, want 0")
            for key in ("in_process_block", "single_launch", "worker_pool",
                        "whole_cache"):
                if key in r:
                    gate(r[key][0], f"phase 22 {name} rank {i}: "
                         f"{key} max abs err {r[key][1]:.3e} over 2 bf16 "
                         f"ulps + {ERR_ATOL}")
            if "equal_in_process_slices" in r:
                gate(r["equal_in_process_slices"],
                     f"phase 22 {name} rank {i}: not bit for bit the "
                     f"in-process partition over the same slices")
            for k in totals:
                totals[k] += r["launches"].get(k, 0)
        first = per[0]
        out[name] = dict(
            wall_ms_p50_rank0=first["wall_ms_p50"],
            wall_ms_p50_max_rank=max(r["wall_ms_p50"] for r in per),
            worker_pool_wall_ms_p50=first.get("worker_pool_wall_ms_p50"),
            launches_per_rank=[{k: v for k, v in r["launches"].items() if v}
                               for r in per],
            bytes_per_rank=[r["bytes"] for r in per],
            other_collectives_per_rank=[r["other_collectives"] for r in per],
            placements=first["placements"],
            max_abs_err={k: max(r[k][1] for r in per)
                         for k in ("in_process_block", "single_launch",
                                   "worker_pool", "whole_cache")
                         if k in first},
            bit_equal_in_process_slices=[
                r.get("equal_in_process_slices") for r in per])
        log(f"phase 22 {name}: {json.dumps(out[name])}")
    out["wall_s"] = time.perf_counter() - t0
    return out, totals


def placed_train_e2e(torch, np, registry, transformer):
    """Phase 22 (b): the placed train step on a (1, 1) mesh (NCCL, world
    size 1, this process): tinyllama-1.1b at full width and 2 layers, 3
    steps of B=8 x 512 ``packed_batches``, parameters, AdamW state and
    batch placed by ``core/disagg.place`` at ``specs_for_params`` /
    ``specs_for_batch``; equal to ``make_train_step``'s eager steps from
    the same parameters and batches bit for bit (loss, every leaf), and
    every leaf keeps its placement."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.core import disagg
    from repro_torch.data.synthetic import packed_batches
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import tree_leaves

    cfg = registry.get_config("tinyllama-1.1b").replace(
        num_layers=PLACED_LAYERS)
    params = transformer.init_params(0, cfg, device=DEV)
    batches = list(itertools.islice(packed_batches(
        cfg.vocab_size, PLACED_B, PLACED_S, seed=3, device=DEV),
        PLACED_STEPS))
    step = make_train_step(cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=10))

    def run(p, s, place=lambda b: b):
        losses, walls = [], []
        for b in batches:
            sync(torch)
            t0 = time.perf_counter()
            p, s, m = step(p, s, place(b))
            sync(torch)
            walls.append(time.perf_counter() - t0)
            loss = m["loss"]
            losses.append(float(loss.full_tensor() if isinstance(
                loss, DTensor) else loss))
        return p, s, losses, walls

    p_e, s_e, loss_e, wall_e = run(params, opt.init_opt_state(params))
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                                init_method=f"file://{d}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_test_mesh((1, 1), ("data", "model"), device_type=DEV)
            specs = disagg.specs_for_params(cfg, params, mesh)
            state = opt.init_opt_state(params)
            p0 = disagg.place(params, specs, mesh)
            s0 = opt.OptState(disagg.place(state.step, disagg.P(), mesh),
                              disagg.place(state.mu, specs, mesh),
                              disagg.place(state.nu, specs, mesh))
            p_p, s_p, loss_p, wall_p = run(p0, s0, lambda b: disagg.place(
                b, disagg.specs_for_batch(cfg, b, mesh), mesh))
            leaves = list(zip(
                tree_leaves((p_p, s_p.mu, s_p.nu, s_p.step)),
                tree_leaves((p_e, s_e.mu, s_e.nu, s_e.step)),
                tree_leaves((p0, s0.mu, s0.nu, s0.step))))
            kept = all(isinstance(a, DTensor) and a.placements ==
                       b0.placements for a, _, b0 in leaves)
            differ = sum(not torch.equal(a.full_tensor(), b)
                         for a, b, _ in leaves)
        finally:
            dist.destroy_process_group()
    out = dict(layers=PLACED_LAYERS, batch=PLACED_B, seq=PLACED_S,
               steps=PLACED_STEPS, loss_eager=loss_e, loss_placed=loss_p,
               leaves=len(leaves), leaves_differing=differ,
               placements_kept=kept, step_walls_eager_s=wall_e,
               step_walls_placed_s=wall_p)
    gate(loss_p == loss_e, f"placed (1, 1) train step: losses {loss_p} != "
         f"eager {loss_e}")
    gate(differ == 0, f"placed (1, 1) train step: {differ} of "
         f"{len(leaves)} leaves differ from the eager step's")
    gate(kept, "placed (1, 1) train step: a leaf lost its placement")
    log(f"phase 22 placed train step (1, 1): {json.dumps(out)}")
    return out


def phase22(torch, np, registry, transformer):
    """Phase 22: (a) the collective backends, (b) the placed train step.
    Returns (summary, row 1 / row 3 launches)."""
    t0 = time.perf_counter()
    out, totals = collective_e2e(torch)
    out["placed_train_step"] = placed_train_e2e(torch, np, registry,
                                                transformer)
    out["wall_s_phase"] = time.perf_counter() - t0
    for k, n in totals.items():
        gate(n > 0, f"phase 22: {k} was not launched by the collective "
             f"backends")
    return out, totals


# ---------------------------------------------------------------------------
# row 1 at glm4-9b's shapes, both designs (``--row1``)
# ---------------------------------------------------------------------------
# the paged decode library's kernels in nvcc's ptxas log: the CUDA-core
# lanes (int8 pools; bf16 below G = 8) and the tensor-core design
ROW1_MARKERS = [("paged_decode_kernelI", ("hd", "G")),
                ("paged_decode_kernel_tcI", ("hd", "G"))]
# one decode step of glm4-9b.lamina-decode: 128 sequences of kimi-conv
# contexts handed over (~5K tokens: up to the 7,168-token prompt cap plus
# up to 1,024 outputs); glm4-9b.chat-azure's: 64 of azure-conv's ~1.2K
ROW1_LAMINA_LENS = (2048, 8192)
ROW1_CHAT_LENS = (200, 2400)


def lanes_variant(pda, _cuda):
    """The bf16 entry of a copy of the paged decode source whose
    tensor-core threshold lies above every G (every launch on the CUDA-core
    lanes, as before the tensor-core design), built into ``build/`` and
    loaded; and nvcc's ptxas log of the copy."""
    import ctypes
    src = (_cuda.CSRC / "paged_decode_attention.cu").read_text()
    old = "constexpr int kTcMinG = 8;"
    if old not in src:
        raise AssertionError(f"{old!r} not in the paged decode source")
    out_dir = _cuda.BUILD_DIR / "lanes_variant"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "paged_decode_attention_lanes.cu"
    cu.write_text(src.replace(old, "constexpr int kTcMinG = 32;"))
    so = out_dir / "paged_decode_attention_lanes.so"
    res = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I",
                          str(_cuda.CSRC), "-o", str(so), str(cu)],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"lanes variant: nvcc exit {res.returncode}\n"
                           f"{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(so)).paged_decode_attention_bf16
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, res.stdout + res.stderr


def row1_glm4(torch, np, pda, _cuda, timer):
    """Row 1 at glm4-9b's decode shapes (G = 16) and at G = 8, each timed
    on the tensor-core design and on the lanes (``lanes_variant``), every
    call checked against the plain twin with NaN in every row no mask
    keeps: one head-partition worker of the lamina cell (B = 128, Hkv =
    1), one block-partition shard's launch (B = 128, Hkv = 2, POS_PAD on
    half the slots), the chat cell's homogeneous launch (B = 64, Hkv = 2),
    phase 2's small glm4-9b and qwen3-moe shapes; then the tensor-core
    design at the lamina shape with the plan aimed at 2, 4 and 8 CTAs an
    SM. Returns {case: {design: decode_case's numbers}}."""
    lanes_fn, lanes_log = lanes_variant(pda, _cuda)
    for marker, names in ROW1_MARKERS:
        for row in ptxas_summary(lanes_log, marker, names):
            log(f"  ptxas lanes variant {marker[:-1]}: {row}")
    rng = np.random.default_rng(32)
    lamina = rng.integers(*ROW1_LAMINA_LENS, size=128).tolist()
    lamina[0] = ROW1_LAMINA_LENS[1]
    chat = rng.integers(*ROW1_CHAT_LENS, size=64).tolist()
    lens2k = rng.integers(1, 2049, size=8).tolist()
    lens2k[0] = 2048
    cases = [
        ("glm4-9b lamina head x2 B=128 Hkv=1 G=16", dict(
            B=128, Hkv=1, G=16, lens=lamina)),
        ("glm4-9b block x4 shard B=128 Hkv=2 G=16 POS_PAD", dict(
            B=128, Hkv=2, G=16, lens=lamina, pos_pad=True, library=False)),
        ("glm4-9b chat B=64 Hkv=2 G=16", dict(B=64, Hkv=2, G=16,
                                              lens=chat)),
        ("G=8 lamina-sized B=128 Hkv=2", dict(B=128, Hkv=2, G=8,
                                              lens=lamina)),
        ("glm4-9b B=8 Hkv=2 G=16", dict(B=8, Hkv=2, G=16, lens=lens2k)),
        ("qwen3-moe B=8 Hkv=4 G=8", dict(B=8, Hkv=4, G=8, lens=lens2k))]
    base_fn = pda._kernel_fn
    out = {}
    for name, kw in cases:
        row = out[name] = {}
        for design in ("tensor cores", "lanes", "tensor cores again"):
            lanes = design == "lanes"
            pda._kernel_fn = (lambda entry: lanes_fn) if lanes else base_fn
            n_tc = pda.paged_decode_attention.tc_launches
            try:
                r = decode_case(torch, pda, timer, hd=128, bs=16, seed=7,
                                **{"library": not lanes, **kw})
            finally:
                pda._kernel_fn = base_fn
            if not lanes:
                gate(pda.paged_decode_attention.tc_launches > n_tc,
                     f"row 1 {name}: no tensor-core launch counted")
            r.pop("launch")
            row[design] = r
            log(f"row 1 {name} [{design}]: {json.dumps(r)}")
        torch.cuda.empty_cache()
    name = cases[0][0]
    sweep = out[name]["plan sweep (CTAs an SM: [held ms, splits])"] = {}
    planned = pda.CTAS_PER_SM
    try:
        for per_sm in (2, 4, 8):
            pda.CTAS_PER_SM = per_sm
            r = decode_case(torch, pda, timer, hd=128, bs=16, seed=7,
                            library=False, **cases[0][1])
            sweep[per_sm] = [r["ms_held"], r["launch"]["splits"]]
    finally:
        pda.CTAS_PER_SM = planned
    log(f"row 1 {name} plan sweep (CTAs an SM: [held ms, splits]): "
        f"{json.dumps(sweep)}")
    out["tensor-core HMMA"] = sass_count(pda._LIB_NAME, "HMMA",
                                         "paged_decode_kernel_tc")
    return out


def row1_main() -> int:
    """``chip_smoke.py --row1``: phase 1's build of the paged decode
    library (ptxas lines of every instantiation), then ``row1_glm4`` (no
    result line)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import paged_decode_attention as pda
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _cuda.build([pda._LIB_NAME])
    for marker, names in ROW1_MARKERS:
        for row in ptxas_summary(_cuda.BUILD_LOG.get(pda._LIB_NAME, ""),
                                 marker, names):
            log(f"  ptxas {pda._LIB_NAME} {marker[:-1]}: {row}")
    out = row1_glm4(torch, np, pda, _cuda, Timer(torch))
    log(json.dumps({"row1": out}))
    if FAILED:
        raise AssertionError(f"{len(FAILED)} gate(s) failed: {FAILED}")
    return 0


def phase22_main() -> int:
    """``chip_smoke.py --phase22``: phase 1's build of the paged and dense
    decode libraries, then phase 22 alone (no result line)."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.models import transformer
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _cuda.build([pda._LIB_NAME, da._LIB_NAME])
    out, totals = phase22(torch, np, registry, transformer)
    log(json.dumps({"phase22": out, "launches": totals}))
    if FAILED:
        raise AssertionError(f"{len(FAILED)} gate(s) failed: {FAILED}")
    return 0


def phase23_main() -> int:
    """``chip_smoke.py --phase23``: phase 1's build, phase 21 (a) (the
    tinyllama training run whose peak phase 23 (b) is held against), then
    phase 23 alone (no result line)."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import rwkv6_scan as rwkv
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.models import transformer
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _cuda.build([pda._LIB_NAME, ppa._LIB_NAME, da._LIB_NAME, ssm._LIB_NAME,
                 rwkv._LIB_NAME])
    counters = Launches(pda, ppa, da, ssm, rwkv)
    train = train_tinyllama(torch, np, registry, transformer, counters)
    sweep_dir = str(ROOT / "build" / "dryrun")
    sweep = start_dry_sweep(registry, sweep_dir)
    out = dryrun_e2e(torch, np, registry, transformer, counters, train,
                     sweep, sweep_dir)
    log(json.dumps({"phase23": out}))
    if FAILED:
        raise AssertionError(f"{len(FAILED)} gate(s) failed: {FAILED}")
    return 0


# ---------------------------------------------------------------------------
# phase 23: the dry run on fake CUDA tensors
# ---------------------------------------------------------------------------
# the proof's per-chip bytes against a peak measured on the card
DRY_MEM_TOL = 0.10
# the reference's dry-run test config (test_sharding.py:155): tinyllama at
# 2 layers and a 2048-token vocab, decode_32k (B=128, S=32768)
DRY_DECODE = {"num_layers": 2, "vocab_size": 2048}
DRY_SWEEP_JOBS = 4            # records traced at once, one core each
DRY_SWEEP_TIMEOUT_S = 600     # the sweep runs beside phases 19-23 (c)
DENSE_FAMILY = ("tinyllama-1.1b", "llama3-8b")
# the sweep here: the dense family at every applicable shape, one shape of
# each other arch (the whole sweep, ``python -m repro_torch.launch.dryrun
# --all``, runs ~15 min on 7 cores: PERF.md §6), and llama3-8b decode_32k
# on the multi-pod mesh
DRY_OTHER_SHAPE = "decode_32k"


def face_cases(torch, np, dev):
    """Every kernel entry at one shape phase 2, 3 or 7 runs: (entry, the
    wrapper, operands, keywords)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bf16 = torch.bfloat16
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import rwkv6_scan as rwkv
    from repro_torch.kernels import ssm_scan as ssm
    # phase 2's llama3-8b decode: B=8, Hkv=8, G=4, hd=128, blocks of 16,
    # 2048 tokens a sequence at most
    B, Hkv, G, hd, bs, nb = 8, 8, 4, 128, 16, 128
    NB = B * nb + 1
    kp, vp = randn(Hkv, NB, bs, hd), randn(Hkv, NB, bs, hd)
    (kq, ks), (vq, vs) = quantize_pool(torch, kp), quantize_pool(torch, vp)
    kp, vp = kp.to(bf16), vp.to(bf16)
    tables = (1 + torch.arange(B * nb, device=dev, dtype=torch.int32)
              ).reshape(B, nb)
    lens = torch.from_numpy(np.random.default_rng(23).integers(
        1, nb * bs + 1, size=B).astype(np.int32)).to(dev)
    q = randn(B, Hkv, G, hd, dtype=bf16)
    part = {"return_partials": True}
    # phase 3's chunk: H=32, Hkv=8, hd=128, P=1536, C=512
    C, P = 512, 1536
    cq = randn(C, 32, hd, dtype=bf16)
    kc, vc = randn(C, Hkv, hd, dtype=bf16), randn(C, Hkv, hd, dtype=bf16)
    table = tables[0, :P // bs].contiguous()
    # phase 7's dense decode: zamba2 (B=8, Hkv=32, G=1, hd=64, 2080 rows)
    # and, for the int8 entry, glm4-9b's (B=8, Hkv=2, G=16, hd=128, 2048)
    dq = randn(8, 32, 1, 64, dtype=bf16)
    dk, dv = randn(8, 32, 2080, 64, dtype=bf16), randn(8, 32, 2080, 64,
                                                       dtype=bf16)
    dl = torch.full((8,), 2080, dtype=torch.int32, device=dev)
    gq = randn(8, 2, 16, 128, dtype=bf16)
    (gk, gks), (gv, gvs) = (quantize_pool(torch, randn(8, 2, 2048, 128))
                            for _ in range(2))
    gl = torch.full((8,), 2048, dtype=torch.int32, device=dev)
    # phase 7's scans: B=8, S=2048, H=64, P=64 (N=64)
    Bs, S, H, Pp, N = 8, 2048, 64, 64, 64
    x, dy = randn(Bs, S, H, Pp), randn(Bs, S, H, Pp)
    Bi, Ci = randn(Bs, S, N), randn(Bs, S, N)
    decay = torch.rand((Bs, S, H), generator=gen, device=dev)
    r, k, v = (randn(Bs, S, H, Pp) for _ in range(3))
    w = torch.rand((Bs, S, H, Pp), generator=gen, device=dev)
    u = randn(H, Pp)
    rkvw_bf = [a.to(bf16) for a in (r, k, v, w)]
    return [
        ("paged_decode_attention_bf16", pda.paged_decode_attention,
         [q, kp, vp, tables, lens], part),
        ("paged_decode_attention_int8", pda.paged_decode_attention_int8,
         [q, kq, vq, ks, vs, tables, lens], part),
        ("paged_prefill_chunk_attention_bf16",
         ppa.paged_prefill_chunk_attention, [cq, kp, vp, table, kc, vc], {}),
        ("paged_prefill_chunk_attention_int8",
         ppa.paged_prefill_chunk_attention_int8,
         [cq, kq, vq, ks, vs, table, kc, vc], {}),
        ("decode_attention_bf16", da.decode_attention, [dq, dk, dv, dl],
         part),
        ("decode_attention_int8", da.decode_attention_int8,
         [gq, gk, gv, gks, gvs, gl], part),
        ("ssm_scan_f32", ssm.ssm_scan, [x, Bi, Ci, decay], {}),
        ("ssm_scan_bwd_f32", ssm.ssm_scan_bwd, [x, Bi, Ci, decay, dy], {}),
        ("rwkv6_scan_bf16", rwkv.rwkv6_scan, rkvw_bf + [u], {}),
        ("rwkv6_scan_f32", rwkv.rwkv6_scan, [r, k, v, w, u], {}),
        ("rwkv6_scan_bwd_bf16", rwkv.rwkv6_scan_bwd, rkvw_bf + [u, dy], {}),
        ("rwkv6_scan_bwd_f32", rwkv.rwkv6_scan_bwd, [r, k, v, w, u, dy], {}),
    ]


def dry_faces(torch, np, counters):
    """(a) each entry's real launch, then its face on fake copies of the
    same operands: equal shapes, dtypes and strides, equal reported cost;
    the face launches nothing and leaves no fake tensor among the
    tickets. Returns {entry: the check}."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _cuda
    from repro_torch.launch.hlo_analysis import LocalCounter
    out = {}
    for name, fn, args, kw in face_cases(torch, np, torch.device(DEV)):
        with LocalCounter(args) as real_count:
            real = fn(*args, **kw)
        sync(torch)
        real = real if isinstance(real, tuple) else (real,)
        before = counters.read()
        with FakeTensorMode() as mode:
            fargs = [mode.from_tensor(a) for a in args]
            with LocalCounter(fargs) as fake_count:
                fake = fn(*fargs, **kw)
        fake = fake if isinstance(fake, tuple) else (fake,)
        meta = lambda t: (list(t.shape), str(t.dtype), list(t.stride()))  # noqa
        same = [meta(f) == meta(r) for f, r in zip(fake, real)]
        rec = dict(outputs=[meta(r) for r in real], metadata_equal=same,
                   flops=fake_count.kernel_flops,
                   bytes=fake_count.kernel_bytes,
                   cost_equal=(fake_count.kernel_flops,
                               fake_count.kernel_bytes,
                               fake_count.kernel_calls) ==
                   (real_count.kernel_flops, real_count.kernel_bytes,
                    real_count.kernel_calls),
                   face_launched=counters.read() != before)
        out[name] = rec
        gate(len(fake) == len(real) and all(same),
             f"phase 23 (a): {name}'s face metadata {[meta(f) for f in fake]}"
             f" != the kernel's {rec['outputs']}")
        gate(rec["cost_equal"], f"phase 23 (a): {name}'s face reports "
             f"another cost than its launch")
        gate(not rec["face_launched"], f"phase 23 (a): {name}'s face "
             f"launched a kernel")
        del real, fake, fargs
    gate(not any(_cuda.is_fake(t) for t in _cuda._TICKETS.values()),
         "phase 23 (a): a fake tensor among the stream tickets")
    release(torch)
    return out


def dry_train(torch, registry, transformer, counters, train):
    """(b, c) tinyllama-1.1b's phase 21 (a) step (full width and depth,
    B=8 x 512, remat, AdamW) traced on a (1, 1) mesh. Its per-chip bytes
    against phase 21 (a)'s measured peak, which also holds what the phase
    keeps beside its steps (what earlier phases left allocated and its
    copy of the initial weights: ``train``'s ``held_before_gib`` and
    ``initial_weights_gib``), and against the peak of one real step on
    the card above the memory held before its inputs were made; that
    step counted by the same mode: FLOPs equal to the trace's."""
    from repro_torch.core import disagg
    from repro_torch.data.synthetic import packed_batches
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import LocalCounter
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import tree_map
    cfg = registry.get_config("tinyllama-1.1b")
    adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, adamw)
    meta = transformer.init_params(0, cfg, device="meta")
    state = opt.init_opt_state(meta)
    batch = next(packed_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0,
                                device=DEV))
    mbatch = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"), batch)
    t0 = time.perf_counter()
    before = counters.read()
    with dryrun.fake_world(1):
        mesh = make_test_mesh((1, 1), device_type=DEV)
        pspecs = disagg.specs_for_params(cfg, meta, mesh)
        tr = dryrun.trace(step, (meta, state, mbatch), mesh,
                          (pspecs, opt.OptState(disagg.P(), pspecs, pspecs),
                           disagg.specs_for_batch(cfg, mbatch, mesh)))
    trace_s = time.perf_counter() - t0
    gate(counters.read() == before, "phase 23 (b): the train step's trace "
         "launched a kernel")
    proof = (tr["argument_bytes"] + tr["temp_bytes"]) / 2**30
    beside = train["held_before_gib"] + train["initial_weights_gib"]
    peak21 = train["peak_gib"]
    out = dict(trace_s=trace_s, argument_gib=tr["argument_bytes"] / 2**30,
               temp_gib=tr["temp_bytes"] / 2**30, per_chip_total_gib=proof,
               phase21_peak_gib=peak21, phase21_held_beside_gib=beside,
               rel_err_phase21=(proof + beside - peak21) / peak21,
               rel_err_phase21_unaccounted=(proof - peak21) / peak21,
               traced_flops=tr["flops"], traced_bytes=tr["bytes"],
               traced_ops=tr["ops"])
    gate(abs(out["rel_err_phase21"]) <= DRY_MEM_TOL,
         f"phase 23 (b): the train step's proof {proof:.3f} GiB + "
         f"{beside:.3f} GiB held beside phase 21 (a)'s steps is "
         f"{out['rel_err_phase21']:+.1%} off its measured {peak21:.3f} GiB")
    # (c) one real step, counted by the same mode; (b) its own peak
    release(torch)
    base = torch.cuda.memory_allocated()
    params = transformer.init_params(0, cfg, device=DEV)
    st = opt.init_opt_state(params)
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    with LocalCounter((params, st, batch)) as real:
        new = step(params, st, batch)
        sync(torch)
    step_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del new, params, st
    release(torch)
    out.update(step_peak_gib=step_peak,
               rel_err_step=(proof - step_peak) / step_peak)
    gate(abs(out["rel_err_step"]) <= DRY_MEM_TOL,
         f"phase 23 (b): the train step's proof {proof:.3f} GiB is "
         f"{out['rel_err_step']:+.1%} off one real step's {step_peak:.3f} "
         f"GiB")
    n_mult = param_count_no_embed(cfg, meta)
    T = TRAIN_B * TRAIN_S
    out.update(real_flops=real.total_flops,
               flops_equal=real.total_flops == tr["flops"],
               real_bytes=real.total_bytes, model_flops_6nt=6 * n_mult * T,
               model_flops_8nt_remat=8 * n_mult * T)
    gate(out["flops_equal"], f"phase 23 (c): the train step's traced FLOPs "
         f"{tr['flops']:.6g} != its real count {real.total_flops:.6g}")
    return out


def trace_1x1(torch, arch, shape, overrides):
    """``build_lowering_spec(arch, shape)`` traced on a (1, 1) mesh: (the
    spec, whose function is what the card then runs, the dry run's trace
    of it, the seconds both took)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.entrypoints import build_lowering_spec
    from repro_torch.launch.mesh import make_test_mesh
    t0 = time.perf_counter()
    with dryrun.fake_world(1):
        mesh = make_test_mesh((1, 1), device_type=DEV)
        spec = build_lowering_spec(arch, shape, mesh, overrides=overrides)
        tr = dryrun.trace(spec.fn, spec.args, mesh, spec.in_shardings,
                          spec.out_shardings)
    return spec, tr, time.perf_counter() - t0


def dry_decode(torch, registry, transformer, counters):
    """(b, c) the reference test's decode_32k config (tinyllama-1.1b at 2
    layers, a 2048-token vocab, B=128, a 32768-row bf16 cache) traced on a
    (1, 1) mesh, against one real ``decode_step``'s peak above the memory
    held before its weights were made; the real step counted by the same
    mode: FLOPs equal to the trace's."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.launch.hlo_analysis import LocalCounter
    shp = INPUT_SHAPES["decode_32k"]
    before = counters.read()
    spec, tr, _ = trace_1x1(torch, "tinyllama-1.1b", "decode_32k",
                            DRY_DECODE)
    gate(counters.read() == before, "phase 23 (b): the decode step's trace "
         "launched a kernel")
    proof = (tr["argument_bytes"] + tr["temp_bytes"]) / 2**30
    cfg = spec.cfg
    release(torch)
    base = torch.cuda.memory_allocated()
    params = transformer.init_params(0, cfg, device=DEV)
    cache = transformer.init_cache(cfg, shp.global_batch, shp.seq_len,
                                   device=DEV)
    cache["len"].fill_(shp.seq_len - 1)
    tokens = torch.zeros((shp.global_batch,), dtype=torch.int32, device=DEV)
    sync(torch)
    torch.cuda.reset_peak_memory_stats()
    with LocalCounter((params, tokens, cache)) as real:
        logits, updates = transformer.decode_step(params, cfg, tokens, cache,
                                                  device=DEV)
        sync(torch)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    finite = bool(torch.isfinite(logits.float()).all())
    kv = (cache["k"].numel() + cache["v"].numel()) * 2 / 1e9
    del logits, updates, params, cache
    release(torch)
    out = dict(kv_gb=kv, argument_gib=tr["argument_bytes"] / 2**30,
               temp_gib=tr["temp_bytes"] / 2**30, per_chip_total_gib=proof,
               measured_peak_gib=peak, rel_err=(proof - peak) / peak,
               traced_flops=tr["flops"], real_flops=real.total_flops,
               flops_equal=real.total_flops == tr["flops"],
               traced_bytes=tr["bytes"], real_bytes=real.total_bytes,
               kernel_calls=tr["kernel_calls"], finite=finite)
    gate(finite, "phase 23 (b): decode_32k logits not finite")
    gate(abs(out["rel_err"]) <= DRY_MEM_TOL,
         f"phase 23 (b): decode_32k's proof {proof:.3f} GiB is "
         f"{out['rel_err']:+.1%} off the measured {peak:.3f} GiB")
    gate(out["flops_equal"], f"phase 23 (c): decode_32k's traced FLOPs "
         f"{tr['flops']:.6g} != its real count {real.total_flops:.6g}")
    return out


def dry_records(registry):
    """(arch, shape, flags) of phase 23's sweep, the longest first."""
    recs = [(a, s, "") for a in DENSE_FAMILY
            for s in registry.applicable_shapes(a)]
    recs.sort(key=lambda r: ("train", "prefill").index(r[1].split("_")[0])
              if r[1].split("_")[0] in ("train", "prefill") else 2)
    recs.append(("llama3-8b", "decode_32k", "--multi-pod"))
    recs += [(a, DRY_OTHER_SHAPE, "") for a in registry.ASSIGNED
             if a not in DENSE_FAMILY]
    return recs


def start_dry_sweep(registry, out_dir):
    """(d) the production sweep, started in the background: each record of
    ``dry_records`` in a ``python -m repro_torch.launch.dryrun`` process of
    its own, ``DRY_SWEEP_JOBS`` at a time (``dryrun.sweep``), on the (16,
    16) mesh (the multi-pod record on (2, 16, 16)). Returns the process;
    ``finish_dry_sweep`` waits for it."""
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = [["--arch", a, "--shape", s, "--device", "cuda", "--out-dir",
             out_dir] + ([f] if f else []) for a, s, f in
            dry_records(registry)]
    cmd = ("import sys; from repro_torch.launch.dryrun import sweep; "
           f"sys.exit(sweep({runs!r}, {DRY_SWEEP_JOBS}))")
    log_f = open(os.path.join(out_dir, "sweep.log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", cmd], stdout=log_f,
                            stderr=subprocess.STDOUT, env=env,
                            start_new_session=True,
                            preexec_fn=lambda: os.nice(19))
    proc.t0 = time.perf_counter()
    proc.log_f = log_f
    # a run that fails before phase 23 ends the sweep's processes too
    atexit.register(lambda: proc.poll() is None and os.killpg(proc.pid, 9))
    return proc


def finish_dry_sweep(proc, out_dir):
    """Wait for the sweep (no longer than ``DRY_SWEEP_TIMEOUT_S`` from its
    start; the whole process group is ended then), read its records, gate
    them and print roofline.py's tables."""
    from repro_torch.configs import registry
    from repro_torch.launch import roofline
    left = DRY_SWEEP_TIMEOUT_S - (time.perf_counter() - proc.t0)
    try:
        proc.wait(timeout=max(left, 1))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.wait()
        log(f"phase 23 (d): the sweep did not end in "
            f"{DRY_SWEEP_TIMEOUT_S} s; its records so far are read")
    proc.log_f.close()
    wall = time.perf_counter() - proc.t0
    recs = roofline.load(out_dir)
    rows = {}
    for r in recs:
        mem = r.get("memory", {})
        rows[f"{r['arch']}:{r['shape']}:{r['chips']}"] = dict(
            ok=r["ok"], per_chip_gib=mem.get("per_chip_total", 0) / 2**30,
            fits_h100_80g=mem.get("fits_h100_80g"),
            dominant=r.get("roofline", {}).get("dominant"),
            seconds=r["total_s"], cost_method=r.get("cost_method"),
            launched=sum(r["launches"].values()))
    for key, row in rows.items():
        log(f"dry run {key}: {json.dumps(row)}")
    with open(os.path.join(out_dir, "sweep.log")) as f:
        failed = [line.split()[1:3] for line in f if line.startswith("FAIL")]
    want = [(a, s) for a, s, f in dry_records(registry) if not f]
    got = {(r["arch"], r["shape"]) for r in recs if not r["multi_pod"]}
    for arch, shape in want:
        ok = (arch, shape) in got and all(
            r["ok"] for r in recs if (r["arch"], r["shape"]) ==
            (arch, shape))
        if arch in DENSE_FAMILY:
            gate(ok, f"phase 23 (d): {arch} {shape} not traced ok on the "
                 f"(16, 16) mesh")
    gate(any(r["multi_pod"] and r["ok"] for r in recs),
         "phase 23 (d): llama3-8b decode_32k not traced on (2, 16, 16)")
    gate(not any(sum(r["launches"].values()) for r in recs),
         "phase 23 (d): a dry-run record launched a kernel")
    for line in (roofline.dryrun_table(recs) + [""] +
                 roofline.roofline_table(recs) + [""] +
                 roofline.worst_candidates(recs)):
        log(line)
    return dict(records=len(recs), wanted=len(want) + 1,
                missing=sorted(f"{a}:{s}" for a, s in set(want) - got),
                failed=failed, wall_s=wall, rows=rows)


def dryrun_e2e(torch, np, registry, transformer, counters, train, sweep,
               sweep_dir):
    """Phase 23: (a) the faces against the kernels, (b) the memory proof
    against measured peaks, (c) traced FLOPs against a real step's count,
    (d) the production sweep (started after phase 18, records of their
    own processes, each gated on its launch counters). Every launch
    counter of this process holds across its traces."""
    t0 = time.perf_counter()
    out = {"faces": dry_faces(torch, np, counters)}
    log(f"dry run faces vs kernels: {json.dumps(out['faces'])}")
    out["train_step"] = dry_train(torch, registry, transformer, counters,
                                  train)
    log(f"dry run tinyllama train step: {json.dumps(out['train_step'])}")
    out["decode_32k"] = dry_decode(torch, registry, transformer, counters)
    log(f"dry run decode_32k: {json.dumps(out['decode_32k'])}")
    out["sweep"] = finish_dry_sweep(sweep, sweep_dir)
    out["wall_s_phase"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 24: the long_500k configuration (one 524,288-token sequence)
# ---------------------------------------------------------------------------
LONG_S = 524_288              # configs/base.py long_500k: B = 1
LONG_STEPS = 8                # serve steps from a cache at LONG_S - 8
LONG_BS = 16
# (b): registry id and the overrides of the run on the card; the config is
# config_for_shape(arch, "long_500k") (llama3-8b-sw8k, glm4-9b-sinks)
LONG_ARCHS = (("zamba2-1.2b", None), ("glm4-9b", None),
              ("llama3-8b", {"kv_cache_bits": 8}), ("rwkv6-7b", None))
# rwkv6-7b's one-shot prefill at B = 1: the longest power of two the card
# holds beside its weights. At 262,144 the time mix's five mixed inputs
# (B, 5, S, d) asked for 10 GiB more with 48.35 GiB allocated and 22.69
# GiB reserved but unallocated (an H100 80GB, 79.18 GiB); at 524,288
# those inputs, the fused projection and the closed-form final state's
# fp32 suffix products alone exceed the card
LONG_PREFILL_S = 262_144
# (c): one request through Lamina's int8 pool, head x 2
LONG_PROMPT = 524_256
LONG_NEW = 32
LONG_CHUNK = 512
LONG_POOL_BLOCKS = LONG_S // LONG_BS + 8


def long_kernel_cases(torch, pda, ppa, da, rwkv, timer):
    """(a) rows 1, 3, 2, 4, 5, 5-int8 and 7 at 524,288 tokens against their
    plain twins on the card, NaN values or scales in every slot outside the
    live range, timed unheld and held beside their bounds (and SDPA on
    pre-gathered K/V where the table has it)."""
    nb = LONG_S // LONG_BS
    out = {}

    def put(name, r):
        out[name] = r
        log(f"phase 24 (a) {name}: {json.dumps(r)}")
        torch.cuda.empty_cache()

    paged = dict(B=1, Hkv=8, G=4, hd=128, bs=LONG_BS)
    put("row 1 llama3-8b full context", decode_case(
        torch, pda, timer, lens=[LONG_S], seed=240, **paged))
    put("row 3 llama3-8b full context", decode_case(
        torch, pda, timer, lens=[LONG_S], seed=241, int8=True, **paged))
    put("row 3 llama3-8b-sw8k window 8192", decode_case(
        torch, pda, timer, lens=[LONG_S], seed=242, int8=True,
        sliding_window=8191, **paged))
    put("row 3 glm4-9b-sinks G=16 window 8192 sinks 4", decode_case(
        torch, pda, timer, B=1, Hkv=2, G=16, hd=128, bs=LONG_BS,
        lens=[LONG_S], seed=243, int8=True, sliding_window=8191, sinks=4))
    P = LONG_S - LONG_CHUNK
    for int8 in (True, False):
        put(f"row {4 if int8 else 2} llama3-8b-sw8k C=512 P={P} window 8192",
            prefill_case(torch, ppa, timer, H=32, Hkv=8, hd=128, bs=LONG_BS,
                         P=P, C=LONG_CHUNK, seed=244, int8=int8,
                         sliding_window=8192, plain_iters=1))
    put("row 5 zamba2 shared attention Hkv=32 G=1 hd=64", dense_decode_case(
        torch, da, timer, B=1, Hkv=32, G=1, hd=64, lens=[LONG_S - 8],
        S=LONG_S, seed=245))
    put("row 5 glm4-9b-sinks Hkv=2 G=16 window 8192 sinks 4",
        dense_decode_case(torch, da, timer, B=1, Hkv=2, G=16, hd=128,
                          lens=[LONG_S - 8], S=LONG_S, seed=246,
                          sliding_window=8191, sinks=4))
    put("row 5-int8 llama3-8b-sw8k Hkv=8 G=4 window 8192", dense_decode_case(
        torch, da, timer, B=1, Hkv=8, G=4, hd=128, lens=[LONG_S - 8],
        S=LONG_S, seed=247, int8=True, sliding_window=8191))
    # the chunked twin in tiles of 64 steps (a quarter of the 16-step
    # tiles' Python loop: 8192 tiles, ~10 s on the card)
    put("row 7 rwkv6-7b B=1 S=524288 H=64 P=64 (2^31 elements)", rwkv_case(
        torch, rwkv, timer, B=1, S=LONG_S, H=64, P=64, seed=248,
        twin=functools.partial(rwkv.rwkv6_scan_chunked_plain, chunk=64),
        plain_iters=0))
    out["paged_plan"] = {
        f"Hkv={h} G={g}": pda.launch_geometry(1, h, nb, _sm_count(torch), g)
        for h, g in ((8, 4), (4, 4), (2, 16))}
    return out


def _sm_count(torch):
    from repro_torch.kernels import _cuda
    return _cuda.sm_count(torch.device(DEV))


def fill_long_cache(torch, cache, seed, length):
    """A decode cache filled from ``seed`` on the card at ``length`` tokens:
    normal K/V (int8 values in [-127, 127] with scales in [0.005, 0.03))
    and recurrent states, written a leading slice at a time so nothing
    the size of the cache is ever allocated beside it; every K/V slot at or
    past ``length`` holds NaN (NaN scales in an int8 cache)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    for key, t in cache.items():
        if key == "len":
            t.fill_(length)
            continue
        for part in t:
            if key.endswith("_scale"):
                part.uniform_(0.005, 0.03, generator=gen)
            elif t.dtype == torch.int8:
                part.random_(-127, 128, generator=gen)
            else:
                part.normal_(generator=gen)
        if key in ("k", "v") and t.is_floating_point():
            t[:, :, :, length:] = float("nan")
        elif key.endswith("_scale"):
            t[..., length:] = float("nan")


def long_attention_layers(cfg):
    """Attention invocations a decode step makes (row 5 launches)."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_period
    return 0 if cfg.family == "ssm" else cfg.num_layers


def long_row5_bound(cfg, length, int8):
    """Row 5's byte bound for one step at ``length`` stored tokens: the rows
    each attention invocation's masks keep (window and sinks, as the
    kernel takes them: the serving window less the incoming token), K + V
    (int8 rows hd + 4 bytes with their scale) over the memory rate."""
    w, sinks = cfg.sliding_window, cfg.attention_sinks
    rows = length
    if w:
        kw = w - 1
        rows = min(length, kw) + max(0, min(sinks, length - kw))
    hd = cfg.resolved_head_dim
    row_bytes = (hd + 4) * 2 if int8 else hd * 2 * 2
    nbytes = long_attention_layers(cfg) * rows * cfg.num_kv_heads * row_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3, rows


def long_cache_bytes(cfg, int8):
    """The formula for the dense cache's K/V (and scales) at LONG_S."""
    n = long_attention_layers(cfg)
    hd = cfg.resolved_head_dim
    per = (hd + 4) if int8 else 2 * hd
    return 2 * n * cfg.num_kv_heads * LONG_S * per


def long_trace(torch, arch, overrides):
    """The long_500k record of ``arch`` on a (1, 1) mesh: (the spec, its
    per-chip bytes: arguments + the peak of the temporaries)."""
    spec, tr, secs = trace_1x1(torch, arch, "long_500k", overrides)
    proof = (tr["argument_bytes"] + tr["temp_bytes"]) / 2**30
    return spec, dict(per_chip_gib=proof,
                      argument_gib=tr["argument_bytes"] / 2**30,
                      temp_gib=tr["temp_bytes"] / 2**30,
                      kernel_calls=tr["kernel_calls"], trace_s=secs)


def ulp_err(torch, got, want):
    """The largest |got - want| over the elements, in bf16 ulps of
    ``want`` (the spacing of bf16 values at each element of it)."""
    want = want.float()
    exp = torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126)))
    return float(((got.float() - want).abs() / torch.exp2(exp - 7)).max())


def twin_steps(torch, da, serve_step, params, tok, cache, step):
    """The same step with row 5's plain twin, (1) each of its calls also
    launching the kernel on the call's own operands, held within the
    kernel tolerance of the twin (o 2 bf16 ulps; l rtol 1e-3; m atol
    1e-3), its o's largest ulp error and cosine to the twin's recorded,
    and (2) with the twin's o moved by at most one bf16 ulp (a seeded
    third of its elements up, a third down): the cosine of (1) and (2)'s
    logits is the step's rounding floor, how far one ulp of row 5 moves
    this random-weight model's logits at full depth. Returns (the twin
    step's logits, that cosine, the largest move of a logit from (1) to
    (2), the calls outside tolerance, each call's (ulps, cosine))."""
    orig, plain_fn = da.decode_attention, da.decode_attention_plain
    bad, calls = [], []

    def held(q, k, v, clen, **kw):
        want = plain_fn(q, k, v, clen, **kw)
        got = orig(q, k, v, clen, **kw)
        calls.append((ulp_err(torch, got[0], want[0]),
                      cosine(got[0], want[0])))
        try:
            check_close("row 5 o", got[0], want[0])
            check_close("row 5 l", got[1], want[1], rtol=1e-3, atol=1e-6)
            check_close("row 5 m", got[2], want[2], rtol=0.0, atol=1e-3)
        except AssertionError as e:
            bad.append((step, len(calls) - 1, str(e)[:120]))
        return want

    def moved(q, k, v, clen, **kw):
        o, l, m = plain_fn(q, k, v, clen, **kw)
        gen = torch.Generator(device=q.device).manual_seed(step)
        bump = torch.randint(-1, 2, o.shape, generator=gen, device=q.device)
        return (o.float() * (1 + bump * 2.0 ** -8)).to(o.dtype), l, m

    held.launches = moved.launches = 0  # the bf16 entry counts on its name
    try:
        da.decode_attention = held
        plain, _ = serve_step(params, tok, cache)
        da.decode_attention = moved
        ulp, _ = serve_step(params, tok, cache)
    finally:
        da.decode_attention = orig
    move = float((ulp[0].float() - plain[0].float()).abs().max())
    return plain, cosine(plain[0], ulp[0]), move, bad, calls


def long_decode(torch, np, transformer, counters, arch, overrides):
    """(b) and (d) for one arch: the dry run's (1, 1) record, then its
    ``serve_step`` on the card at full width and depth from a cache filled
    at LONG_S - LONG_STEPS: LONG_STEPS steps + ``apply_decode_updates``,
    each against the same step with row 5's plain twin (``twin_steps``:
    every row 5 call held on its own operands, within the kernel tolerance
    and at a cosine >= MIN_COSINE; the logits' cosine within
    max(1 - MIN_COSINE, the twin's own one-ulp distance); the same argmax,
    or one whose logit in the twin's lies within max(NEAR_TIE_ULPS, twice
    the largest move one ulp of row 5 gives a logit) of the top: what
    logits each moved that far can swap), row 5's launches counted each
    step, a
    profiled window of 3 steps at the full cache, peak memory and cache
    bytes against the formula. Returns (the record, the launches the
    steps counted)."""
    from repro_torch.kernels import decode_attention as da
    before = counters.read()
    spec, dry = long_trace(torch, arch, overrides)
    gate(counters.read() == before, f"phase 24 (d) {arch}: the trace "
         f"launched a kernel")
    cfg, serve_step = spec.cfg, spec.fn
    int8 = cfg.kv_cache_bits == 8 and cfg.family == "dense"
    n_attn = long_attention_layers(cfg)
    row5 = "decode_attention_int8" if int8 else "decode_attention"
    want = {k: 0 for k in counters.fns}
    if n_attn:
        want[row5] = n_attn
    release(torch)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = transformer.init_params(0, cfg, device=DEV)
    cache = transformer.init_cache(cfg, 1, LONG_S, device=DEV)
    fill_long_cache(torch, cache, 24, LONG_S - LONG_STEPS)
    sync(torch)
    setup_s = time.perf_counter() - t0
    kv_bytes = tree_bytes({k: v for k, v in cache.items()
                           if k in ("k", "v", "k_scale", "v_scale")})
    gate(kv_bytes == long_cache_bytes(cfg, int8), f"phase 24 (b) {arch}: "
         f"cache K/V bytes {kv_bytes} != {long_cache_bytes(cfg, int8)}")
    tok = torch.tensor([7], dtype=torch.int32, device=DEV)
    step_ms, cos, ties, launch_bad, finite = [], [], [], [], True
    floors, moves, layer_bad, call_ulps, call_cos = [], [], [], [], []
    counted = {}
    step_peak = None
    torch.cuda.reset_peak_memory_stats()
    for step in range(LONG_STEPS):
        sync(torch)
        counters.reset()
        t1 = time.perf_counter()
        logits, upd = serve_step(params, tok, cache)
        sync(torch)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if step_peak is None:
            step_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        got = counters.read()
        for k, n in got.items():
            counted[k] = counted.get(k, 0) + n
        if got != want:
            launch_bad.append((step, {k: n for k, n in got.items() if n}))
        finite &= bool(torch.isfinite(logits.float()).all())
        if n_attn:
            plain, floor, move, bad, calls = twin_steps(
                torch, da, serve_step, params, tok, cache, step)
            layer_bad += bad
            call_ulps.append(max(u for u, _ in calls))
            call_cos.append(min(c for _, c in calls))
            cos.append(cosine(logits[0], plain[0]))
            floors.append(floor)
            moves.append(move)
            t = int(logits[0].argmax())
            if t != int(plain[0].argmax()):
                top = float(plain[0].float().max())
                ties.append((step, gap_ulps(plain[0], t),
                             max(NEAR_TIE_ULPS, 2 * move / bf16_ulp(top))))
            del plain
        cache = transformer.apply_decode_updates(cache, upd)
        tok = logits.argmax(-1).int()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    gate(int(cache["len"][0]) == LONG_S, f"phase 24 (b) {arch}: cache len "
         f"{cache['len'].tolist()} != {LONG_S}")
    gate(not launch_bad, f"phase 24 (b) {arch}: steps whose launches != "
         f"{ {k: n for k, n in want.items() if n} }: {launch_bad[:4]}")
    gate(finite, f"phase 24 (b) {arch}: logits not finite")
    if n_attn:
        gate(not layer_bad, f"phase 24 (b) {arch}: row 5 on a step's own "
             f"operands outside the kernel tolerance of its twin: "
             f"{layer_bad[:4]}")
        gate(min(call_cos) >= MIN_COSINE, f"phase 24 (b) {arch}: a row 5 "
             f"call's o at cosine {min(call_cos)} to its twin's on the same "
             f"operands")
        far = [(i, c, f) for i, (c, f) in enumerate(zip(cos, floors))
               if 1 - c > max(1 - MIN_COSINE, 1 - f)]
        gate(not far, f"phase 24 (b) {arch}: step logits vs the plain "
             f"twin's farther than max(1 - {MIN_COSINE}, the twin's own "
             f"one-ulp distance): (step, cosine, floor) {far[:4]}")
        gate(all(g <= lim for _, g, lim in ties), f"phase 24 (b) {arch}: "
             f"argmax left the plain twin's farther than one ulp of row 5 "
             f"can swap: (step, gap ulps, limit ulps) {ties[:4]}")

    def step():   # at the full cache, len = LONG_S: no write past it
        serve_step(params, tok, cache)

    prof = profile_window(torch, step, 3, 1, kernels=(
        "dense_tc_kernel", "dense_lanes_kernel"))
    row5_ms = prof["dense_tc_kernel_ms"] + prof["dense_lanes_kernel_ms"]
    bound_ms, rows = long_row5_bound(cfg, LONG_S, int8)
    dry_err = (dry["per_chip_gib"] - step_peak) / step_peak
    gate(abs(dry_err) <= DRY_MEM_TOL, f"phase 24 (d) {arch}: the (1, 1) "
         f"record {dry['per_chip_gib']:.3f} GiB is {dry_err:+.1%} off one "
         f"real step's {step_peak:.3f} GiB")
    res = dict(config=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               kv_heads=cfg.num_kv_heads, window=cfg.sliding_window,
               sinks=cfg.attention_sinks, kv_cache_bits=cfg.kv_cache_bits,
               parameters=n_params(params), setup_s=setup_s,
               cache_kv_bytes=kv_bytes, cache_bytes=tree_bytes(cache),
               step_ms_p50=sorted(step_ms)[len(step_ms) // 2],
               step_ms=[round(t, 2) for t in step_ms],
               cosine_vs_plain=[round(c, 6) for c in cos],
               twin_one_ulp_cosine=[round(c, 6) for c in floors],
               twin_one_ulp_max_logit_move=moves,
               steps_at_cosine_0_999=sum(c >= MIN_COSINE for c in cos),
               row5_call_max_ulps=call_ulps,
               row5_call_min_cosine=[round(c, 8) for c in call_cos],
               row5_launches_per_step=n_attn,
               min_cosine_vs_plain=min(cos) if cos else None,
               argmax_ties=ties, step_peak_gib=step_peak, peak_gib=peak,
               profile=prof, row5_ms_per_step=row5_ms,
               row5_bound_ms_per_step=bound_ms, row5_rows_kept=rows,
               row5_share_of_busy=row5_ms / prof["device_busy_ms"]
               if n_attn else None,
               dry_run_1x1=dict(dry, rel_err_vs_step_peak=dry_err))
    log(f"phase 24 (b) {arch} long_500k serve_step: {json.dumps(res)}")
    del logits, upd, cache
    if cfg.family == "ssm":
        res["prefill"] = long_rwkv_prefill(torch, np, transformer, cfg,
                                           params, counters)
        for k, n in res["prefill"]["launches"].items():
            counted[k] = counted.get(k, 0) + n
    del params
    release(torch)
    return res, {k: n for k, n in counted.items() if n}


def long_rwkv_prefill(torch, np, transformer, cfg, params, counters):
    """rwkv6-7b's one-shot prefill of one seeded prompt of LONG_PREFILL_S
    tokens at B = 1: wall, peak, row 7 launches (one a layer), finite
    logits."""
    tokens = np.random.default_rng(24).integers(
        0, cfg.vocab_size, size=(1, LONG_PREFILL_S)).tolist()
    release(torch)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    sync(torch)
    t0 = time.perf_counter()
    logits, cache = transformer.prefill(params, cfg, {"tokens": tokens},
                                        max_seq=LONG_PREFILL_S, device=DEV)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in counters.read().items() if n}
    finite = bool(torch.isfinite(logits.float()).all())
    out = dict(tokens=LONG_PREFILL_S, wall_s=wall,
               tok_s=LONG_PREFILL_S / wall, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               peak_above_weights_gib=(torch.cuda.max_memory_allocated() -
                                       base) / 2**30, finite=finite,
               state_bytes=tree_bytes({k: v for k, v in cache.items()
                                       if k != "len"}))
    gate(launches == {"rwkv6_scan": cfg.num_layers}, f"phase 24 (b) rwkv6 "
         f"prefill launches {launches}")
    gate(finite, "phase 24 (b) rwkv6 prefill logits not finite")
    log(f"phase 24 (b) rwkv6-7b prefill at B=1: {json.dumps(out)}")
    del logits, cache
    return out


def timed_chunks(torch, comp):
    """Time every call of the engine's chunk program (synchronized around
    it) and split it: a new key's eager warm-up and its capture, an eager
    call on a full cache, or a replay. Returns the tally the wrapper
    fills."""
    tally = dict(eager_s=0.0, capture_s=0.0, replay_s=0.0, warm_ups=0,
                 eager_calls=0, replays=0)
    run = comp.chunk.run

    def wrapped(key, operands, program, tickets=0, capture=True):
        new = key not in comp.chunk._graphs
        cap0 = comp.chunk.capture_s
        sync(torch)
        t0 = time.perf_counter()
        result = run(key, operands, program, tickets, capture)
        sync(torch)
        dt = time.perf_counter() - t0
        if new:
            cap = comp.chunk.capture_s - cap0
            tally["capture_s"] += cap
            tally["eager_s"] += dt - cap
            tally["warm_ups" if cap else "eager_calls"] += 1
        else:
            tally["replay_s"] += dt
            tally["replays"] += 1
        return result

    comp.chunk.run = wrapped
    return tally


def long_request(torch, np, registry, transformer, counters):
    """(c) one request of LONG_PROMPT seeded tokens through LLMEngine on
    Lamina's path (attention_pool, head partition, 2 workers, an int8
    paged pool of LONG_POOL_BLOCKS blocks of 16): chunk-prefilled by 512,
    LONG_NEW greedy tokens. At the last step one layer's decode attention
    over the real pool and the last chunk's attention against their plain
    twins; launches, the TransferLog, resident bytes."""
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.serving import EngineConfig, LLMEngine, State

    cfg = registry.config_for_shape("llama3-8b", "long_500k")
    L, hd, Hkv = cfg.num_layers, cfg.resolved_head_dim, cfg.num_kv_heads
    params = transformer.init_params(0, cfg, device=DEV)
    econf = EngineConfig(placement="attention_pool", partition="head",
                         attention_workers=2, kv_dtype="int8",
                         block_size=LONG_BS, num_blocks=LONG_POOL_BLOCKS,
                         max_batch=1, prefill_chunk_tokens=LONG_CHUNK)
    warm = LLMEngine(cfg, params, econf.replace(num_blocks=64), device=DEV)
    warm.submit(make_requests([list(range(1, 41))], 2))
    warm.run()
    del warm
    release(torch)
    prompt = np.random.default_rng(25).integers(
        0, cfg.vocab_size, size=LONG_PROMPT).tolist()
    eng = LLMEngine(cfg, params, econf, device=DEV)
    resident = eng.stats.kv_pool_bytes_resident
    want_resident = 2 * L * Hkv * LONG_POOL_BLOCKS * LONG_BS * (hd + 4)
    gate(resident == want_resident, f"phase 24 (c): pool resident bytes "
         f"{resident} != 2·L·Hkv·blocks·bs·(hd+4) = {want_resident}")
    tally = timed_chunks(torch, eng.compiled_prefill) \
        if eng.compiled_prefill is not None else None
    req, = make_requests([prompt], LONG_NEW)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    sync(torch)
    t0 = time.perf_counter()
    eng.submit([req])
    while len(req.output) < LONG_NEW - 1:
        eng.step()
    sync(torch)
    wall = time.perf_counter() - t0
    launches = counters.read()
    st = eng.stats
    # the twins at the last step: the last layer's decode attention over the
    # whole pool (both workers' heads) and a chunk at the prompt's end
    tables, lens = eng.kv.block_table_batch([req.rid])
    gen = torch.Generator(device=DEV).manual_seed(26)
    layer = L - 1
    tbl = torch.as_tensor(tables, device=DEV)
    clen = torch.as_tensor(lens, device=DEV)
    pools = (eng.kv.k_pool[layer], eng.kv.v_pool[layer])
    scales = dict(k_scale=eng.kv.k_scale[layer], v_scale=eng.kv.v_scale[layer])
    q = torch.randn((1, Hkv, cfg.gqa_group, hd), generator=gen,
                    device=DEV).bfloat16()
    kw = dict(sliding_window=cfg.sliding_window - 1, return_partials=True,
              **scales)
    o, l_, m = pda.paged_decode_attention(q, *pools, tbl, clen, **kw)
    po, pl, pm = pda.paged_decode_attention_plain(q, *pools, tbl, clen, **kw)
    dec = dict(cache_len=int(lens[0]), max_abs_err=check_close(
        "524K decode o", o, po))
    check_close("524K decode l", l_, pl, rtol=1e-3, atol=1e-6)
    check_close("524K decode m", m, pm, rtol=0.0, atol=1e-3)
    # the prompt's last chunk: 480 tokens after 32,736 blocks
    P = (LONG_PROMPT - 1) // LONG_CHUNK * LONG_CHUNK
    C = LONG_PROMPT - P
    table = eng.kv.gather_prefix_indices(req.rid, P)
    qc = torch.randn((C, cfg.num_heads, hd), generator=gen,
                     device=DEV).bfloat16()
    kc = torch.randn((C, Hkv, hd), generator=gen, device=DEV).bfloat16()
    vc = torch.randn_like(kc)
    ckw = dict(sliding_window=cfg.sliding_window, **scales)
    got = ppa.paged_prefill_chunk_attention(qc, *pools, table, kc, vc, **ckw)
    ref = ppa.paged_prefill_chunk_attention_plain(qc, *pools, table, kc, vc,
                                                  **ckw)
    chunk = dict(P=P, C=C, max_abs_err=check_close("524K chunk", got, ref))
    del o, po, got, ref
    counters.reset()
    prof = profile_window(torch, eng.step, 1, 1)       # the last step
    last = counters.read()
    gate(req.state == State.FINISHED and len(req.output) == LONG_NEW,
         f"phase 24 (c): the request did not finish: {len(req.output)}")
    want_l = paged_want(L, st.steps - 1, st.prefill_chunks_run, workers=2,
                        int8=True)
    gate(launches == want_l, f"phase 24 (c): launches {launches} != "
         f"{want_l}")
    gate(last == paged_want(L, 1, 0, workers=2, int8=True),
         f"phase 24 (c): the last step's launches {last}")
    gate(st.prefill_chunks_run == -(-LONG_PROMPT // LONG_CHUNK),
         f"phase 24 (c): {st.prefill_chunks_run} chunks")
    tlog = transfer_log_check(cfg, eng, [prompt], "int8")
    gate(tlog["ok"], f"phase 24 (c): TransferLog {tlog} != the §3.1 "
         f"formulas")
    comp = eng.compiled_prefill
    if comp is not None:
        from repro_torch.serving.compiled import MAX_GRAPHS
        ch = comp.chunk
        gate(ch.captures == ch.graphs == min(MAX_GRAPHS, st.prefill_chunks_run)
             and ch.eager_calls == st.prefill_chunks_run - ch.captures,
             f"phase 24 (c): chunk program {compiled_stats(ch)} for "
             f"{st.prefill_chunks_run} chunks (want its last {MAX_GRAPHS} "
             f"keys captured, the earlier ones eager)")
    out = dict(config=cfg.name, prompt=LONG_PROMPT, new_tokens=LONG_NEW,
               pool_blocks=LONG_POOL_BLOCKS, pool_bytes_resident=resident,
               chunks=st.prefill_chunks_run, decode_steps=st.steps,
               ttft_s=st.request_ttfts[0] if st.request_ttfts else None,
               ttft_split=tally,
               chunk_graphs=compiled_stats(comp.chunk) if comp else None,
               decode_graphs=compiled_stats(eng.compiled)
               if eng.compiled else None,
               tbt_p50_s=st.tbt_percentiles()["p50"],
               last_step_profile=prof, wall_s_31_tokens=wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={k: n for k, n in launches.items() if n},
               transfer_log=tlog, decode_vs_twin=dec, chunk_vs_twin=chunk,
               per_worker_kv_bytes=eng.pool.per_worker_kv_bytes)
    log(f"phase 24 (c) 524K request, attention_pool head x2 int8: "
        f"{json.dumps(out)}")
    del eng, req, params
    release(torch)
    return out, {k: launches[k] + last[k] for k in launches
                 if launches[k] + last[k]}


def long_e2e(torch, np, registry, transformer, counters, pda, ppa, da,
             rwkv):
    """Phase 24: the long_500k configuration on the card. Returns (summary,
    the launches of (b) and (c) per kernel)."""
    t0 = time.perf_counter()
    log(f"phase 24 on {card_line()}")
    out = {"kernels": long_kernel_cases(torch, pda, ppa, da, rwkv,
                                        Timer(torch))}
    release(torch)
    log(f"phase 24 (a) done in {time.perf_counter() - t0:.1f} s")
    launches = {}

    def add(got):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n

    for arch, overrides in LONG_ARCHS:
        t1 = time.perf_counter()
        res, got = long_decode(torch, np, transformer, counters, arch,
                               overrides)
        res["wall_s"] = time.perf_counter() - t1
        out[arch] = res
        add(got)
        log(f"phase 24 (b) {arch} done in {res['wall_s']:.1f} s")
    # (d) the bf16 record of llama3-8b-sw8k beside the card's memory
    _, bf16 = long_trace(torch, "llama3-8b", None)
    bf16["card_total_gib"] = torch.cuda.get_device_properties(
        0).total_memory / 2**30
    out["llama3-8b-sw8k_bf16_record"] = bf16
    log(f"phase 24 (d) llama3-8b-sw8k bf16 record (1, 1): "
        f"{json.dumps(bf16)}")
    t1 = time.perf_counter()
    out["request"], req_launches = long_request(torch, np, registry,
                                                transformer, counters)
    out["request"]["wall_s_phase"] = time.perf_counter() - t1
    add(req_launches)
    out["wall_s_phase"] = time.perf_counter() - t0
    out["card"] = card_line()
    return out, {k: n for k, n in launches.items() if n}


def phase24_main() -> int:
    """``chip_smoke.py --phase24``: phase 1's build of the libraries phase
    24 launches, then phase 24 alone (no result line)."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import rwkv6_scan as rwkv
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.models import transformer
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _cuda.build([pda._LIB_NAME, ppa._LIB_NAME, da._LIB_NAME, rwkv._LIB_NAME])
    counters = Launches(pda, ppa, da, ssm, rwkv)
    out, launches = long_e2e(torch, np, registry, transformer, counters, pda,
                             ppa, da, rwkv)
    log(json.dumps({"phase24": out, "launches": launches}))
    if FAILED:
        raise AssertionError(f"{len(FAILED)} gate(s) failed: {FAILED}")
    return 0


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.configs import registry
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import rwkv6_scan as rwkv
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.models import transformer

    t_start = time.perf_counter()
    # phase 1: device + build
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _cuda.build([pda._LIB_NAME, ppa._LIB_NAME, da._LIB_NAME,
                         ssm._LIB_NAME, rwkv._LIB_NAME])
    log(f"kernels built in {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    per_instance = {pda._LIB_NAME: ROW1_MARKERS,
                    da._LIB_NAME: DENSE_MARKERS,
                    ssm._LIB_NAME: [("ssm_scan_kernelI", ("N", "W"))],
                    rwkv._LIB_NAME: [("rwkv6_scan_kernelI", ("P", "W"))]}
    for name, text in _cuda.BUILD_LOG.items():
        if name in per_instance:       # one line per instantiation
            for marker, names in per_instance[name]:
                for row in ptxas_summary(text, marker, names):
                    log(f"  ptxas {name} {marker[:-1]}: {row}")
            continue
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"paged chunk prefill, tensor-core design: {prefill_design(ppa)}")
    log(f"chunked scans, tensor-core design: {scan_design(ssm, rwkv)}")
    counters = Launches(pda, ppa, da, ssm, rwkv)

    timer = Timer(torch)
    rng = np.random.default_rng(0)
    log(f"tolerance, kernel vs plain twin: |err| <= {ERR_ATOL} + {ERR_RTOL}"
        f" * |plain| elementwise on o (2 bf16 ulp); l rtol 1e-3; m atol "
        f"1e-3; int8 vs the bf16 twin on the unquantized pool: cosine >= "
        f"{MIN_COSINE}")

    # phase 2: decode kernels vs plain twin, bf16 then int8 at the same
    # shapes and seeds
    lens = rng.integers(1, 2049, size=8).tolist()
    lens[0] = 2048
    glens = rng.integers(1, 8193, size=4).tolist()
    glens[0] = 8192
    # Lamina's long-context regime: ~1 GB bf16 pools
    long_lens = np.random.default_rng(5).integers(16384, 32769,
                                                  size=8).tolist()
    long_lens[0] = 32768
    lens16k = np.random.default_rng(6).integers(8192, 16385, size=8).tolist()
    lens16k[0] = 16384
    dec, wide = {}, {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        dec[tag] = decode_case(torch, pda, timer, B=8, Hkv=8, G=4, hd=128,
                               bs=16, lens=lens, seed=1, int8=int8)
        log(f"decode {tag} llama3-8b B=8 lens={lens}: "
            f"{json.dumps(dec[tag])}")
        # one head-partition worker's launch: Hkv/2 kv heads, same lengths
        r = decode_case(torch, pda, timer, B=8, Hkv=4, G=4, hd=128, bs=16,
                        lens=lens, seed=4, int8=int8)
        log(f"decode {tag} head-partition launch Hkv=4: {json.dumps(r)}")
        r = decode_case(torch, pda, timer, B=8, Hkv=8, G=4, hd=128, bs=16,
                        lens=long_lens, seed=5, int8=int8)
        log(f"decode {tag} long context lens={long_lens}: {json.dumps(r)}")
        torch.cuda.empty_cache()
        r = decode_case(torch, pda, timer, B=8, Hkv=8, G=4, hd=128, bs=16,
                        lens=lens, seed=2, int8=int8, pos_pad=True,
                        library=False)
        log(f"decode {tag} POS_PAD slots: {json.dumps(r)}")
        r = decode_case(torch, pda, timer, B=4, Hkv=16, G=2, hd=128, bs=16,
                        lens=glens, seed=3, int8=int8, sliding_window=4095,
                        sinks=4, softcap=50.0)
        log(f"decode {tag} gemma2-shaped window=4095 sinks=4 softcap=50 "
            f"lens={glens}: {json.dumps(r)}")
        # the widened shapes: glm4-9b's G = 16 (main context and
        # 16K), G = 16 at hd = 64 (16 lanes a row, one query head each),
        # kimi-k2's hd = 112, and G = 16 at hd = 112 with window + sinks
        for name, kw in (
                ("glm4-9b B=8 Hkv=2 G=16 hd=128", dict(
                    B=8, Hkv=2, G=16, hd=128, lens=lens)),
                ("glm4-9b 16K B=8 Hkv=2 G=16 hd=128", dict(
                    B=8, Hkv=2, G=16, hd=128, lens=lens16k)),
                ("G=16 hd=64 B=8 Hkv=2", dict(B=8, Hkv=2, G=16, hd=64,
                                              lens=lens)),
                ("kimi-k2 B=8 Hkv=8 G=8 hd=112", dict(
                    B=8, Hkv=8, G=8, hd=112, lens=lens)),
                ("qwen3-moe B=8 Hkv=4 G=8 hd=128", dict(
                    B=8, Hkv=4, G=8, hd=128, lens=lens)),
                ("G=4 hd=112 B=8 Hkv=8", dict(B=8, Hkv=8, G=4, hd=112,
                                              lens=lens, library=False)),
                ("G=16 hd=112 window=8191 sinks=4 softcap=30", dict(
                    B=8, Hkv=2, G=16, hd=112, lens=lens16k,
                    sliding_window=8191, sinks=4, softcap=30.0)),
                ("glm4-9b POS_PAD slots", dict(
                    B=8, Hkv=2, G=16, hd=128, lens=lens, pos_pad=True,
                    library=False))):
            r = decode_case(torch, pda, timer, bs=16, seed=6, int8=int8,
                            **kw)
            wide[("decode", tag, name)] = r
            log(f"decode {tag} {name}: {json.dumps(r)}")
        torch.cuda.empty_cache()

    # phase 3: chunk-prefill kernels vs plain twin
    pre = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        for P, C in ((0, 512), (1536, 512), (1024, 300)):
            pre[(tag, P, C)] = prefill_case(torch, ppa, timer, H=32, Hkv=8,
                                            hd=128, bs=16, P=P, C=C,
                                            seed=10 + P + C, int8=int8)
            log(f"prefill {tag} llama3-8b P={P} C={C}: "
                f"{json.dumps(pre[(tag, P, C)])}")
        r = prefill_case(torch, ppa, timer, H=32, Hkv=16, hd=128, bs=16,
                         P=4096, C=512, seed=20, int8=int8,
                         sliding_window=4096, sinks=4, softcap=50.0)
        log(f"prefill {tag} gemma2-shaped P=4096 C=512 window=4096 sinks=4 "
            f"softcap=50: {json.dumps(r)}")
        # the widened shapes: glm4-9b's G = 16 at full width; kimi-k2's
        # hd = 112 (the tiles run at 128), also over one- and two-row TMA
        # boxes
        for name, kw in (
                ("glm4-9b H=32 Hkv=2 hd=128 P=1536 C=512", dict(
                    H=32, Hkv=2, hd=128, bs=16, P=1536, C=512)),
                ("kimi-k2 H=64 Hkv=8 hd=112 P=1536 C=512", dict(
                    H=64, Hkv=8, hd=112, bs=16, P=1536, C=512)),
                ("hd=112 G=16 bs=2 P=256 C=300", dict(
                    H=32, Hkv=2, hd=112, bs=2, P=256, C=300)),
                ("hd=112 G=8 bs=1 P=40 C=70", dict(
                    H=64, Hkv=8, hd=112, bs=1, P=40, C=70)),
                ("hd=112 G=16 P=9216 C=512 window=8192 sinks=4 softcap=30",
                 dict(H=32, Hkv=2, hd=112, bs=16, P=9216, C=512,
                      sliding_window=8192, sinks=4, softcap=30.0))):
            r = prefill_case(torch, ppa, timer, seed=21, int8=int8, **kw)
            wide[("prefill", tag, name)] = r
            log(f"prefill {tag} {name}: {json.dumps(r)}")

    # phase 7 (run with the other kernel phases): the dense-cache decode
    # kernel and the two scans vs their plain twins
    log(f"tolerance, scans vs plain twin: |err| <= {SCAN_RTOL} * max|plain|"
        f" + {SCAN_RTOL} * |plain| elementwise (fp32 both)")
    zlens = rng.integers(2048, 2081, size=8).tolist()
    zlens[0] = 2080
    new = {}
    new["decode_attention"] = dense_decode_case(
        torch, da, timer, B=8, Hkv=32, G=1, hd=64, lens=zlens, S=2080,
        seed=30)
    log(f"dense decode zamba2-shaped B=8 Hkv=32 G=1 hd=64 lens={zlens}: "
        f"{json.dumps(new['decode_attention'])}")
    r = dense_decode_case(torch, da, timer, B=8, Hkv=8, G=4, hd=128,
                          lens=lens, S=2048, seed=31)
    log(f"dense decode llama3-8b-shaped B=8 Hkv=8 G=4 hd=128 lens={lens}: "
        f"{json.dumps(r)}")
    r = dense_decode_case(torch, da, timer, B=4, Hkv=16, G=2, hd=128,
                          lens=glens, S=8192, seed=32, sliding_window=4095,
                          sinks=4, softcap=50.0)
    log(f"dense decode gemma2-shaped window=4095 sinks=4 softcap=50 "
        f"lens={glens}: {json.dumps(r)}")
    # the widened shapes, and the int8 entry (the dense-cache path
    # of phase 14 runs glm4-9b's shape; llama3-8b's the 16-byte int8 rows)
    for tag in ("bf16", "int8"):
        for name, kw in (
                ("glm4-9b B=8 Hkv=2 G=16 hd=128", dict(
                    B=8, Hkv=2, G=16, hd=128, lens=lens, S=2048)),
                ("glm4-9b 16K B=8 Hkv=2 G=16 hd=128", dict(
                    B=8, Hkv=2, G=16, hd=128, lens=lens16k, S=16384)),
                ("G=16 hd=64 B=8 Hkv=2", dict(B=8, Hkv=2, G=16, hd=64,
                                              lens=lens, S=2048)),
                ("kimi-k2 B=8 Hkv=8 G=8 hd=112", dict(
                    B=8, Hkv=8, G=8, hd=112, lens=lens, S=2048)),
                ("llama3-8b B=8 Hkv=8 G=4 hd=128", dict(
                    B=8, Hkv=8, G=4, hd=128, lens=lens, S=2048)),
                ("G=2 hd=112 window=1000 sinks=4 softcap=30", dict(
                    B=8, Hkv=8, G=2, hd=112, lens=lens, S=2048,
                    sliding_window=1000, sinks=4, softcap=30.0))):
            if tag == "bf16" and name.startswith("llama3-8b"):
                continue                      # measured above
            r = dense_decode_case(torch, da, timer, seed=39,
                                  int8=tag == "int8", **kw)
            wide[("dense", tag, name)] = r
            log(f"dense decode {tag} {name}: {json.dumps(r)}")
    new["decode_attention_int8"] = wide[("dense", "int8",
                                         "glm4-9b B=8 Hkv=2 G=16 hd=128")]
    log(f"dense decode, split-KV design: "
        f"{json.dumps(dense_design(torch, da, _cuda))}")
    sweep = instantiation_sweep(torch, pda, da, ppa, timer)
    log(f"every instantiation vs its plain twin: {json.dumps(sweep)}")
    torch.cuda.empty_cache()
    new["ssm_scan"] = ssm_case(torch, ssm, timer, B=8, S=2048, H=64, P=64,
                               N=64, seed=33)
    log(f"ssm_scan zamba2 prefill B=8 S=2048 H=64 P=64 N=64: "
        f"{json.dumps(new['ssm_scan'])}")
    r = ssm_case(torch, ssm, timer, B=8, S=2048, H=64, P=64, N=64, seed=35,
                 edges=True, timed=False)
    log(f"ssm_scan zamba2 prefill, decays with exact 0 and 1.0: "
        f"{json.dumps(r)}")
    r = ssm_case(torch, ssm, timer, B=8, S=2047, H=64, P=64, N=64, seed=36,
                 timed=False)
    log(f"ssm_scan zamba2 prefill, ragged S=2047: {json.dumps(r)}")
    new["rwkv6_scan"] = rwkv_case(torch, rwkv, timer, B=8, S=2048, H=64,
                                  P=64, seed=34)
    log(f"rwkv6_scan rwkv6 prefill B=8 S=2048 H=64 P=64 bf16: "
        f"{json.dumps(new['rwkv6_scan'])}")
    r = rwkv_case(torch, rwkv, timer, B=8, S=2048, H=64, P=64, seed=37,
                  decays="model", timed=False)
    log(f"rwkv6_scan rwkv6 prefill, the model's decays with exact 0 and "
        f"1.0: {json.dumps(r)}")
    r = rwkv_case(torch, rwkv, timer, B=8, S=2047, H=64, P=64, seed=38,
                  timed=False)
    log(f"rwkv6_scan rwkv6 prefill, ragged S=2047: {json.dumps(r)}")
    del timer
    torch.cuda.empty_cache()
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    # phases 4-6: end to end at full width and depth
    cfg = registry.get_config("llama3-8b")
    t0 = time.perf_counter()
    params = transformer.init_params(0, cfg, device=DEV)
    sync(torch)
    log(f"e2e: llama3-8b L={cfg.num_layers} d={cfg.d_model} "
        f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"init {time.perf_counter() - t0:.1f} s")
    prng = np.random.default_rng(0)        # the requests of every e2e run
    plens = prng.integers(300, 2001, size=8)
    prompts = [prng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in plens]
    log(f"e2e: prompt lengths {plens.tolist()} "
        f"({sum(int(n) % 16 != 0 for n in plens)} not multiples of 16)")
    l_bf16, e2e, cold_tokens = homogeneous_e2e(torch, np, cfg, params,
                                               prompts, counters)
    torch.cuda.empty_cache()
    l_int8, lam = lamina_e2e(torch, np, cfg, params, prompts, counters,
                             e2e["kv_pool_bytes_resident"])
    torch.cuda.empty_cache()
    parts = {d: partitions_e2e(torch, np, cfg, params, prompts[:2], counters,
                               d) for d in ("int8", "bf16")}
    torch.cuda.empty_cache()
    faults = fault_e2e(torch, np, cfg, params, prompts, counters)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cluster = cluster_e2e(torch, np, cfg, params, prompts, counters,
                          cold_tokens)
    log(f"llama3-8b end-to-end phases done at "
        f"{time.perf_counter() - t_start:.1f} s (cluster phase "
        f"{time.perf_counter() - t0:.1f} s)")
    del params
    torch.cuda.empty_cache()
    # phase 12: the serve CLI, in process, with weights of its own
    t0 = time.perf_counter()
    cluster["serve_cli"] = serve_cli(torch, [
        "--arch", "llama3-8b", "--mode", "router", "--replicas", "2",
        "--engine", "lamina", "--kv-dtype", "int8", "--prefix-sharing",
        "--prefill-chunk-tokens", "512", "--num-blocks", "1024",
        "--trace", "azure-conv", "--requests", "8", "--scale", "0.5"])
    log(f"serve CLI done in {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps(cluster['serve_cli'])}")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 8: zamba2-1.2b and rwkv6-7b at full width and depth
    zcfg = registry.get_config("zamba2-1.2b")
    n_super = zcfg.num_layers // zcfg.shared_attn_period
    l_zamba, zamba = recurrent_e2e(
        torch, np, transformer, zcfg, counters, lambda n: {
            **NO_PAGED_KERNEL, "ssm_scan": zcfg.num_layers,
            "decode_attention": n_super * n, "rwkv6_scan": 0})
    torch.cuda.empty_cache()
    rcfg = registry.get_config("rwkv6-7b")
    l_rwkv, rwkv6 = recurrent_e2e(
        torch, np, transformer, rcfg, counters, lambda n: {
            **NO_PAGED_KERNEL, "ssm_scan": 0, "decode_attention": 0,
            "rwkv6_scan": rcfg.num_layers})
    torch.cuda.empty_cache()

    # phase 9: the card against the CPU, full width, reduced depth
    versus = {
        "zamba2-1.2b": card_vs_cpu(torch, np, transformer, zcfg.replace(
            num_layers=4, shared_attn_period=2), counters),
        "rwkv6-7b": card_vs_cpu(torch, np, transformer,
                                rcfg.replace(num_layers=2), counters)}
    log(f"end-to-end phases done at {time.perf_counter() - t_start:.1f} s")

    # phase 13: glm4-9b at full width and depth (and its sinks variant)
    t0 = time.perf_counter()
    gcfg, gparams, glm4 = glm4_e2e(torch, np, registry, transformer,
                                   counters)
    log(f"glm4-9b phase done in {time.perf_counter() - t0:.1f} s")
    # phase 14: the dense-cache path at glm4-9b's width
    t0 = time.perf_counter()
    dense, n_int8_dense = dense_cache_e2e(torch, np, transformer, gcfg,
                                          gparams, counters)
    dense["timed_step"] = dense_step_timing(torch, np, transformer, gcfg,
                                            gparams, counters)
    del gparams
    release(torch)
    log(f"dense-cache phase done in {time.perf_counter() - t0:.1f} s")
    # phase 15: llama3-70b, pixtral-12b, tinyllama-1.1b at full width
    t0 = time.perf_counter()
    others = other_dense_e2e(torch, np, registry, transformer, counters)
    log(f"other dense archs done in {time.perf_counter() - t0:.1f} s")
    # phase 16: speculative decoding
    spec = speculative_e2e(torch, np, registry, transformer)
    log(f"phases 13-16 done at {time.perf_counter() - t_start:.1f} s")
    # phase 17: the moe family (qwen3-moe at full depth, kimi-k2 at 1 layer)
    t0 = time.perf_counter()
    moe = moe_e2e(torch, np, registry, transformer, counters)
    log(f"moe phase done in {time.perf_counter() - t0:.1f} s")
    # phase 18: gemma2-27b at full width and depth
    t0 = time.perf_counter()
    gemma2 = gemma2_e2e(torch, np, registry, transformer, counters)
    log(f"gemma2-27b phase done in {time.perf_counter() - t0:.1f} s; "
        f"phases 17-18 done at {time.perf_counter() - t_start:.1f} s")
    # phase 23 (d)'s production sweep: shape-only traces in processes of
    # their own at the lowest priority (each holds a CUDA context, ~0.5
    # GiB), started after the phases that need most of the card's memory
    # and read in phase 23
    sweep_dir = str(ROOT / "build" / "dryrun")
    sweep = start_dry_sweep(registry, sweep_dir)
    # phase 19: seamless-m4t-medium at full width and depth
    audio = audio_e2e(torch, np, registry, transformer, counters)
    log(f"seamless phase done in {audio['wall_s_phase']:.1f} s")
    # phase 20: the converter, the rotational pipeline, the cost model
    analytic = analytic_e2e(torch, np, registry, counters, e2e["profile"],
                            float(np.mean(plens)))
    log(f"analytic phase done in {analytic['wall_s_phase']:.1f} s; phases "
        f"19-20 done at {time.perf_counter() - t_start:.1f} s")
    # phase 21: training (tinyllama-1.1b; zamba2 and rwkv6 through the
    # scans' backward kernels)
    training, bwd_rows, bwd_launches = train_e2e(
        torch, np, registry, transformer, counters, ssm, rwkv, Timer(torch))
    log(f"training phase done in {training['wall_s_phase']:.1f} s; phase 21 "
        f"done at {time.perf_counter() - t_start:.1f} s")
    # phase 22: the collective attention backends on 4 ranks sharing the
    # card, and the placed train step on a (1, 1) mesh
    collective, coll_launches = phase22(torch, np, registry, transformer)
    log(f"collective phase done in {collective['wall_s_phase']:.1f} s; "
        f"phase 22 done at {time.perf_counter() - t_start:.1f} s")
    # phase 23: the dry run on fake CUDA tensors
    dry = dryrun_e2e(torch, np, registry, transformer, counters,
                     training["tinyllama"], sweep, sweep_dir)
    log(f"dry-run phase done in {dry['wall_s_phase']:.1f} s; phase 23 "
        f"done at {time.perf_counter() - t_start:.1f} s")
    # phase 24: the long_500k configuration (524,288 tokens at B = 1)
    long, long_launches = long_e2e(torch, np, registry, transformer,
                                   counters, pda, ppa, da, rwkv)
    log(f"long_500k phase done in {long['wall_s_phase']:.1f} s; phase 24 "
        f"done at {time.perf_counter() - t_start:.1f} s")

    stats = {"paged_decode_attention": dec["bf16"],
             "paged_prefill_chunk_attention": pre[("bf16", 1536, 512)],
             "paged_decode_attention_int8": dec["int8"],
             "paged_prefill_chunk_attention_int8": pre[("int8", 1536, 512)],
             **new, "ssm_scan_bwd": bwd_rows["ssm_scan_bwd"],
             "rwkv6_scan_bwd": bwd_rows["rwkv6_scan_bwd"]}
    launches = {**{k: l_bf16[k] for k in ("paged_decode_attention",
                                          "paged_prefill_chunk_attention")},
                **{k: l_int8[k] for k in ("paged_decode_attention_int8",
                                          "paged_prefill_chunk_attention_int8")},
                "decode_attention": l_zamba["decode_attention"],
                "decode_attention_int8": n_int8_dense,
                "ssm_scan": l_zamba["ssm_scan"],
                "rwkv6_scan": l_rwkv["rwkv6_scan"], **bwd_launches}
    for name, n in launches.items():
        if not n:
            raise AssertionError(f"{name} was not launched on its path")
    kernels = [dict(name=name, route="cuda", status="ported", source=src,
                    replaces=rep, launches=launches[name],
                    **{k: stats[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                    **({"launches_phase22": coll_launches[name]}
                       if name in coll_launches else {}),
                    **({"launches_phase24": long_launches[name]}
                       if name in long_launches else {}))
               for name, (src, rep) in KERNELS.items()]
    log(json.dumps({"summary": {"homogeneous_bf16": e2e, "lamina_int8": lam,
                                "partitions": parts, "faults": faults,
                                "cluster": cluster,
                                "zamba2": zamba, "rwkv6": rwkv6,
                                "card_vs_cpu": versus, "glm4_9b": glm4,
                                "dense_cache": dense, "other_dense": others,
                                "speculative": spec, "moe": moe,
                                "gemma2_27b": gemma2,
                                "seamless_m4t_medium": audio,
                                "analytic": analytic,
                                "training": training,
                                "collective": collective,
                                "dryrun": dry,
                                "long_500k": long,
                                "widened_kernel_cases": {
                                    " / ".join(k): v
                                    for k, v in wide.items()}}}))
    if FAILED:
        raise AssertionError(f"{len(FAILED)} gate(s) failed: {FAILED}")
    log(json.dumps({"kernels": kernels, "todo": []}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if len(sys.argv) == 3 and sys.argv[1] == "--dense-step":
            sys.exit(dense_step_main(sys.argv[2]))
        if len(sys.argv) == 2 and sys.argv[1] == "--phase22":
            sys.exit(phase22_main())
        if len(sys.argv) == 2 and sys.argv[1] == "--phase23":
            sys.exit(phase23_main())
        if len(sys.argv) == 2 and sys.argv[1] == "--phase24":
            sys.exit(phase24_main())
        if len(sys.argv) == 2 and sys.argv[1] == "--row1":
            sys.exit(row1_main())
        sys.exit(main())
    except Exception:                       # report, no result line
        traceback.print_exc()
        sys.exit(1)
