"""EngineStats — the one serving-metrics surface.
Port (a copy) of ``repro/serving/stats.py``; the fault, handoff and int8
counters stay 0 until their slices are ported.

Every engine generation has shared this dataclass; it now lives in its own
module (the legacy ``serving/engine.py`` that used to host it is gone).
``LLMEngine`` populates the core counters; the disaggregated-cluster
engines (``serving/cluster/``) add the handoff/transfer surface:

  * ``kv_bytes_transferred`` — physical KV bytes landed on a decode
    replica's pool through block-granular handoff imports;
  * ``handoff_latencies`` — seconds from a handoff payload arriving at a
    decode replica (PreallocQueue) to its last block written (TransferQueue
    drained); :meth:`handoff_percentiles` is the p50/p90/p99 view;
  * ``router_affinity_hits`` — requests the :class:`ClusterRouter` routed
    to this replica because its prefix was already resident there (the
    prefix-affinity win ``bench_disagg_cluster`` measures).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    tokens_generated: int = 0
    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    step_times: List[float] = dataclasses.field(default_factory=list)
    # per-request latency samples (seconds) — populated by observe_request
    # on retirement; the percentile surface bench_serving reports
    request_ttfts: List[float] = dataclasses.field(default_factory=list)
    request_tbts: List[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    # prefix sharing (LLMEngine with EngineConfig.prefix_sharing):
    # physical blocks mapped onto a donor's at admission, and prompt tokens
    # whose prefill COMPUTE was skipped (MoE shares memory but recomputes,
    # so its blocks_shared can grow while prefill_tokens_skipped stays 0)
    blocks_shared: int = 0
    prefill_tokens_skipped: int = 0
    # chunked paged prefill (LLMEngine with EngineConfig.prefill_chunk_
    # tokens): chunk model calls run, and the largest dense KV slab one
    # prefill call materialised before scattering it into the pool (tokens)
    # — bounded by the chunk size when chunking is on, by the longest
    # prompt when off (the admission-capping transient the tentpole kills)
    prefill_chunks_run: int = 0
    max_prefill_slab_tokens: int = 0
    # fault tolerance (LLMEngine with a FaultInjector / shard health
    # machine, serving/faults.py): shard lifecycle counts, retry volume,
    # and per-request recovery latency samples (seconds from the shard
    # being declared dead to the victim request decodable again on the
    # surviving shards — detection + eviction + recompute re-admission)
    shard_failures: int = 0
    shard_rejoins: int = 0
    transient_faults_recovered: int = 0
    fault_retries: int = 0
    straggle_steps: int = 0
    requests_recovered: int = 0
    recovery_latencies: List[float] = dataclasses.field(default_factory=list)
    # disaggregated cluster (serving/cluster/): block-granular KV handoff
    # between a prefill engine and a decode replica, and the router's
    # prefix-affinity accounting. Decode replicas own the transfer view
    # (bytes landed, end-to-end handoff latency); handoff_retries counts
    # transfers reset by a mid-transfer shard death and restarted.
    kv_bytes_transferred: int = 0
    handoff_latencies: List[float] = dataclasses.field(default_factory=list)
    handoff_retries: int = 0
    router_affinity_hits: int = 0
    # quantized KV pool (EngineConfig.kv_dtype): resident bytes of the
    # whole pool allocation (value pools + int8 scale sidecars) and the
    # cumulative bytes the decode hot path streamed over live tokens —
    # int8 lands both at ≈ 0.5× their bf16 values for hd ≫ 4 (hd + 4
    # bytes per token-head vs 2·hd), the reduction bench_serving asserts
    kv_pool_bytes_resident: int = 0
    kv_bytes_read: int = 0

    @property
    def mean_batch(self) -> float:
        return float(np.mean(self.batch_sizes)) if self.batch_sizes else 0.0

    @property
    def throughput(self) -> float:
        t = sum(self.step_times)
        return self.tokens_generated / t if t > 0 else 0.0

    @property
    def mean_tbt(self) -> float:
        return float(np.mean(self.step_times)) if self.step_times else 0.0

    @property
    def handoffs_completed(self) -> int:
        """Handoff payloads fully landed on this replica's pool."""
        return len(self.handoff_latencies)

    @property
    def kv_bytes_read_per_step(self) -> float:
        """Mean KV bytes one decode iteration streams from the pool
        (live-token bytes over unique physical blocks, scales included)."""
        return self.kv_bytes_read / self.steps if self.steps else 0.0

    # ---------------- per-request latency surface ----------------
    def observe_request(self, req) -> None:
        """Fold one retired request's latencies in: TTFT (arrival to first
        token) and its mean time-between-tokens."""
        if req.first_token_s is not None:
            self.request_ttfts.append(req.first_token_s - req.arrival_s)
        if len(req.token_times) >= 2:
            self.request_tbts.append(req.tbt_s())

    @staticmethod
    def _pcts(samples: List[float]) -> Dict[str, float]:
        if not samples:
            return {"p50": 0.0, "p90": 0.0, "p99": 0.0}
        arr = np.asarray(samples, np.float64)
        return {p: float(np.percentile(arr, q))
                for p, q in (("p50", 50), ("p90", 90), ("p99", 99))}

    def ttft_percentiles(self) -> Dict[str, float]:
        """p50/p90/p99 time-to-first-token over retired requests (s)."""
        return self._pcts(self.request_ttfts)

    def tbt_percentiles(self) -> Dict[str, float]:
        """p50/p90/p99 of per-request mean time-between-tokens (s)."""
        return self._pcts(self.request_tbts)

    def recovery_percentiles(self) -> Dict[str, float]:
        """p50/p90/p99 request-recovery latency (s): shard declared dead →
        victim request decodable again on the surviving shards."""
        return self._pcts(self.recovery_latencies)

    def handoff_percentiles(self) -> Dict[str, float]:
        """p50/p90/p99 handoff latency (s): payload enqueued on the decode
        replica → last physical block written into its pool."""
        return self._pcts(self.handoff_latencies)

    def summary(self) -> Dict[str, float]:
        """Flat scalar summary (the dict bench_serving reports)."""
        out = {
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "requests": len(self.request_ttfts),
            "mean_batch": self.mean_batch,
            "throughput_tok_s": self.throughput,
            "mean_tbt_s": self.mean_tbt,
            "preemptions": self.preemptions,
            "blocks_shared": self.blocks_shared,
            "prefill_tokens_skipped": self.prefill_tokens_skipped,
            "prefill_chunks_run": self.prefill_chunks_run,
            "max_prefill_slab_tokens": self.max_prefill_slab_tokens,
            "shard_failures": self.shard_failures,
            "shard_rejoins": self.shard_rejoins,
            "transient_faults_recovered": self.transient_faults_recovered,
            "fault_retries": self.fault_retries,
            "straggle_steps": self.straggle_steps,
            "requests_recovered": self.requests_recovered,
            "kv_bytes_transferred": self.kv_bytes_transferred,
            "kv_pool_bytes_resident": self.kv_pool_bytes_resident,
            "kv_bytes_read_per_step": self.kv_bytes_read_per_step,
            "handoffs_completed": self.handoffs_completed,
            "handoff_retries": self.handoff_retries,
            "router_affinity_hits": self.router_affinity_hits,
        }
        for name, pcts in (("ttft", self.ttft_percentiles()),
                           ("tbt", self.tbt_percentiles()),
                           ("recovery", self.recovery_percentiles()),
                           ("handoff", self.handoff_percentiles())):
            for p, v in pcts.items():
                out[f"{name}_{p}_s"] = v
        return out
