"""DisaggCluster — the full disaggregated deployment in one object.
Port of ``repro/serving/cluster/cluster.py``, with a ``device`` argument
(default ``"cuda"``) passed to every engine. All 2·K engines share the
caller's ``params``: at full width llama3-8b's weights are about 15 GiB, so
no engine holds a copy.

K replicas (each a prefill engine paired with a decode engine, wired
prefill → decode through the handoff queues) fronted by a
:class:`~repro_torch.serving.cluster.router.ClusterRouter`. The paired topology
makes prefix affinity productive: the router concentrates same-prefix
streams on one replica, whose prefill engine's retained donors serve the
shared blocks from residency — ``prefill_tokens_skipped`` and warm TTFT
are the benchmark's observables.

This is the single-process simulation of the paper's heterogeneous
deployment (the same stance as the worker pools): every engine is real,
every handoff payload carries real pool bytes through host memory (the
wire), and the cluster ``step`` interleaves the engines the way
independent hosts would free-run.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from repro_torch.models.common import ModelConfig
from repro_torch.serving.config import DisaggConfig, EngineConfig
from repro_torch.serving.cluster.engines import DecodeEngine, PrefillEngine
from repro_torch.serving.cluster.registry import Replica, ReplicaRegistry
from repro_torch.serving.cluster.router import ClusterRouter
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.request import Request, SamplingParams, State
from repro_torch.serving.stats import EngineStats


class DisaggCluster:
    """K paired prefill/decode replicas behind a prefix-affinity router."""

    def __init__(self, cfg: ModelConfig, params,
                 engine_config: Optional[EngineConfig] = None,
                 replicas: int = 2,
                 disagg: Optional[DisaggConfig] = None,
                 routing: str = "affinity",
                 affinity_blocks: int = 2,
                 prefill_faults: Optional[Dict[int, FaultInjector]] = None,
                 decode_faults: Optional[Dict[int, FaultInjector]] = None,
                 seed: int = 0, device="cuda"):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1; got {replicas}")
        econf = engine_config or EngineConfig()
        self.cfg = cfg
        self.config = econf
        self.disagg = disagg or DisaggConfig()
        self.registry = ReplicaRegistry()
        for i in range(replicas):
            prefill = PrefillEngine(
                cfg, params, econf,
                disagg=self.disagg.replace(role="prefill"),
                fault_injector=(prefill_faults or {}).get(i), replica=i,
                device=device)
            decode = DecodeEngine(
                cfg, params, econf,
                disagg=self.disagg.replace(role="decode"),
                fault_injector=(decode_faults or {}).get(i), replica=i,
                device=device)
            prefill.on_handoff = decode.enqueue_handoff
            self.registry.add(Replica(idx=i, prefill=prefill,
                                      decode=decode))
        self.router = ClusterRouter(self.registry, econf.block_size,
                                    policy=routing,
                                    affinity_blocks=affinity_blocks,
                                    seed=seed)
        self.requests: List[Request] = []
        self._route_of: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def submit(self, reqs: Union[Request, Sequence[Request]]
               ) -> List[Request]:
        """Route and enqueue request(s); returns them as a list (outputs
        accumulate in place as the cluster runs)."""
        batch = [reqs] if isinstance(reqs, Request) else list(reqs)
        for req in batch:
            replica = self.router.route(req)
            self._route_of[req.rid] = replica.idx
            replica.prefill.submit(req)
            self.requests.append(req)
        return batch

    def generate(self, prompt: Sequence[int],
                 params: Optional[SamplingParams] = None) -> Request:
        return self.submit(Request(prompt=list(prompt),
                                   params=params or SamplingParams()))[0]

    def replica_of(self, rid: int) -> Optional[int]:
        return self._route_of.get(rid)

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One cluster tick: every engine with work advances one step —
        the single-process stand-in for independently free-running hosts
        (handoff callbacks deliver synchronously, so a payload exported
        this tick is in its decode replica's prealloc queue this tick)."""
        for r in self.registry:
            if r.prefill.has_work():
                r.prefill.step()
            if r.decode.has_work():
                r.decode.step()

    def has_work(self) -> bool:
        return any(r.has_work() for r in self.registry)

    def run(self, max_steps: int = 10_000) -> "DisaggCluster":
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self

    def drain(self, max_steps: int = 10_000) -> List[List[int]]:
        """Run to completion; returns outputs in submission order."""
        self.run(max_steps)
        return [list(r.output) for r in self.requests]

    @property
    def finished(self) -> bool:
        return all(r.state == State.FINISHED for r in self.requests)

    # ------------------------------------------------------------------
    def summary(self) -> Dict:
        """Cluster-level stats: decode-side transfer/handoff aggregates
        (counting each payload's bytes ONCE — the prefill side's export
        counter would double them), prefill-side affinity/sharing wins,
        and the per-replica breakdown."""
        agg = EngineStats()
        per_replica = []
        for r in self.registry:
            ps, ds = r.prefill.stats, r.decode.stats
            agg.kv_bytes_transferred += ds.kv_bytes_transferred
            agg.handoff_latencies.extend(ds.handoff_latencies)
            agg.handoff_retries += ds.handoff_retries
            agg.router_affinity_hits += ps.router_affinity_hits
            agg.prefill_tokens_skipped += ps.prefill_tokens_skipped
            agg.blocks_shared += ps.blocks_shared
            agg.tokens_generated += ds.tokens_generated
            per_replica.append({
                "replica": r.idx,
                "healthy": r.healthy,
                "router_affinity_hits": ps.router_affinity_hits,
                "prefill_tokens_skipped": ps.prefill_tokens_skipped,
                "kv_bytes_transferred": ds.kv_bytes_transferred,
                "handoffs_completed": ds.handoffs_completed,
                "handoff_retries": ds.handoff_retries,
            })
        out = {
            "replicas": len(self.registry),
            "routing": self.router.policy,
            "requests": len(self.requests),
            "kv_bytes_transferred": agg.kv_bytes_transferred,
            "handoffs_completed": agg.handoffs_completed,
            "handoff_retries": agg.handoff_retries,
            "router_affinity_hits": agg.router_affinity_hits,
            "prefill_tokens_skipped": agg.prefill_tokens_skipped,
            "blocks_shared": agg.blocks_shared,
            "tokens_generated": agg.tokens_generated,
            "per_replica": per_replica,
        }
        out.update({f"handoff_{k}_s": v
                    for k, v in agg.handoff_percentiles().items()})
        return out
