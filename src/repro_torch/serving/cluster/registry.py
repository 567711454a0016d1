"""Replica registry — the router's view of the decode fleet.
Port (a copy) of ``repro/serving/cluster/registry.py``.

A :class:`Replica` pairs one prefill engine with one decode engine (the
paired topology keeps prefix affinity meaningful: routing same-prefix
streams to the same replica concentrates them on ONE prefill engine's
retained donors). Health is drawn from the fault machinery
(``serving/faults.py``) — a replica whose prefill or decode pool has a
quarantined shard is DEGRADED and the router routes around it until the
shard rejoins.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.serving.cluster.engines import DecodeEngine, PrefillEngine


@dataclasses.dataclass
class Replica:
    """One prefill/decode engine pair behind the router."""

    idx: int
    prefill: PrefillEngine
    decode: DecodeEngine

    @property
    def healthy(self) -> bool:
        """Healthy = neither pool is running degraded. Quarantine state is
        the same signal the engines' own admission guards consult, so the
        router's view can never disagree with the replica's."""
        return not (self.prefill.kv.quarantined_shards
                    or self.decode.kv.quarantined_shards)

    @property
    def load(self) -> int:
        """Outstanding work units: queued + running requests on both
        engines plus decode-side handoffs still in flight."""
        return (len(self.prefill.sched.waiting)
                + len(self.prefill.sched.running)
                + len(self.decode.sched.waiting)
                + len(self.decode.sched.running)
                + len(self.decode.prealloc_q)
                + len(self.decode.transfer_q)
                + len(self.decode.waiting_q))

    def has_work(self) -> bool:
        return self.prefill.has_work() or self.decode.has_work()


class ReplicaRegistry:
    """Indexable fleet with health filtering."""

    def __init__(self, replicas: Optional[List[Replica]] = None):
        self._replicas: List[Replica] = list(replicas or [])

    def add(self, replica: Replica) -> None:
        self._replicas.append(replica)

    def __len__(self) -> int:
        return len(self._replicas)

    def __getitem__(self, idx: int) -> Replica:
        return self._replicas[idx]

    def __iter__(self):
        return iter(self._replicas)

    @property
    def healthy(self) -> List[Replica]:
        return [r for r in self._replicas if r.healthy]

    def least_loaded(self, healthy_only: bool = True) -> Replica:
        pool = self.healthy if healthy_only else self._replicas
        if not pool:
            pool = self._replicas     # whole fleet degraded: pick anyway
            # (an engine on a degraded pool still serves at reduced
            # capacity — refusing every request would be strictly worse)
        return min(pool, key=lambda r: (r.load, r.idx))
