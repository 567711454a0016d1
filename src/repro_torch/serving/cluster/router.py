"""ClusterRouter — prefix-affinity request routing over the replica fleet.
Port (a copy) of ``repro/serving/cluster/router.py``; the seeded
``random`` policy draws from ``random.Random(seed)`` exactly as the
reference does, so both packages route alike.

The routing key is the token-content chain of a prompt's LEADING FULL
BLOCKS — the same ``key_i = (key_{i-1}, block_tokens)`` chain the
:class:`~repro_torch.serving.scheduler.PrefixIndex` uses — hashed with FNV-1a
(NOT Python's ``hash()``, which is salted per process: routing must be
stable across processes so a restarted router lands the same streams on
the same replicas). Two prompts sharing their leading blocks hash to the
same replica, whose prefill engine's retained donors then serve the
shared prefix from residency: the affinity win IS the prefix-sharing win,
concentrated.

Assignments are memoized (sticky): once a prefix key lands on a replica,
followers go there too and count as ``router_affinity_hits`` on that
replica's prefill engine. An unhealthy target (a quarantined shard,
``serving/faults.py``) diverts to the least-loaded healthy replica WITHOUT
overwriting the memo — the stream snaps back when the shard rejoins.
"""
from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.serving.cluster.registry import Replica, ReplicaRegistry
from repro_torch.serving.request import Request

ROUTING_POLICIES = ("affinity", "random", "least_loaded")

_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3


def fnv1a_tokens(tokens: Sequence[int]) -> int:
    """64-bit FNV-1a over a token-id sequence. Deterministic across
    processes/runs (unlike the interpreter's salted ``hash``)."""
    h = _FNV_OFFSET
    for t in tokens:
        for b in int(t).to_bytes(8, "little", signed=True):
            h ^= b
            h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def prefix_route_key(prompt: Sequence[int], block_size: int,
                     affinity_blocks: int) -> Optional[Tuple[int, ...]]:
    """The routing key: tokens of the first ``affinity_blocks`` FULL
    blocks (fewer if the prompt is shorter). ``None`` when the prompt has
    no full leading block — nothing shareable to be affine about."""
    full = min(len(prompt) // block_size, affinity_blocks)
    if full <= 0:
        return None
    return tuple(prompt[:full * block_size])


class ClusterRouter:
    """Routes requests to replicas; policies: affinity (default — prefix
    hash with sticky memo + least-loaded fallback), random (seeded — the
    benchmark's baseline), least_loaded."""

    def __init__(self, registry: ReplicaRegistry, block_size: int,
                 policy: str = "affinity", affinity_blocks: int = 2,
                 seed: int = 0):
        if policy not in ROUTING_POLICIES:
            raise ValueError(f"routing policy must be one of "
                             f"{ROUTING_POLICIES}; got {policy!r}")
        if affinity_blocks < 1:
            raise ValueError(f"affinity_blocks must be >= 1; "
                             f"got {affinity_blocks}")
        if not len(registry):
            raise ValueError("router needs at least one replica")
        self.registry = registry
        self.block_size = block_size
        self.policy = policy
        self.affinity_blocks = affinity_blocks
        self._rng = random.Random(seed)
        # sticky prefix-key -> replica idx assignments (affinity policy)
        self._assignments: Dict[Tuple[int, ...], int] = {}

    def route(self, request: Request) -> Replica:
        if self.policy == "random":
            return self.registry[
                self._rng.randrange(len(self.registry))]
        if self.policy == "least_loaded":
            return self.registry.least_loaded()
        return self._route_affinity(request)

    def _route_affinity(self, request: Request) -> Replica:
        key = prefix_route_key(request.prompt, self.block_size,
                               self.affinity_blocks)
        if key is None:
            return self.registry.least_loaded()
        idx = self._assignments.get(key)
        if idx is None:
            # first sight of this prefix: deterministic hash placement
            # (stable across routers), recorded sticky
            idx = fnv1a_tokens(key) % len(self.registry)
            self._assignments[key] = idx
            return self._fallback_if_unhealthy(self.registry[idx])
        target = self.registry[idx]
        if target.healthy:
            # an affinity HIT: the stream lands where its prefix lives
            target.prefill.stats.router_affinity_hits += 1
            return target
        return self.registry.least_loaded()

    def _fallback_if_unhealthy(self, target: Replica) -> Replica:
        if target.healthy:
            return target
        return self.registry.least_loaded()

    @property
    def assignments(self) -> Dict[Tuple[int, ...], int]:
        return dict(self._assignments)
