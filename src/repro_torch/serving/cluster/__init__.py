"""Disaggregated serving cluster — prefill/decode split + routing.
Port of ``repro/serving/cluster/__init__.py``.

Public surface::

    from repro_torch.serving.cluster import (DisaggCluster, PrefillEngine,
                                             DecodeEngine, ClusterRouter,
                                             HandoffError)

``DisaggCluster`` is the one-call deployment: K prefill/decode replica
pairs, block-granular KV handoff between them (PreallocQueue →
TransferQueue → WaitingQueue on the decode side), and a prefix-affinity
router fronting the fleet. The engines are also usable standalone —
``PrefillEngine.on_handoff`` / ``DecodeEngine.enqueue_handoff`` is the
transport seam a real RPC fabric would replace.
"""
from repro_torch.serving.cluster.cluster import DisaggCluster
from repro_torch.serving.cluster.engines import DecodeEngine, PrefillEngine
from repro_torch.serving.cluster.queues import (Handoff, HandoffError,
                                                PreallocQueue, TransferQueue,
                                                WaitingQueue)
from repro_torch.serving.cluster.registry import Replica, ReplicaRegistry
from repro_torch.serving.cluster.router import (ClusterRouter, fnv1a_tokens,
                                                prefix_route_key)

__all__ = [
    "DisaggCluster", "PrefillEngine", "DecodeEngine",
    "Handoff", "HandoffError",
    "PreallocQueue", "TransferQueue", "WaitingQueue",
    "Replica", "ReplicaRegistry",
    "ClusterRouter", "fnv1a_tokens", "prefix_route_key",
]
