"""Serving subsystem — public API. Port of ``repro/serving/__init__.py``::

    from repro_torch.serving import LLMEngine, EngineConfig, Request

    engine = LLMEngine(cfg, params, EngineConfig(prefill_chunk_tokens=512))
    for token in engine.generate(prompt_tokens):   # streams as generated
        ...

A prefill/decode disaggregated deployment fronts K engine replicas with
the cluster layer (``repro_torch.serving.cluster``)::

    from repro_torch.serving.cluster import DisaggCluster

    cluster = DisaggCluster(cfg, params, econf, replicas=4)
    cluster.submit(requests)      # prefix-affinity routed
    cluster.run()
"""
from repro_torch.serving.config import DisaggConfig, EngineConfig
from repro_torch.serving.faults import (FaultEvent, FaultInjector,
                                        FaultScenario, ShardHealthTracker)
from repro_torch.serving.kvcache import (KVHandoffPayload, OutOfBlocks,
                                         PagedKVCache, PoolExhausted)
from repro_torch.serving.llm_engine import (CorruptedLogitsError, EngineEvent,
                                            LLMEngine, RequestHandle,
                                            SchedulingStalled)
from repro_torch.serving.placement import PlacementStrategy, make_placement
from repro_torch.serving.request import Request, SamplingParams, State
from repro_torch.serving.sampler import (request_generator, request_seed,
                                         sample_per_request)
from repro_torch.serving.scheduler import (ChunkedPrefillPolicy, FCFSPolicy,
                                           PreemptingPolicy, PrefixIndex,
                                           RequestScheduler, SchedulingPolicy,
                                           make_policy)
from repro_torch.serving.stats import EngineStats
from repro_torch.serving.worker_pool import (AttentionWorkerPool,
                                             ExpertWorkerPool, TransferLog,
                                             expected_transfer_bytes,
                                             transfer_bytes_moe)

__all__ = [
    "EngineConfig", "DisaggConfig", "EngineStats", "FaultEvent",
    "FaultInjector", "FaultScenario", "ShardHealthTracker", "EngineEvent", "LLMEngine",
    "RequestHandle", "SchedulingStalled", "CorruptedLogitsError",
    "PlacementStrategy", "make_placement", "Request", "SamplingParams",
    "State", "PagedKVCache", "KVHandoffPayload", "OutOfBlocks",
    "PoolExhausted",
    "request_generator", "request_seed", "sample_per_request",
    "ChunkedPrefillPolicy", "FCFSPolicy", "PreemptingPolicy", "PrefixIndex",
    "RequestScheduler", "SchedulingPolicy", "make_policy",
    "AttentionWorkerPool", "ExpertWorkerPool", "TransferLog",
    "expected_transfer_bytes", "transfer_bytes_moe",
]
