"""Serving subsystem — public API. Port of ``repro/serving/__init__.py``::

    from repro_torch.serving import LLMEngine, EngineConfig, Request

    engine = LLMEngine(cfg, params, EngineConfig(prefill_chunk_tokens=512))
    for token in engine.generate(prompt_tokens):   # streams as generated
        ...
"""
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.faults import (FaultEvent, FaultInjector,
                                        FaultScenario, ShardHealthTracker)
from repro_torch.serving.kvcache import OutOfBlocks, PagedKVCache, PoolExhausted
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
from repro_torch.serving.worker_pool import (AttentionWorkerPool, TransferLog,
                                             expected_transfer_bytes)

__all__ = [
    "EngineConfig", "EngineStats", "FaultEvent", "FaultInjector",
    "FaultScenario", "ShardHealthTracker", "EngineEvent", "LLMEngine",
    "RequestHandle", "SchedulingStalled", "CorruptedLogitsError",
    "PlacementStrategy", "make_placement", "Request", "SamplingParams",
    "State", "PagedKVCache", "OutOfBlocks", "PoolExhausted",
    "request_generator", "request_seed", "sample_per_request",
    "ChunkedPrefillPolicy", "FCFSPolicy", "PreemptingPolicy", "PrefixIndex",
    "RequestScheduler", "SchedulingPolicy", "make_policy",
    "AttentionWorkerPool", "TransferLog", "expected_transfer_bytes",
]
