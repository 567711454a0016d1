"""Declarative serving configuration for
:class:`repro_torch.serving.llm_engine.LLMEngine` and the disaggregated
cluster's engines. Port of ``repro/serving/config.py`` (``EngineConfig``,
and ``DisaggConfig`` at ``:192``).

The fields and validation are the reference's, minus ``decode_backend``:
the port has no backend knob — the device of the KV pool decides whether
the paged attention runs the CUDA kernels (a GPU pool) or their plain
PyTorch twins (a CPU pool).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PLACEMENTS = ("homogeneous", "attention_pool", "moe_offload")
PARTITIONS = ("head", "request", "block")
SCHEDULERS = ("fcfs", "preempt")
KV_DTYPES = ("bf16", "int8")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Validated, declarative serving-engine configuration (frozen; derive
    variants with :meth:`replace`)."""

    # ---- placement (the paper's core decision) ----
    placement: str = "homogeneous"
    partition: str = "head"            # attention-pool work split
    attention_workers: int = 2         # pool DOP `b` (paper §5)
    expert_workers: int = 2            # moe_offload only

    # ---- KV pool ----
    num_blocks: int = 256
    block_size: int = 16
    kv_shards: Optional[int] = None    # None => derived
    # Pool element dtype: "bf16" stores the pool in the model's dtype;
    # "int8" stores int8 values with per-token fp32 scales (kernels fuse
    # the dequant).
    kv_dtype: str = "bf16"

    # ---- batching / scheduling ----
    max_batch: int = 8
    scheduler: str = "fcfs"
    decode_headroom: int = 8           # tokens reserved per admitted request
    # Refcounted prompt-prefix sharing: full prompt blocks matching a live
    # request's prefix map onto the donor's physical blocks at admission
    # (copy-on-write on divergence); one-shot and chunked prefill skip the
    # shared prefix.
    prefix_sharing: bool = False
    # Chunked paged prefill: block-aligned chunks of at most this many
    # tokens, at most one chunk per engine iteration beside the decode
    # batch; None = one-shot prefill.
    prefill_chunk_tokens: Optional[int] = None

    # ---- fault tolerance (the shard health machine, serving/faults.py):
    # a shard is declared dead after fault_retry_limit consecutive strikes;
    # attempt i of a retry sleeps fault_retry_backoff_s · 2^i ----
    fault_retry_limit: int = 3
    fault_retry_backoff_s: float = 0.0

    # ---- RNG ----
    # fallback sampling seed for requests whose SamplingParams.seed is None
    seed: int = 0

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}; "
                             f"got {self.placement!r}")
        if self.partition not in PARTITIONS:
            raise ValueError(f"partition must be one of {PARTITIONS}; "
                             f"got {self.partition!r}")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"scheduler must be one of {SCHEDULERS}; "
                             f"got {self.scheduler!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}; got "
                f"{self.kv_dtype!r} (placement={self.placement!r}, "
                f"partition={self.partition!r})")
        for field in ("attention_workers", "expert_workers", "num_blocks",
                      "block_size", "max_batch"):
            if getattr(self, field) < 1:
                raise ValueError(f"{field} must be >= 1; "
                                 f"got {getattr(self, field)}")
        if self.decode_headroom < 0:
            raise ValueError("decode_headroom must be >= 0")
        if self.fault_retry_limit < 1:
            raise ValueError(f"fault_retry_limit must be >= 1; "
                             f"got {self.fault_retry_limit}")
        if self.fault_retry_backoff_s < 0:
            raise ValueError(f"fault_retry_backoff_s must be >= 0; "
                             f"got {self.fault_retry_backoff_s}")
        if self.prefill_chunk_tokens is not None:
            if self.prefill_chunk_tokens < 1:
                raise ValueError(
                    f"prefill_chunk_tokens must be >= 1 (or None for "
                    f"one-shot prefill); got {self.prefill_chunk_tokens}")
            if self.prefill_chunk_tokens % self.block_size:
                raise ValueError(
                    f"prefill_chunk_tokens ({self.prefill_chunk_tokens}) "
                    f"must be a multiple of block_size ({self.block_size}) "
                    f"— every chunk boundary except the prompt's final "
                    f"partial block must be block-aligned so chunk KV "
                    f"scatters into whole pool blocks")
        if self.kv_shards is not None and self.kv_shards < 1:
            raise ValueError(f"kv_shards must be >= 1 (or None to derive); "
                             f"got {self.kv_shards}")
        if self.placement != "homogeneous" and self.partition == "block":
            shards = self.kv_shards
            if shards is not None and shards != self.attention_workers:
                raise ValueError(
                    "block partition shards the pool over the workers: "
                    f"kv_shards ({shards}) must equal attention_workers "
                    f"({self.attention_workers})")
        if self.num_blocks % self.resolved_kv_shards:
            raise ValueError(
                f"num_blocks ({self.num_blocks}) must divide evenly over "
                f"kv_shards ({self.resolved_kv_shards})")

    @property
    def resolved_kv_shards(self) -> int:
        """kv_shards with the block-partition default applied: the pool's
        block axis is sharded over exactly the attention workers."""
        if self.kv_shards is not None:
            return self.kv_shards
        if self.placement != "homogeneous" and self.partition == "block":
            return self.attention_workers
        return 1

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DISAGG_ROLES = ("prefill", "decode")


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Prefill/decode disaggregation knobs for the
    :class:`~repro_torch.serving.cluster.PrefillEngine` /
    :class:`~repro_torch.serving.cluster.DecodeEngine` split of
    ``LLMEngine`` (``serving/cluster/``). One instance is shared by a
    replica pair; ``role`` names which side an engine plays."""

    role: str = "prefill"
    # the wire budget: physical KV blocks a decode replica lands per engine
    # step while draining its TransferQueue. 0 = unbounded (a whole payload
    # imports in one step).
    transfer_blocks_per_step: int = 8
    # prefill-side prefix retention: an exported request's prompt blocks
    # stay resident (and registered in the PrefixIndex) as donor prefixes,
    # LRU-evicted under pool pressure. Only effective with
    # EngineConfig.prefix_sharing.
    retain_prefixes: bool = True
    max_retained_seqs: int = 32
    # transfer attempts per handoff before the decode replica raises a
    # HandoffError (each mid-transfer shard death burns one)
    max_transfer_attempts: int = 3

    def __post_init__(self):
        if self.role not in DISAGG_ROLES:
            raise ValueError(f"role must be one of {DISAGG_ROLES}; "
                             f"got {self.role!r}")
        if self.transfer_blocks_per_step < 0:
            raise ValueError(
                f"transfer_blocks_per_step must be >= 0 (0 = unbounded); "
                f"got {self.transfer_blocks_per_step}")
        if self.max_retained_seqs < 0:
            raise ValueError(f"max_retained_seqs must be >= 0; "
                             f"got {self.max_retained_seqs}")
        if self.max_transfer_attempts < 1:
            raise ValueError(f"max_transfer_attempts must be >= 1; "
                             f"got {self.max_transfer_attempts}")

    def replace(self, **kw) -> "DisaggConfig":
        return dataclasses.replace(self, **kw)
