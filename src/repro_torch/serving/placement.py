"""Placement strategies — where each operator of the decode step runs.
Port of ``repro/serving/placement.py`` (``PlacementStrategy`` and
``HomogeneousPlacement``; the attention-pool and MoE-offload placements
arrive with ``serving/worker_pool.py``)."""
from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.kvcache import PagedKVCache


class PlacementStrategy:
    """Base placement: where each operator of the decode step executes."""

    name = "base"

    def __init__(self, cfg: ModelConfig, econf: EngineConfig, device):
        self.cfg = cfg
        self.econf = econf
        self.device = device

    def decode_fn(self):
        """The one-iteration decode step ``(params, tokens, k_pool, v_pool,
        block_tables, lens, *extra) -> (logits, updates)``."""
        raise NotImplementedError

    def decode_extra_args(self, kv: PagedKVCache,
                          ids: Sequence[int]) -> Tuple:
        return ()

    def log_step(self, batch: int) -> None:
        pass

    def log_prefill_chunk(self, tokens: int) -> None:
        """Account one prefill chunk's KV landing in the pool (homogeneous
        placement moves nothing off the model worker)."""


class HomogeneousPlacement(PlacementStrategy):
    """vLLM-style baseline: every operator fused on the model worker."""

    name = "homogeneous"

    def decode_fn(self):
        cfg, device = self.cfg, self.device

        def step(params, tokens, k_pool, v_pool, block_tables, lens):
            return transformer.decode_step_paged(
                params, cfg, tokens, k_pool, v_pool, block_tables, lens,
                device=device)
        return step


_PLACEMENTS = {"homogeneous": HomogeneousPlacement}


def make_placement(cfg: ModelConfig, econf: EngineConfig,
                   device) -> PlacementStrategy:
    return _PLACEMENTS[econf.placement](cfg, econf, device)
