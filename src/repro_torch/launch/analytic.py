"""Analytic FLOP accounting: MODEL_FLOPS reference (6·N·D / 2·N·D) and the
recurrence corrections for the time-dimension scans. Port of
``repro/launch/analytic.py`` over the port's ``INPUT_SHAPES`` and cost
model; the formulas are the reference's, term for term. The corrections
count what a scan executes beyond a body counted once per batch row
(the reference's compiled-cost accounting counts rolled scan bodies once)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core import costmodel as cm
from repro_torch.models.common import ModelConfig


def tokens_processed(cfg: ModelConfig, shape: str) -> int:
    shp = INPUT_SHAPES[shape]
    if shp.kind == "decode":
        return shp.global_batch  # one new token per request
    if cfg.family == "audio":
        return shp.global_batch * max(32, shp.seq_len // 8)  # decoder tokens
    if cfg.modality == "vision":
        return shp.global_batch * shp.seq_len  # patches + text
    return shp.global_batch * shp.seq_len


def model_flops(cfg: ModelConfig, shape: str) -> float:
    """Reference useful FLOPs: 6·N_active·D (train) / 2·N_active·D
    (inference), the §Roofline MODEL_FLOPS numerator. Attention's O(S²)/KV
    term is intentionally excluded."""
    d = tokens_processed(cfg, shape)
    n = cm.active_param_count(cfg)
    mult = 6.0 if INPUT_SHAPES[shape].kind == "train" else 2.0
    return mult * n * d


def recurrence_corrections(cfg: ModelConfig, shape: str) -> Dict[str, float]:
    """FLOPs/bytes executed by time-scans beyond the once-counted body.
    Zero for decode shapes (single step) and non-recurrent families."""
    shp = INPUT_SHAPES[shape]
    if shp.kind == "decode" or cfg.family not in ("ssm", "hybrid"):
        return {"flops": 0.0, "bytes": 0.0}
    D = shp.global_batch * shp.seq_len
    steps_uncounted = D - shp.global_batch  # body counted once per batch row
    bwd = 3.0 if shp.kind == "train" else 1.0
    if cfg.family == "ssm":
        H = cfg.d_model // cfg.rwkv_head_dim
        P = cfg.rwkv_head_dim
        per_step = 5.0 * H * P * P  # kv outer + bonus + readout + decay + add
        per_step_bytes = 4.0 * H * P * 4  # r,k,v,w fp32 reads
        L = cfg.num_layers
        # time-mix recurrence + the prefill-style state reconstruction
        flops = bwd * L * steps_uncounted * per_step
        return {"flops": flops, "bytes": L * steps_uncounted * per_step_bytes}
    # hybrid (mamba2)
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    per_step = 5.0 * H * P * N
    per_step_bytes = (H * P + 2 * N + H) * 4
    L = cfg.num_layers
    return {"flops": bwd * L * steps_uncounted * per_step,
            "bytes": L * steps_uncounted * per_step_bytes}
