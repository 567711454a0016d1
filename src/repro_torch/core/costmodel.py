"""Analytical performance/cost model (paper §2, §3.1). Port of
``repro/core/costmodel.py`` over the port's ``ModelConfig``.

Implements the paper's roofline-style operator timing — MTIME(B) for the
non-attention (GEMM) part and ATIME(B, l) for the attention (BGEMV) part —
the minimum-interconnect-bandwidth formula (Fig. 4), the heterogeneous
DOP=(a,b) throughput estimator (Fig. 10/11), and the network stack latency
model (Fig. 13). Hardware specs follow paper Table 1 (``h100``, ``h20``);
the network stacks are the paper's four GPU stacks. The reference's
accelerator rows of another vendor (two ``HARDWARE`` entries and one
network stack) are left out: nothing in the port reads them.

On the H100 the port runs on, ``mtime`` and ``atime`` at ``efficiency=1.0``
are the roofline floors of a decode step's GEMMs and attention: the card's
989 TFLOP/s bf16 and 3350 GB/s. ``chip_smoke.py`` prints them beside the
GEMM and decode-kernel device times it measures for llama3-8b's step, so a
reader sees how far the card sits from its floor. The serving estimators
are the paper's projections and measure nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.models.common import ModelConfig


# ---------------------------------------------------------------------------
# Hardware database (paper Table 1)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    tflops_bf16: float          # peak dense bf16/fp16 TFLOP/s
    mem_gb: float               # HBM capacity
    mem_bw_gbs: float           # HBM bandwidth GB/s
    ici_gbs: float              # inter-chip interconnect GB/s (per direction)
    net_gbs: float              # datacenter network GB/s (NIC line rate)
    price_hr: float             # $/chip/hr (paper Table 1 sources)
    power_w: float = 0.0

    @property
    def flops(self) -> float:
        return self.tflops_bf16 * 1e12

    @property
    def mem_bw(self) -> float:
        return self.mem_bw_gbs * 1e9

    @property
    def mem_bytes(self) -> float:
        return self.mem_gb * (1 << 30)


HARDWARE: Dict[str, HardwareSpec] = {
    "h100": HardwareSpec("h100", 989.0, 80.0, 3350.0, 450.0, 50.0, 11.06, 700),
    "h20": HardwareSpec("h20", 148.0, 96.0, 4000.0, 450.0, 50.0, 4.63, 400),
}

BYTES_PER_EL = 2  # bf16/fp16, paper Table 2 "e"


# ---------------------------------------------------------------------------
# Model-level parameter / KV accounting
# ---------------------------------------------------------------------------
def param_count(cfg: ModelConfig) -> float:
    """Total parameters N (embedding + layers + head)."""
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.resolved_head_dim
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    n = emb
    if cfg.family in ("dense", "vlm", "moe"):
        attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd + \
            cfg.num_heads * hd * d
        if cfg.family == "moe":
            ffn = cfg.num_experts * 3 * d * cfg.moe_d_ff + d * cfg.num_experts
        else:
            ffn = 3 * d * cfg.d_ff
        n += L * (attn + ffn)
    elif cfg.family == "ssm":
        lora = max(32, d // 64)
        tmix = 5 * d * lora * 2 + 5 * d * d
        cmix = 2 * d * cfg.d_ff + d * d
        n += L * (tmix + cmix)
    elif cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * d
        H = d_inner // cfg.ssm_head_dim
        N = cfg.ssm_state
        mamba = d * (2 * d_inner + 2 * N + H) + d_inner * d
        attn_blk = d * cfg.num_heads * hd * 2 + 2 * d * cfg.num_kv_heads * hd \
            + 3 * d * cfg.d_ff
        n += L * mamba + attn_blk  # shared attention counted once
    elif cfg.family == "audio":
        attn = 4 * d * cfg.num_heads * hd
        ffn = 3 * d * cfg.d_ff
        n += cfg.encoder_layers * (attn + ffn)
        n += L * (2 * attn + ffn)  # self + cross + ffn
    return float(n)


def active_param_count(cfg: ModelConfig) -> float:
    """Activated parameters per token (= N for dense; router-selected for
    MoE) — used for MODEL_FLOPS = 6·N_active·D."""
    if cfg.family != "moe":
        return param_count(cfg)
    d, L = cfg.d_model, cfg.num_layers
    hd = cfg.resolved_head_dim
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd + \
        cfg.num_heads * hd * d
    ffn = cfg.experts_per_token * 3 * d * cfg.moe_d_ff + d * cfg.num_experts
    return float(emb + L * (attn + ffn))


def kv_bytes_per_token(cfg: ModelConfig) -> float:
    """KV-cache bytes per token per request: 2·e·L_kv·Hkv·hd."""
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        return 0.0
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // cfg.shared_attn_period
        return 2.0 * BYTES_PER_EL * n_attn * cfg.num_kv_heads * hd
    L = cfg.num_layers
    return 2.0 * BYTES_PER_EL * L * cfg.num_kv_heads * hd


# ---------------------------------------------------------------------------
# Paper §2: MTIME / ATIME rooflines
# ---------------------------------------------------------------------------
def mtime(cfg: ModelConfig, batch: int, hw: HardwareSpec,
          n_devices: int = 1, efficiency: float = 0.8) -> float:
    """One decode iteration of all non-attention operators (paper §2.2.1).

    flops = 2·N_active·B; bytes = e·N_active + 2·e·B·d·L (params once,
    activations per layer)."""
    n_act = active_param_count(cfg)
    flops = 2.0 * n_act * batch
    bytes_ = BYTES_PER_EL * (n_act + 2.0 * batch * cfg.d_model *
                             cfg.num_layers)
    t_compute = flops / (n_devices * hw.flops * efficiency)
    t_memory = bytes_ / (n_devices * hw.mem_bw * efficiency)
    return max(t_compute, t_memory)


def kv_quant_factor(cfg: ModelConfig) -> float:
    """Per-token KV byte ratio of the int8 quantized pool vs the bf16
    baseline: (hd·1 + 4 fp32-scale bytes) / (hd·e) per token-head — the
    §7 extension the serving engines implement (``kv_dtype="int8"``).
    ≈ 0.53 for hd = 128; both capacity (max batch) and per-iteration
    attention reads scale by it."""
    hd = cfg.resolved_head_dim
    return (hd + 4.0) / (hd * BYTES_PER_EL)


def atime(cfg: ModelConfig, batch: int, seq_len: float, hw: HardwareSpec,
          n_devices: int = 1, efficiency: float = 0.8,
          kv_byte_factor: float = 1.0) -> float:
    """One decode iteration of all attention operators (paper §2.2.2).

    BGEMV: every KV byte is read once; flops = 4·B·l·d_kv·G per layer pair
    (qk + pv); arithmetic intensity ≈ G, constant in B.
    ``kv_byte_factor`` scales the per-token KV footprint (int8 quantized
    pool: :func:`kv_quant_factor`)."""
    kv_bytes = kv_bytes_per_token(cfg) * batch * seq_len
    if kv_bytes == 0.0:  # attention-free
        return 0.0
    G = cfg.gqa_group
    # flops follow the DEQUANTIZED elements (quantization shrinks bytes
    # read, not MACs); memory follows the wire/pool bytes
    flops = kv_bytes / BYTES_PER_EL * 2.0 * G
    t_compute = flops / (n_devices * hw.flops * efficiency)
    t_memory = kv_bytes * kv_byte_factor / (n_devices * hw.mem_bw *
                                            efficiency)
    return max(t_compute, t_memory)


def mfu_nonattention(cfg: ModelConfig, batch: int, hw: HardwareSpec) -> float:
    """Fig. 2: model FLOPS utilisation of the non-attention part."""
    n_act = active_param_count(cfg)
    flops = 2.0 * n_act * batch
    return flops / hw.flops / mtime(cfg, batch, hw, efficiency=1.0)


def mbu_attention(cfg: ModelConfig, batch: int, seq_len: float,
                  hw: HardwareSpec) -> float:
    """Fig. 3: memory-bandwidth utilisation of the attention part."""
    kv_bytes = kv_bytes_per_token(cfg) * batch * seq_len
    return kv_bytes / hw.mem_bw / atime(cfg, batch, seq_len, hw,
                                        efficiency=1.0)


# ---------------------------------------------------------------------------
# Paper §3.1: minimum interconnect bandwidth (Fig. 4)
# ---------------------------------------------------------------------------
def transfer_bytes_per_iteration(cfg: ModelConfig, batch: int) -> float:
    """(2 + 2/G)·e·d·B·L — q + attn output (2·e·d·B·L) and k,v (2/G·e·d·B·L)
    per layer, both directions combined (paper §3.1)."""
    G = cfg.gqa_group
    return (2.0 + 2.0 / G) * BYTES_PER_EL * cfg.q_dim * batch * \
        cfg.num_layers


def minimum_bandwidth(cfg: ModelConfig, batch: int, seq_len: float,
                      hw_model: HardwareSpec, hw_attn: HardwareSpec,
                      alpha: float = 0.2, dop: Tuple[int, int] = (1, 1)
                      ) -> float:
    """Minimum DCN bandwidth (bytes/s) for ≤ α latency slow-down."""
    a, b = dop
    t = mtime(cfg, batch, hw_model, a) + atime(cfg, batch, seq_len, hw_attn, b)
    return transfer_bytes_per_iteration(cfg, batch) / (alpha * t)


# ---------------------------------------------------------------------------
# Network stack model (paper §6.3, Fig. 13)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NetworkStack:
    name: str
    base_rtt_us: float     # small-message GPU-to-GPU round trip
    peak_gbs: float        # achievable point-to-point bandwidth
    launch_overhead_us: float  # host kernel-launch on the critical path


NETWORK_STACKS: Dict[str, NetworkStack] = {
    # the paper's values (Fig. 13 / §4.1)
    "fhbn": NetworkStack("fhbn", 33.0, 45.7, 0.0),
    "nccl": NetworkStack("nccl", 66.6, 35.5, 20.0),
    "nccl_no_gdr": NetworkStack("nccl_no_gdr", 83.0, 21.0, 20.0),
    "gloo": NetworkStack("gloo", 120.0, 15.0, 20.0),
}


def pingpong_rtt_us(stack: NetworkStack, payload_bytes: float) -> float:
    """Round-trip time of the Fig. 13 microbenchmark."""
    wire = 2.0 * payload_bytes / (stack.peak_gbs * 1e9) * 1e6
    return stack.base_rtt_us + stack.launch_overhead_us + wire


def network_time_per_iteration(cfg: ModelConfig, batch: int,
                               stack: NetworkStack,
                               overlap_fraction: float = 0.0) -> float:
    """Per-iteration DCN time for model-attention disaggregation: 2 transfers
    per layer (QKV out, attention result back), RTT-dominated for small B.

    overlap_fraction: fraction hidden behind compute by the §4.2.2 schedule.
    """
    payload = transfer_bytes_per_iteration(cfg, batch) / cfg.num_layers
    per_layer = (stack.base_rtt_us + stack.launch_overhead_us) * 1e-6 + \
        payload / (stack.peak_gbs * 1e9)
    return cfg.num_layers * per_layer * (1.0 - overlap_fraction)


# ---------------------------------------------------------------------------
# Serving throughput / cost estimator (Fig. 10, 11)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServingEstimate:
    system: str
    dop: Tuple[int, int]
    batch: int
    tbt_s: float               # time between tokens
    throughput_tok_s: float
    cost_hr: float
    tok_per_dollar: float


def max_batch_homogeneous(cfg: ModelConfig, seq_len: float,
                          hw: HardwareSpec, n_devices: int,
                          mem_util: float = 0.9) -> int:
    """Largest batch whose weights+KV fit n_devices of `hw` (vLLM-style)."""
    budget = n_devices * hw.mem_bytes * mem_util - \
        BYTES_PER_EL * param_count(cfg)
    per_req = kv_bytes_per_token(cfg) * seq_len
    return max(int(budget / per_req), 0) if per_req > 0 else 1 << 16


def max_batch_disaggregated(cfg: ModelConfig, seq_len: float,
                            hw_attn: HardwareSpec, n_attn: int,
                            mem_util: float = 0.9,
                            kv_byte_factor: float = 1.0) -> int:
    """KV lives only on the attention pool (paper §4: model workers hold
    weights, attention workers hold KV). ``kv_byte_factor`` scales the
    per-token footprint (int8 pool admits ~2× the batch)."""
    budget = n_attn * hw_attn.mem_bytes * mem_util
    per_req = kv_bytes_per_token(cfg) * kv_byte_factor * seq_len
    return max(int(budget / per_req), 0) if per_req > 0 else 1 << 16


def estimate_vllm(cfg: ModelConfig, seq_len: float, hw: HardwareSpec,
                  n_devices: int, batch: Optional[int] = None
                  ) -> ServingEstimate:
    B = batch or max_batch_homogeneous(cfg, seq_len, hw, n_devices)
    B = max(B, 1)
    t = mtime(cfg, B, hw, n_devices) + atime(cfg, B, seq_len, hw, n_devices)
    cost = n_devices * hw.price_hr
    thr = B / t
    return ServingEstimate("vllm", (n_devices, 0), B, t, thr, cost,
                           thr * 3600.0 / cost)


def estimate_lamina(cfg: ModelConfig, seq_len: float,
                    hw_model: HardwareSpec, hw_attn: HardwareSpec,
                    dop: Tuple[int, int], batch: Optional[int] = None,
                    stack: NetworkStack = NETWORK_STACKS["fhbn"],
                    pipelined: bool = True,
                    overlap_fraction: float = 0.3,
                    kv_byte_factor: float = 1.0) -> ServingEstimate:
    """Paper's system: model on `a` compute devices, attention on `b` memory
    devices, staggered pipelining overlaps the two pools (§4.3).
    ``kv_byte_factor`` < 1 models the quantized KV pool (§7): the pool
    admits a proportionally larger batch AND each iteration reads
    proportionally fewer KV bytes."""
    a, b = dop
    B = batch or max_batch_disaggregated(cfg, seq_len, hw_attn, b,
                                         kv_byte_factor=kv_byte_factor)
    B = max(B, 1)
    t_m = mtime(cfg, B, hw_model, a)
    t_a = atime(cfg, B, seq_len, hw_attn, b, kv_byte_factor=kv_byte_factor)
    t_net = network_time_per_iteration(cfg, B, stack, overlap_fraction)
    tbt = t_m + t_a + t_net
    if pipelined:
        # with rotational staggered pipelining both pools stay busy; the
        # system completes one iteration per max(t_m, t_a + t_net) in steady
        # state (§4.3) while per-token latency stays ≈ tbt
        iter_time = max(t_m, t_a + t_net)
    else:
        iter_time = tbt
    cost = a * hw_model.price_hr + b * hw_attn.price_hr
    thr = B / iter_time
    return ServingEstimate("lamina", dop, B, tbt, thr, cost,
                           thr * 3600.0 / cost)
