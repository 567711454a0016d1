"""The yardstick: the H100's peaks and the operations and bytes of the
work a step does, from shapes alone. Nothing is read from the program's
own counts.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (no sparsity), at the
card's full 700 W power limit; a run prints the card's limit beside
them (``device.power_limit`` in its result line).
"""
from __future__ import annotations

from typing import Dict

H100_BF16_FLOPS = 989e12       # FLOP/s, bf16 / fp16 tensor cores, dense
H100_HBM_BYTES = 3.35e12       # bytes/s, HBM3

BF16 = 2
FP32 = 4
INT32 = 4


def layer_matmul_params(m: Dict) -> int:
    """Weights one layer multiplies a token by: q, k, v, o and SwiGLU's
    gate, up and down."""
    d, hd = m["d_model"], m["head_dim"]
    q = m["num_heads"] * hd
    kv = m["num_kv_heads"] * hd
    return d * q + 2 * d * kv + q * d + 3 * d * m["d_ff"]


def attention_flops(m: Dict, keys: int) -> int:
    """FLOPs of one query token over ``keys`` keys in every layer: q.k
    and p.v, 2 * hd each per key and head."""
    return 4 * m["num_layers"] * m["num_heads"] * m["head_dim"] * keys


def decode_token_flops(m: Dict, ctx: int) -> int:
    """Model FLOPs of one decoded token whose cache holds ``ctx`` tokens:
    the layers' matmuls, the LM head, and attention over ``ctx`` + 1
    keys (the cache and the token itself)."""
    return (2 * m["num_layers"] * layer_matmul_params(m) +
            2 * m["d_model"] * m["vocab_size"] + attention_flops(m, ctx + 1))


def causal_keys(start: int, n: int) -> int:
    """Keys that ``n`` queries at positions start .. start + n - 1 attend
    causally: n * start + n (n + 1) / 2."""
    return n * start + n * (n + 1) // 2


def chunk_flops(m: Dict, start: int, n: int) -> int:
    """Model FLOPs of a prefill chunk of ``n`` tokens after ``start``
    cached ones: the layers' matmuls for every token, causal attention,
    and the LM head for the chunk's last row (the only row whose logits
    the program computes)."""
    return (2 * m["num_layers"] * layer_matmul_params(m) * n +
            2 * m["d_model"] * m["vocab_size"] +
            attention_flops(m, causal_keys(start, n)))


def paged_decode_bytes(m: Dict, batch: int, ctx_sum: int, blocks: int) -> int:
    """Bytes row 1 needs in one step, all layers: every live token's K
    and V once (bf16), q in, the fp32 partial (o, l, m) out, each block
    table entry and cache length once. ``ctx_sum`` is the step's cached
    tokens over the batch, ``blocks`` its table entries."""
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    per_layer = (ctx_sum * Hkv * hd * 2 * BF16 + batch * H * hd * BF16 +
                 batch * H * (hd + 2) * FP32 + (blocks + batch) * INT32)
    return m["num_layers"] * per_layer


def paged_decode_flops(m: Dict, ctx_sum: int) -> int:
    """FLOPs of row 1 in one step, all layers (the cached keys only)."""
    return attention_flops(m, ctx_sum)


def paged_prefill_flops(m: Dict, start: int, n: int) -> int:
    """FLOPs of row 2 for one chunk, all layers: causal attention of its
    ``n`` real rows over ``start`` cached tokens and the chunk."""
    return attention_flops(m, causal_keys(start, n))


def paged_prefill_bytes(m: Dict, start: int, n: int) -> int:
    """Bytes row 2 needs for one chunk, all layers: the cached K/V once,
    the chunk's q, k, v in and its output out (bf16)."""
    H, Hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    per_layer = ((start + n) * Hkv * hd * 2 * BF16 +
                 n * H * hd * 2 * BF16)
    return m["num_layers"] * per_layer


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over HBM bandwidth."""
    return max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES)
