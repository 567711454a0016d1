"""int8 KV-cache quantization (paper §7: reduced-precision KV storage).
Port of ``repro/models/kv_quant.py``.

Per-token, per-kv-head symmetric max-abs quantization:
    k_int8[..., s, :] = round(k[..., s, :] / scale[..., s]),
    scale = max(max|k[..., s, :]| / 127, 1e-8)

All math is fp32, and ``torch.round`` rounds half to even as ``jnp.round``
does, so the int8 values and the scales equal the reference's bit for bit.
Dequantization is fused into the paged kernels' score / PV products (the
k scale multiplies the scores, the v scale the probabilities); only the
plain twins and the tests build a dequantized tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., S, hd) head-major KV slab -> (int8 values, fp32 scales
    (..., S))."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """int8 values back to ``dtype`` (``None`` keeps the fp32 math dtype)."""
    out = q.float() * scale[..., None]
    return out if dtype is None else out.to(dtype)


def quantize_token(k_new: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k_new: (..., Hkv, hd) single token -> (int8, scale (..., Hkv))."""
    return quantize_kv(k_new)
