"""Flash-decode GQA attention over a DENSE head-major KV cache: CUDA kernel
wrapper + plain twin.

Port of ``repro/kernels/decode_attention.py``. The TPU kernel
``_decode_attn_kernel`` is replaced by the hand-written Hopper kernel in
``csrc/decode_attention.cu``; :func:`decode_attention_plain` is its plain
PyTorch twin with the same signature and the same (o, l, m) conventions:
masks ``pos < cache_len``, the sliding window ``pos >= cache_len - w`` and
the sinks ``pos < sinks``, applies the tanh softcap before the mask, and
zeroes v under the mask (slots past ``cache_len`` may hold anything).

:func:`decode_attention` dispatches on the device of ``q``: a CPU tensor
runs the plain twin, a CUDA tensor launches the kernel or raises. There is
no other switch and no fallback. The wrapper counts its kernel's launches
(``decode_attention.launches``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _cuda

NEG_INF = -1e30
_LIB_NAME = "decode_attention"


def decode_attention_plain(q, k_cache, v_cache, cache_len, *,
                           sliding_window: int = 0, attention_sinks: int = 0,
                           logit_softcap: float = 0.0,
                           return_partials: bool = False):
    """Plain twin of the kernel: same arguments, same results. fp32 math;
    masked slots are selected away (their p and v are 0); an all-masked
    row yields the empty partial (l = 0, m = NEG_INF, o = 0)."""
    B, Hkv, G, hd = q.shape
    S = k_cache.shape[2]
    pos = torch.arange(S, device=q.device)[None, :]
    clen = cache_len.long()[:, None]
    valid = pos < clen
    if sliding_window > 0:
        in_window = pos >= clen - sliding_window
        if attention_sinks > 0:
            in_window |= pos < attention_sinks
        valid &= in_window
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhgk,bhsk->bhgs", q.float() * scale, k_cache.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)                                   # NEG_INF if empty
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    v = torch.where(valid[:, None, :, None], v_cache.float(), 0.0)
    acc = torch.einsum("bhgs,bhsk->bhgk", p, v)
    o = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    if return_partials:
        return o, l, m
    return o


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     sliding_window: int = 0, attention_sinks: int = 0,
                     logit_softcap: float = 0.0,
                     return_partials: bool = False):
    """q: (B, Hkv, G, hd); k_cache/v_cache: HEAD-MAJOR (B, Hkv, S, hd);
    cache_len: (B,) int32 live tokens per sequence (the window is anchored
    to it). Returns (B, Hkv, G, hd) in q's dtype, or the (o, l, m) §4.2.2
    triple with l, m fp32 (B, Hkv, G) when ``return_partials``.

    CPU tensors run :func:`decode_attention_plain`; CUDA tensors launch
    ``csrc/decode_attention.cu`` (bf16 q and caches, contiguous; head_dim
    64 or 128, group size 1, 2, 4 or 8) or raise."""
    kw = dict(sliding_window=sliding_window, attention_sinks=attention_sinks,
              logit_softcap=logit_softcap, return_partials=return_partials)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no dense decode kernel for device {q.device}")
    _check_cuda_operands(q, k_cache, v_cache, cache_len)
    B, Hkv, G, hd = q.shape
    S = k_cache.shape[2]
    o = torch.empty_like(q)
    l = torch.empty((B, Hkv, G), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    err = _kernel_fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       cache_len.data_ptr(), o.data_ptr(), l.data_ptr(),
                       m.data_ptr(), B, Hkv, G, hd, S, int(sliding_window),
                       int(attention_sinks), float(logit_softcap),
                       _cuda.stream_ptr(q.device))
    _cuda.check(err, "decode_attention_bf16")
    decode_attention.launches += 1
    if return_partials:
        return o, l, m
    return o


decode_attention.launches = 0


def _check_cuda_operands(q, k_cache, v_cache, cache_len):
    B, Hkv, G, hd = q.shape
    for name, t, dtype in (("q", q, torch.bfloat16),
                           ("k_cache", k_cache, torch.bfloat16),
                           ("v_cache", v_cache, torch.bfloat16),
                           ("cache_len", cache_len, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on the GPU; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 or \
            k_cache.shape[:2] != (B, Hkv) or k_cache.shape[3] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if cache_len.shape != (B,):
        raise ValueError(f"cache_len must be ({B},); got "
                         f"{tuple(cache_len.shape)}")
    if hd not in (64, 128) or G not in (1, 2, 4, 8):
        raise ValueError(f"kernel instantiated for head_dim in (64, 128) and "
                         f"group size in (1, 2, 4, 8); got hd={hd}, G={G}")


def _kernel_fn():
    fn = _cuda.load(_LIB_NAME).decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
