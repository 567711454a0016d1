"""Flash-decode GQA attention over a DENSE head-major KV cache: CUDA kernel
wrappers + plain twin.

Port of ``repro/kernels/decode_attention.py``. The TPU kernel
``_decode_attn_kernel`` is replaced by the hand-written Hopper kernel in
``csrc/decode_attention.cu``; :func:`decode_attention_plain` is its plain
PyTorch twin with the same signature and the same (o, l, m) conventions:
masks ``pos < cache_len``, the sliding window ``pos >= cache_len - w`` and
the sinks ``pos < sinks``, applies the tanh softcap before the mask, and
zeroes v under the mask (slots past ``cache_len`` may hold anything).

:func:`decode_attention_int8` is the same kernel over an int8 cache with
fp32 per-token scales (the second entry of the same source). The
reference's Pallas kernel takes no scales: its int8 dense caches run the
jnp partial (``repro/models/attention.py:175``), of which this entry is
the device form; the twin applies the scales where that path does (k
scale on the scores before the softcap, v scale on p before PV).

:func:`decode_attention` dispatches on the device of ``q``: a CPU tensor
runs the plain twin, a CUDA tensor launches the kernel or raises. There is
no other switch and no fallback. Each wrapper counts its own kernel's
launches (``.launches``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _cuda

NEG_INF = -1e30
_LIB_NAME = "decode_attention"
# the instantiated shapes: head sizes and query heads per kv head
HEAD_DIMS = (64, 112, 128)
GROUPS = (1, 2, 4, 8, 16)


def decode_attention_plain(q, k_cache, v_cache, cache_len, *,
                           k_scale=None, v_scale=None,
                           sliding_window: int = 0, attention_sinks: int = 0,
                           logit_softcap: float = 0.0,
                           return_partials: bool = False):
    """Plain twin of both kernels: same arguments, same results. fp32 math;
    masked slots are selected away (their p and v are 0); an all-masked
    row yields the empty partial (l = 0, m = NEG_INF, o = 0).

    int8 caches pass their fp32 per-token scales ``k_scale/v_scale`` (B,
    Hkv, S): the k scale multiplies the scores after q·k and before the
    softcap, the v scale multiplies p before the PV product, l sums the
    unscaled p. Scales of masked slots are selected away too."""
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
    if k_scale is not None:
        ks = torch.where(valid[:, None], k_scale.float(), 0.0)
        s = s * ks[:, :, None, :]
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)                                   # NEG_INF if empty
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    pv = p
    if v_scale is not None:
        vs = torch.where(valid[:, None], v_scale.float(), 0.0)
        pv = p * vs[:, :, None, :]
    v = torch.where(valid[:, None, :, None], v_cache.float(), 0.0)
    acc = torch.einsum("bhgs,bhsk->bhgk", pv, v)
    o = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    if return_partials:
        return o, l, m
    return o


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     k_scale=None, v_scale=None,
                     sliding_window: int = 0, attention_sinks: int = 0,
                     logit_softcap: float = 0.0,
                     return_partials: bool = False):
    """q: (B, Hkv, G, hd); k_cache/v_cache: HEAD-MAJOR (B, Hkv, S, hd);
    cache_len: (B,) int32 live tokens per sequence (the window is anchored
    to it). k_scale/v_scale: the fp32 (B, Hkv, S) scales of an int8 cache;
    given, the call is :func:`decode_attention_int8`'s. Returns (B, Hkv,
    G, hd) in q's dtype, or the (o, l, m) §4.2.2 triple with l, m fp32
    (B, Hkv, G) when ``return_partials``.

    CPU tensors run :func:`decode_attention_plain`; CUDA tensors launch
    ``csrc/decode_attention.cu`` (bf16 q and caches, contiguous; head_dim
    in HEAD_DIMS, group size in GROUPS) or raise."""
    kw = dict(sliding_window=sliding_window, attention_sinks=attention_sinks,
              logit_softcap=logit_softcap, return_partials=return_partials)
    if k_scale is not None or v_scale is not None:
        return decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale,
                                     cache_len, **kw)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len, **kw)
    out = _launch("decode_attention_bf16", q, k_cache, v_cache, None, None,
                  cache_len, **kw)
    decode_attention.launches += 1
    return out


def decode_attention_int8(q, k_cache, v_cache, k_scale, v_scale, cache_len,
                          *, sliding_window: int = 0,
                          attention_sinks: int = 0,
                          logit_softcap: float = 0.0,
                          return_partials: bool = False):
    """The int8-cache kernel: k_cache/v_cache int8 (B, Hkv, S, hd) with
    fp32 per-token scales k_scale/v_scale (B, Hkv, S); q bf16. Other
    arguments and results as :func:`decode_attention`.

    CPU tensors run the plain twin; CUDA tensors launch the int8 entry of
    ``csrc/decode_attention.cu`` or raise."""
    if k_scale is None or v_scale is None:
        raise ValueError("an int8 cache needs both k_scale and v_scale")
    kw = dict(sliding_window=sliding_window, attention_sinks=attention_sinks,
              logit_softcap=logit_softcap, return_partials=return_partials)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      k_scale=k_scale, v_scale=v_scale, **kw)
    out = _launch("decode_attention_int8", q, k_cache, v_cache, k_scale,
                  v_scale, cache_len, **kw)
    decode_attention_int8.launches += 1
    return out


decode_attention.launches = 0        # bf16 kernel launches
decode_attention_int8.launches = 0   # int8 kernel launches


def _launch(entry, q, k_cache, v_cache, k_scale, v_scale, cache_len, *,
            sliding_window, attention_sinks, logit_softcap, return_partials):
    if q.device.type != "cuda":
        raise ValueError(f"no dense decode kernel for device {q.device}")
    _check_cuda_operands(q, k_cache, v_cache, cache_len, k_scale, v_scale)
    B, Hkv, G, hd = q.shape
    S = k_cache.shape[2]
    o = torch.empty_like(q)
    l = torch.empty((B, Hkv, G), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    scales = () if k_scale is None else (k_scale.data_ptr(),
                                         v_scale.data_ptr())
    err = _kernel_fn(entry)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
        cache_len.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(), B,
        Hkv, G, hd, S, k_cache.stride(0), int(sliding_window),
        int(attention_sinks), float(logit_softcap),
        _cuda.stream_ptr(q.device))
    _cuda.check(err, entry)
    if return_partials:
        return o, l, m
    return o


_CACHES = ("k_cache", "v_cache", "k_scale", "v_scale")


def _check_cuda_operands(q, k_cache, v_cache, cache_len, k_scale=None,
                         v_scale=None):
    B, Hkv, G, hd = q.shape
    cache_dtype = torch.bfloat16 if k_scale is None else torch.int8
    for name, t, dtype in (("q", q, torch.bfloat16),
                           ("k_cache", k_cache, cache_dtype),
                           ("v_cache", v_cache, cache_dtype),
                           ("cache_len", cache_len, torch.int32),
                           ("k_scale", k_scale, torch.float32),
                           ("v_scale", v_scale, torch.float32)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on the GPU; got {t.dtype}")
        # the caches (and scales) may be a head slice of a wider cache:
        # contiguous within a sequence, sequences any stride apart
        if not (t[:1] if name in _CACHES else t).is_contiguous():
            raise ValueError(f"{name} must be contiguous" +
                             (" within a sequence" if name in _CACHES
                              else ""))
    if k_cache.stride() != v_cache.stride():
        raise ValueError("k_cache and v_cache must have the same strides")
    if k_scale is not None and (
            k_scale.stride() != v_scale.stride() or
            k_scale.stride(0) * hd != k_cache.stride(0)):
        raise ValueError("the scales must be laid out as the caches, "
                         "sequences stride(0) / head_dim apart")
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 or \
            k_cache.shape[:2] != (B, Hkv) or k_cache.shape[3] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if cache_len.shape != (B,):
        raise ValueError(f"cache_len must be ({B},); got "
                         f"{tuple(cache_len.shape)}")
    if k_scale is not None and (k_scale.shape != k_cache.shape[:3] or
                                v_scale.shape != k_cache.shape[:3]):
        raise ValueError(f"scales must be {tuple(k_cache.shape[:3])}; got "
                         f"{tuple(k_scale.shape)}/{tuple(v_scale.shape)}")
    if hd not in HEAD_DIMS or G not in GROUPS:
        raise ValueError(f"kernel instantiated for head_dim in {HEAD_DIMS} "
                         f"and group size in {GROUPS}; got hd={hd}, G={G}")


def _kernel_fn(entry: str):
    fn = getattr(_cuda.load(_LIB_NAME), entry)
    if fn.argtypes is None:
        n_ptr = 9 if entry.endswith("int8") else 7
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + \
            [ctypes.c_longlong] + [ctypes.c_int] * 2 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
