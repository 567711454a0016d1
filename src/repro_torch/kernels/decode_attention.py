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

The kernel splits each sequence's cache rows over S CTAs
(:func:`plan_splits`, from shapes and the SM count only, so a call never
waits for the card and a CUDA graph can capture it) and merges the
splits' partials in the same launch: the wrapper hands it a workspace from
the caching allocator and the stream's merge tickets
(``_cuda.tickets``; a captured graph's own, ``_cuda.private_tickets``).
At G >= TENSOR_CORE_MIN_G the G query heads of a kv head run on the tensor
cores (mma.sync), below it on the CUDA-core lanes.
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

# The split-KV plan (kept equal to the constants of the CUDA source): aim at
# CTAS_PER_SM CTAs on every SM, splits of whole SPLIT_UNIT-row units of the
# cache, at most MAX_SPLITS splits of one (sequence, kv head) (half as many
# at G = 16, whose merge keeps twice the (m, l) pairs a split). Once the
# (sequence, kv head) pairs alone give every SM a CTA, the cache is not
# split: a split then adds only the merge's chain (the last CTA's ticket
# and its reads of the partials), which timed slower on an H100 at
# zamba2's B = 8, Hkv = 32.
CTAS_PER_SM = 2
SPLIT_UNIT = 16
MAX_SPLITS = 512
# the least group size whose query heads run on the tensor cores
TENSOR_CORE_MIN_G = 8


def max_splits(G: int = 1) -> int:
    """The most splits of one (sequence, kv head) the kernel holds at
    group size G (``max_splits`` of the CUDA source)."""
    return MAX_SPLITS // 2 if G > 8 else MAX_SPLITS


def plan_splits(B: int, Hkv: int, S: int, sm_count: int, G: int = 1) -> int:
    """The splits of each (sequence, kv head) of a cache of S rows, from
    shapes alone (the wrapper never reads cache_len on the host): one where
    the B·Hkv pairs already give every SM a CTA, else enough for
    CTAS_PER_SM CTAs a SM, never more than the cache's SPLIT_UNIT-row units
    (no split is empty of rows) or :func:`max_splits` at group size G."""
    units = -(-S // SPLIT_UNIT)
    if units <= 0 or B * Hkv >= sm_count:
        return 1
    want = -(-CTAS_PER_SM * sm_count // max(B * Hkv, 1))
    return max(1, min(want, units, max_splits(G)))


def split_ranges(S: int, splits: int):
    """Entries [lo, hi) of a list of ``S`` live rows (:func:`live_rows`)
    that each split takes, as the kernel cuts them: split j takes the
    units [j·U // splits, (j+1)·U // splits), U = ceil(S / 16)."""
    units = -(-S // SPLIT_UNIT)
    return [(min(j * units // splits * SPLIT_UNIT, S),
             min((j + 1) * units // splits * SPLIT_UNIT, S))
            for j in range(splits)]


def live_rows(S: int, cache_len: int, sliding_window: int = 0,
              sinks: int = 0) -> list:
    """The positions of a cache of ``S`` rows that the masks keep for a
    sequence of ``cache_len`` tokens, in the order the kernel's splits
    share them (``live_rows`` of the CUDA source): those before cache_len;
    with a window the sinks, then the window."""
    end = max(min(cache_len, S), 0)
    a1 = b0 = end
    if sliding_window > 0 and max(sinks, 0) < cache_len - sliding_window:
        a1, b0 = min(sinks, end), min(cache_len - sliding_window, end)
    return list(range(a1)) + list(range(b0, end))


def launch_geometry(B: int, Hkv: int, S: int, sm_count: int,
                    G: int = 1) -> dict:
    """The kernel's launch for these shapes: grid (x, y, z) = (splits, Hkv,
    B), splits fastest; CTAs, threads a CTA, the most cache rows one split
    walks, and which design runs (tensor cores or CUDA-core lanes)."""
    splits = plan_splits(B, Hkv, S, sm_count, G)
    return dict(grid=[splits, Hkv, B], ctas=B * Hkv * splits, threads=128,
                splits=splits,
                rows_per_split=max((hi - lo for lo, hi in
                                    split_ranges(S, splits)), default=0),
                design="mma.sync m16n8k16" if G >= TENSOR_CORE_MIN_G
                else "cuda-core lanes")


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
    if _cuda.is_fake(q):
        return _face("decode_attention_bf16", q, k_cache, v_cache, None, None,
                     cache_len, **kw)
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
    if _cuda.is_fake(q):
        return _face("decode_attention_int8", q, k_cache, v_cache, k_scale,
                     v_scale, cache_len, **kw)
    out = _launch("decode_attention_int8", q, k_cache, v_cache, k_scale,
                  v_scale, cache_len, **kw)
    decode_attention_int8.launches += 1
    return out


decode_attention.launches = 0        # bf16 kernel launches (real ones)
decode_attention_int8.launches = 0   # int8 kernel launches


def _launch(entry, q, k_cache, v_cache, k_scale, v_scale, cache_len, *,
            sliding_window, attention_sinks, logit_softcap, return_partials):
    if q.device.type != "cuda":
        raise ValueError(f"no dense decode kernel for device {q.device}")
    _check_cuda_operands(q, k_cache, v_cache, cache_len, k_scale, v_scale)
    B, Hkv, G, hd = q.shape
    S = k_cache.shape[2]
    dev = q.device
    stream = _cuda.stream_ptr(dev)
    splits = plan_splits(B, Hkv, S, _cuda.sm_count(dev), G)
    o = torch.empty_like(q)
    l = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev)
    m = torch.empty_like(l)
    ws, tickets = _cuda.split_scratch(dev, stream, B * Hkv, splits,
                                      G * (hd + 2))
    scales = () if k_scale is None else (k_scale.data_ptr(),
                                         v_scale.data_ptr())
    err = _kernel_fn(entry)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
        cache_len.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), B, Hkv, G, hd, S,
        k_cache.stride(0), splits, int(sliding_window),
        int(attention_sinks), float(logit_softcap), stream)
    _cuda.check(err, entry)
    if _cuda.ACCOUNTANTS:
        _cuda.account(entry, *cost(q, k_cache, k_scale is not None))
    if return_partials:
        return o, l, m
    return o


def _face(entry, q, k_cache, v_cache, k_scale, v_scale, cache_len, *,
          return_partials, **_):
    """The shape-only face of a launch on fake tensors: the operand checks,
    the outputs and split-KV workspace a launch allocates, the cost
    reported; nothing launched or counted in ``launches``."""
    _check_cuda_operands(q, k_cache, v_cache, cache_len, k_scale, v_scale)
    B, Hkv, G, hd = q.shape
    dev = q.device
    splits = plan_splits(B, Hkv, k_cache.shape[2], _cuda.face_sm_count(dev),
                         G)
    o = torch.empty_like(q)
    l = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev)
    m = torch.empty_like(l)
    if splits > 1:
        torch.empty(B * Hkv * splits * G * (hd + 2), dtype=torch.float32,
                    device=dev)
    _cuda.account(entry, *cost(q, k_cache, k_scale is not None))
    if return_partials:
        return o, l, m
    return o


def cost(q, k_cache, int8: bool):
    """(FLOPs, bytes) of one call from shapes alone, by the kernel table's
    bound rule over every cache row (a trace cannot see cache_len): QK and
    PV, 4·hd FLOPs a (row, query head); K and V read once (an int8 row hd
    + 4 bytes a token-head with its scale), q read, o, l, m written."""
    B, Hkv, G, hd = q.shape
    rows = B * k_cache.shape[2]
    row_bytes = (hd + 4) * 2 if int8 else hd * 2 * 2
    nbytes = (rows * Hkv * row_bytes + 2 * q.numel() + 4 * B +
              2 * q.numel() + 2 * 4 * B * Hkv * G)
    return 4 * rows * Hkv * G * hd, nbytes


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


def ctas_per_sm(int8: bool, head_dim: int, G: int) -> int:
    """CTAs of the kernel for this cache dtype, head size and group size
    that one SM of the current device holds at once (CUDA's occupancy of
    the instantiation); builds the library on first use."""
    fn = _cuda.load(_LIB_NAME).decode_attention_ctas_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(int(int8), head_dim, G)


def _kernel_fn(entry: str):
    fn = getattr(_cuda.load(_LIB_NAME), entry)
    if fn.argtypes is None:
        n_ptr = 11 if entry.endswith("int8") else 9
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + \
            [ctypes.c_longlong] + [ctypes.c_int] * 3 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
