"""Paged flash-decode GQA attention: CUDA kernel wrapper + plain twin.

Port of ``repro/kernels/paged_decode_attention.py``. The TPU kernel
``_paged_decode_kernel`` is replaced by the hand-written Hopper kernel in
``csrc/paged_decode_attention.cu``; :func:`paged_decode_attention_plain` is
its plain PyTorch twin (gather through the block table, then dense fp32
math) with the same signature and the same (o, l, m) conventions. The
int8-pool kernel ``_paged_decode_kernel_int8`` is the second entry point of
the same source (:func:`paged_decode_attention_int8`), with the same twin
given the scale pools.

The kernel splits each sequence's table over S CTAs (:func:`plan_splits`,
from shapes and the SM count only, so a call never waits for the card) and
merges the splits' partials in the same launch: the wrapper hands it a
workspace from the caching allocator and the stream's merge tickets (a
captured CUDA graph's own, ``_cuda.private_tickets``). Over a bf16 pool at
G >= TENSOR_CORE_MIN_G the G query heads of a kv head run on the tensor
cores (mma.sync, ``paged_decode_kernel_tc``), below it and over an int8
pool on the CUDA-core lanes (``paged_decode_kernel``): the source picks
the design from the group size, a shape, with no switch.

:func:`paged_decode_attention` dispatches on the device of ``q``: a CPU
tensor runs the plain twin, a CUDA tensor launches the kernel or raises.
There is no other switch and no fallback. Each wrapper counts its own
kernel's launches (``.launches``); the bf16 wrapper also counts those that
ran on the tensor cores (``.tc_launches``; the rest ran on the lanes).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _cuda

NEG_INF = -1e30
# Base-position sentinel for table slots a shard does not own (or pure pad):
# far beyond any real cache_len, so every mask kills the whole block while
# staying comfortably inside int32.
POS_PAD = 1 << 30

_LIB_NAME = "paged_decode_attention"

# The split-KV plan (kept equal to the constants of the CUDA source): aim at
# CTAS_PER_SM CTAs on every SM, at most MAX_SPLITS splits of one (sequence,
# kv head) (half as many at G = 16, whose merge keeps twice the (m, l)
# pairs a split) and at most MAX_SLOTS_PER_SPLIT table slots in one split.
# The tensor-core design fits 2 CTAs an SM at hd 128, so the same plan
# gives it two rounds of CTAs, which at glm4-9b's decode shape on an H100
# timed faster than aiming at 2 or 8.
CTAS_PER_SM = 4
MAX_SPLITS = 512
MAX_SLOTS_PER_SPLIT = 512
MAX_BLOCK_SIZE = 1024
# the instantiated shapes: head sizes and query heads per kv head
HEAD_DIMS = (64, 112, 128)
GROUPS = (1, 2, 4, 8, 16)
# the least group size whose query heads run on the tensor cores over a
# bf16 pool (kTcMinG of the CUDA source)
TENSOR_CORE_MIN_G = 8


def on_tensor_cores(G: int, int8: bool = False) -> bool:
    """Whether a launch at group size G runs the tensor-core design: bf16
    pools at G >= TENSOR_CORE_MIN_G (int8 pools always run the lanes)."""
    return not int8 and G >= TENSOR_CORE_MIN_G


def max_splits(G: int = 1) -> int:
    """The most splits of one (sequence, kv head) the kernel holds at
    group size G (``max_splits`` of the CUDA source)."""
    return MAX_SPLITS // 2 if G > 8 else MAX_SPLITS


def plan_splits(B: int, Hkv: int, nb: int, sm_count: int,
                G: int = 1) -> int:
    """S, the splits of each (sequence, kv head), from shapes alone (the
    wrapper never reads cache_len or the tables on the host): enough for
    CTAS_PER_SM CTAs a SM, never more than the table's nb slots (no split is
    empty of slots) or :func:`max_splits` at group size G, and enough that
    no split holds more than MAX_SLOTS_PER_SPLIT slots."""
    if nb <= 0:
        return 1
    cap = max_splits(G)
    want = -(-CTAS_PER_SM * sm_count // max(B * Hkv, 1))
    splits = max(1, min(want, nb, cap), -(-nb // MAX_SLOTS_PER_SPLIT))
    if splits > cap:
        raise ValueError(f"a table of {nb} slots needs more than "
                         f"{cap} splits of {MAX_SLOTS_PER_SPLIT}")
    return splits


def split_ranges(nb: int, splits: int):
    """Entries [lo, hi) of a list of ``nb`` table slots that each split
    takes, as the kernel cuts them: split j takes [j·nb // S, (j+1)·nb //
    S). The list is the table with block positions, else
    :func:`live_slots`."""
    return [(j * nb // splits, (j + 1) * nb // splits)
            for j in range(splits)]


def live_slots(nb: int, block_size: int, cache_len: int,
               sliding_window: int = 0, sinks: int = 0) -> list:
    """The table slots of a sequence of ``cache_len`` tokens that hold a
    row the masks keep, in the order the kernel's splits share them
    (``split_slots`` of the CUDA source, for tables without block
    positions): the slots before cache_len; with a window only those it
    reaches and those holding a sink."""
    hi = min(nb, -(-max(cache_len, 0) // block_size))
    a1 = b0 = hi
    if sliding_window > 0:
        win_lo = cache_len - sliding_window
        wlo = win_lo // block_size if win_lo > 0 else 0
        sa = -(-sinks // block_size) if sinks > 0 else 0
        if wlo > sa:
            a1, b0 = min(sa, hi), min(wlo, hi)
    return list(range(a1)) + list(range(b0, hi))


def launch_geometry(B: int, Hkv: int, nb: int, sm_count: int,
                    G: int = 1, int8: bool = False) -> dict:
    """The kernel's launch for these shapes: grid (x, y, z) = (S, Hkv, B),
    splits fastest; CTAs, threads a CTA, splits, the most table slots
    one split walks, and which design runs (tensor cores or CUDA-core
    lanes)."""
    splits = plan_splits(B, Hkv, nb, sm_count, G)
    return dict(grid=[splits, Hkv, B], ctas=B * Hkv * splits, threads=128,
                splits=splits, slots_per_split=-(-nb // splits) if nb else 0,
                design="mma.sync m16n8k16" if on_tensor_cores(G, int8)
                else "cuda-core lanes")


def default_block_positions(B: int, nb: int, block_size: int,
                            device=None) -> torch.Tensor:
    """Contiguous-table base positions: slot j starts at j·block_size."""
    return (torch.arange(nb, dtype=torch.int32, device=device)[None, :]
            * block_size).expand(B, nb)


def paged_gather_dense(k_pool, v_pool, block_tables):
    """Block-table gather into head-major dense (B, Hkv, nb·bs, hd) views —
    the plain data path (and the bytes the kernel avoids)."""
    Hkv, _, bs, hd = k_pool.shape
    B, nb = block_tables.shape
    idx = block_tables.long()
    kc = k_pool[:, idx].transpose(0, 1)    # (B, Hkv, nb, bs, hd)
    vc = v_pool[:, idx].transpose(0, 1)
    return (kc.reshape(B, Hkv, nb * bs, hd), vc.reshape(B, Hkv, nb * bs, hd))


def paged_gather_scales(scale_pool, block_tables):
    """Block-table gather of a (Hkv, num_blocks, bs) scale pool into the
    dense per-token (B, Hkv, nb·bs) view the int8 plain twin folds into its
    einsums — plain data path only."""
    Hkv, _, bs = scale_pool.shape
    B, nb = block_tables.shape
    s = scale_pool[:, block_tables.long()].transpose(0, 1)  # (B,Hkv,nb,bs)
    return s.reshape(B, Hkv, nb * bs)


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, cache_len,
                                 *, block_positions=None,
                                 k_scale=None, v_scale=None,
                                 sliding_window: int = 0,
                                 attention_sinks: int = 0,
                                 logit_softcap: float = 0.0,
                                 return_partials: bool = False):
    """Plain twin of both kernels: same arguments, same results. fp32 math;
    masked rows are selected away (their p and v are 0), an all-masked
    sequence yields the empty partial (l = 0, m = NEG_INF, o = 0).

    int8 pools pass their fp32 scale pools ``k_scale/v_scale`` (Hkv,
    num_blocks, bs): the k scale multiplies the scores after q·k and before
    the softcap, the v scale multiplies p before the PV product — where the
    reference's ``_paged_decode_kernel_int8`` puts them. Scales of masked
    rows are selected away too, so stale (even NaN) scale tiles of free
    blocks cannot reach the result."""
    B, Hkv, G, hd = q.shape
    bs = k_pool.shape[2]
    nb = block_tables.shape[1]
    if block_positions is None:
        block_positions = default_block_positions(B, nb, bs, q.device)
    kc, vc = paged_gather_dense(k_pool, v_pool, block_tables)
    pos = (block_positions[:, :, None].long() +
           torch.arange(bs, device=q.device)).reshape(B, nb * bs)
    clen = cache_len.long()[:, None]
    valid = pos < clen
    if sliding_window > 0:
        in_window = pos >= clen - sliding_window
        if attention_sinks > 0:
            in_window |= pos < attention_sinks
        valid &= in_window
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhgk,bhsk->bhgs", q.float() * scale, kc.float())
    vmask = valid[:, None, None, :]
    if k_scale is not None:
        ks = paged_gather_scales(k_scale, block_tables)
        vs = paged_gather_scales(v_scale, block_tables)
        s = s * torch.where(valid[:, None], ks, 0.0)[:, :, None, :]
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    s = torch.where(vmask, s, NEG_INF)
    m = s.amax(dim=-1)                                   # NEG_INF if empty
    p = torch.where(vmask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    pv = p
    if v_scale is not None:
        pv = p * torch.where(valid[:, None], vs, 0.0)[:, :, None, :]
    v = torch.where(valid[:, None, :, None], vc.float(), 0.0)
    acc = torch.einsum("bhgs,bhsk->bhgk", pv, v)
    o = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    if return_partials:
        return o, l, m
    return o


def _check_cuda_operands(q, k_pool, v_pool, block_tables, cache_len,
                         block_positions, k_scale=None, v_scale=None):
    B, Hkv, G, hd = q.shape
    dev = q.device
    pool_dtype = torch.bfloat16 if k_scale is None else torch.int8
    for name, t, dtype in (("q", q, torch.bfloat16),
                           ("k_pool", k_pool, pool_dtype),
                           ("v_pool", v_pool, pool_dtype),
                           ("block_tables", block_tables, torch.int32),
                           ("cache_len", cache_len, torch.int32),
                           ("block_positions", block_positions, torch.int32),
                           ("k_scale", k_scale, torch.float32),
                           ("v_scale", v_scale, torch.float32)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on the GPU; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4 or \
            k_pool.shape[0] != Hkv or k_pool.shape[3] != hd:
        raise ValueError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k_scale is not None and (k_scale.shape != k_pool.shape[:3] or
                                v_scale.shape != k_pool.shape[:3]):
        raise ValueError(f"scale pools must be {tuple(k_pool.shape[:3])}; "
                         f"got {tuple(k_scale.shape)}/{tuple(v_scale.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            cache_len.shape != (B,):
        raise ValueError("block_tables must be (B, nb) and cache_len (B,)")
    if block_positions is not None and \
            block_positions.shape != block_tables.shape:
        raise ValueError("block_positions must match block_tables' shape")
    if hd not in HEAD_DIMS or G not in GROUPS:
        raise ValueError(f"kernel instantiated for head_dim in {HEAD_DIMS} "
                         f"and group size in {GROUPS}; got hd={hd}, G={G}")
    if not 1 <= k_pool.shape[2] <= MAX_BLOCK_SIZE:
        raise ValueError(f"block size {k_pool.shape[2]} outside the kernel's "
                         f"1..{MAX_BLOCK_SIZE}")


def paged_decode_attention(q, k_pool, v_pool, block_tables, cache_len, *,
                           block_positions=None,
                           k_scale=None, v_scale=None,
                           sliding_window: int = 0, attention_sinks: int = 0,
                           logit_softcap: float = 0.0,
                           return_partials: bool = False):
    """q: (B, Hkv, G, hd); k_pool/v_pool: HEAD-MAJOR (Hkv, num_blocks,
    block_size, hd); block_tables: (B, nb) int32 pool-block ids per sequence
    (pad slots with any valid id — masked); cache_len: (B,) live tokens.
    block_positions: optional (B, nb) int32 global base position per table
    slot (default slot·block_size; POS_PAD on slots to ignore).
    k_scale/v_scale: the fp32 scale pools (Hkv, num_blocks, block_size) of
    int8 pools; given, the call is :func:`paged_decode_attention_int8`'s.
    Returns (B, Hkv, G, hd), or the (o, l, m) §4.2.2 triple with l, m fp32
    (B, Hkv, G) when ``return_partials``.

    CPU tensors run :func:`paged_decode_attention_plain`; CUDA tensors
    launch ``csrc/paged_decode_attention.cu`` or raise."""
    kw = dict(block_positions=block_positions, sliding_window=sliding_window,
              attention_sinks=attention_sinks, logit_softcap=logit_softcap,
              return_partials=return_partials)
    if k_scale is not None or v_scale is not None:
        return paged_decode_attention_int8(q, k_pool, v_pool, k_scale,
                                           v_scale, block_tables, cache_len,
                                           **kw)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            cache_len, **kw)
    if _cuda.is_fake(q):
        return _face("paged_decode_attention_bf16", q, k_pool, v_pool, None,
                     None, block_tables, cache_len, **kw)
    out = _launch("paged_decode_attention_bf16", q, k_pool, v_pool, None,
                  None, block_tables, cache_len, **kw)
    paged_decode_attention.launches += 1
    paged_decode_attention.tc_launches += on_tensor_cores(q.shape[2])
    return out


def paged_decode_attention_int8(q, k_pool, v_pool, k_scale, v_scale,
                                block_tables, cache_len, *,
                                block_positions=None,
                                sliding_window: int = 0,
                                attention_sinks: int = 0,
                                logit_softcap: float = 0.0,
                                return_partials: bool = False):
    """The int8-pool decode kernel: k_pool/v_pool int8 (Hkv, num_blocks,
    block_size, hd) with fp32 per-token scale pools k_scale/v_scale (Hkv,
    num_blocks, block_size), walked through the same table; q bf16. Other
    arguments and results as :func:`paged_decode_attention`.

    CPU tensors run the plain twin; CUDA tensors launch the int8 entry of
    ``csrc/paged_decode_attention.cu`` or raise."""
    if k_scale is None or v_scale is None:
        raise ValueError("an int8 pool needs both k_scale and v_scale")
    kw = dict(block_positions=block_positions, sliding_window=sliding_window,
              attention_sinks=attention_sinks, logit_softcap=logit_softcap,
              return_partials=return_partials)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            cache_len, k_scale=k_scale,
                                            v_scale=v_scale, **kw)
    if _cuda.is_fake(q):
        return _face("paged_decode_attention_int8", q, k_pool, v_pool,
                     k_scale, v_scale, block_tables, cache_len, **kw)
    out = _launch("paged_decode_attention_int8", q, k_pool, v_pool, k_scale,
                  v_scale, block_tables, cache_len, **kw)
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention.launches = 0        # bf16 kernel launches
paged_decode_attention.tc_launches = 0     # ... of them on the tensor cores
paged_decode_attention_int8.launches = 0   # int8 kernel launches


def _launch(entry, q, k_pool, v_pool, k_scale, v_scale, block_tables,
            cache_len, *, block_positions, sliding_window, attention_sinks,
            logit_softcap, return_partials):
    if q.device.type != "cuda":
        raise ValueError(f"no paged decode kernel for device {q.device}")
    _check_cuda_operands(q, k_pool, v_pool, block_tables, cache_len,
                         block_positions, k_scale, v_scale)
    B, Hkv, G, hd = q.shape
    _, num_blocks, bs, _ = k_pool.shape
    nb = block_tables.shape[1]
    dev = q.device
    stream = _cuda.stream_ptr(dev)
    splits = plan_splits(B, Hkv, nb, _cuda.sm_count(dev), G)
    o = torch.empty_like(q)
    l = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev)
    m = torch.empty_like(l)
    ws, tickets = _cuda.split_scratch(dev, stream, B * Hkv, splits,
                                      G * (hd + 2))
    fn = _kernel_fn(entry)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             None if k_scale is None else k_scale.data_ptr(),
             None if v_scale is None else v_scale.data_ptr(),
             block_tables.data_ptr(),
             None if block_positions is None else block_positions.data_ptr(),
             cache_len.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
             None if ws is None else ws.data_ptr(),
             None if tickets is None else tickets.data_ptr(),
             B, Hkv, G, hd, num_blocks, bs, nb, splits, int(sliding_window),
             int(attention_sinks), float(logit_softcap), stream)
    _cuda.check(err, entry)
    if _cuda.ACCOUNTANTS:
        _cuda.account(entry, *cost(q, k_pool, block_tables, block_positions,
                                   k_scale is not None))
    if return_partials:
        return o, l, m
    return o


def _face(entry, q, k_pool, v_pool, k_scale, v_scale, block_tables,
          cache_len, *, block_positions, return_partials, **_):
    """The shape-only face of a launch on fake tensors: the operand checks,
    the outputs and split-KV workspace a launch allocates, the cost
    reported; nothing launched or counted in ``launches``."""
    _check_cuda_operands(q, k_pool, v_pool, block_tables, cache_len,
                         block_positions, k_scale, v_scale)
    B, Hkv, G, hd = q.shape
    dev = q.device
    splits = plan_splits(B, Hkv, block_tables.shape[1],
                         _cuda.face_sm_count(dev), G)
    o = torch.empty_like(q)
    l = torch.empty((B, Hkv, G), dtype=torch.float32, device=dev)
    m = torch.empty_like(l)
    if splits > 1:
        torch.empty(B * Hkv * splits * G * (hd + 2), dtype=torch.float32,
                    device=dev)
    _cuda.account(entry, *cost(q, k_pool, block_tables, block_positions,
                               k_scale is not None))
    if return_partials:
        return o, l, m
    return o


def cost(q, k_pool, block_tables, block_positions, int8: bool):
    """(FLOPs, bytes) of one call from shapes alone, by the kernel table's
    bound rule over every row the tables name (a trace cannot see
    cache_len): 4·hd FLOPs a (row, query head); K and V read once (an int8
    row hd + 4 bytes a token-head), q, the tables, positions and lengths
    read, o, l, m written."""
    B, Hkv, G, hd = q.shape
    rows = B * block_tables.shape[1] * k_pool.shape[2]
    row_bytes = (hd + 4) * 2 if int8 else hd * 2 * 2
    nbytes = (rows * Hkv * row_bytes + 2 * q.numel() +
              4 * block_tables.numel() +
              (0 if block_positions is None else 4 * block_positions.numel())
              + 4 * B + 2 * q.numel() + 2 * 4 * B * Hkv * G)
    return 4 * rows * Hkv * G * hd, nbytes


def _kernel_fn(entry: str):
    fn = getattr(_cuda.load(_LIB_NAME), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
