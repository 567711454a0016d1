"""Paged-context chunk-prefill GQA attention: CUDA kernel wrapper + plain
twin.

Port of ``repro/kernels/paged_prefill_attention.py``. One prefill chunk's
queries (positions [P, P+C), P = tokens already in the pool) attend over
the sequence's first ``nb`` pool blocks, read in place through the block
table, and over the chunk's own freshly projected K/V under the in-chunk
causal mask; per-row sliding-window / sink masks and the optional logit
softcap apply as in a one-shot prefill.

The TPU kernels ``_paged_prefill_chunk_kernel`` and
``_paged_prefill_chunk_kernel_int8`` (an int8 prefix with fp32 per-token
scales; the chunk's own K/V stay full precision) are replaced by the two
entry points of ``csrc/paged_prefill_attention.cu``;
:func:`paged_prefill_chunk_attention_plain` is their plain twin (gather —
and, for int8, dequantize — the prefix dense, dense fp32 math).
:func:`paged_prefill_chunk_attention` and
:func:`paged_prefill_chunk_attention_int8` run the twin for CPU tensors and
launch their kernel, or raise, for CUDA tensors; each counts its own
launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _cuda

NEG_INF = -1e30

_LIB_NAME = "paged_prefill_attention"
# the instantiated head sizes (any group size dividing 64)
HEAD_DIMS = (64, 112, 128)
# the most fp32 scores the plain twin holds at once (1 GiB)
PLAIN_SCORE_ELEMS = 1 << 28


def gather_prefix_dense(k_pool, v_pool, block_table):
    """Block-table gather of a contiguous prefix into seq-major dense
    (P, Hkv, hd) views — the plain data path (and exactly the bytes the
    kernel streams in place instead)."""
    Hkv, _, bs, hd = k_pool.shape
    nb = block_table.shape[0]
    idx = block_table.long()
    kp = k_pool[:, idx].permute(1, 2, 0, 3).reshape(nb * bs, Hkv, hd)
    vp = v_pool[:, idx].permute(1, 2, 0, 3).reshape(nb * bs, Hkv, hd)
    return kp, vp


def gather_prefix_scales(scale_pool, block_table):
    """Block-table gather of a (Hkv, num_blocks, bs) scale pool into the
    seq-major (P, Hkv) per-token view — plain data path only."""
    Hkv, _, bs = scale_pool.shape
    nb = block_table.shape[0]
    return scale_pool[:, block_table.long()].reshape(Hkv, nb * bs).T


def paged_prefill_chunk_attention_plain(q, k_pool, v_pool, block_table,
                                        k_chunk, v_chunk, *,
                                        k_scale=None, v_scale=None,
                                        sliding_window: int = 0,
                                        attention_sinks: int = 0,
                                        logit_softcap: float = 0.0):
    """Plain twin of both kernels: same arguments, same result (C, H, hd).
    An int8 pool's gathered prefix is dequantized here with its scale pools
    (the plain path may densify; the kernels never do). The chunk's rows
    are attended PLAIN_SCORE_ELEMS scores at a time (each row on its own,
    so the result does not depend on the slicing): a 512-row chunk over a
    524,288-token prefix would hold 34 GB of fp32 scores at once."""
    C, H, hd = q.shape
    Hkv, _, bs, _ = k_pool.shape
    G = H // Hkv
    P = block_table.shape[0] * bs
    kp, vp = gather_prefix_dense(k_pool, v_pool, block_table)
    kp, vp = kp.float(), vp.float()
    if k_scale is not None:
        kp = kp * gather_prefix_scales(k_scale, block_table)[:, :, None]
        vp = vp * gather_prefix_scales(v_scale, block_table)[:, :, None]
    k_all = torch.cat([kp, k_chunk.float()], dim=0)      # (P+C, Hkv, hd)
    v_all = torch.cat([vp, v_chunk.float()], dim=0)
    del kp, vp
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(C, Hkv, G, hd) * scale
    pos_k = torch.arange(P + C, device=q.device)[None, :]
    rows = max(1, PLAIN_SCORE_ELEMS // (H * (P + C)))
    out = []
    for c0 in range(0, C, rows):
        s = torch.einsum("chgd,khd->hgck", qg[c0:c0 + rows], k_all)
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        pos_q = P + c0 + torch.arange(s.shape[2], device=q.device)[:, None]
        valid = pos_k <= pos_q
        if sliding_window > 0:
            in_window = pos_k > pos_q - sliding_window
            if attention_sinks > 0:
                in_window |= pos_k < attention_sinks
            valid &= in_window
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        out.append(torch.einsum("hgck,khd->chgd", p / l.clamp_min(1e-30),
                                v_all))
    return torch.cat(out).reshape(C, H, hd).to(q.dtype)


def _check_cuda_operands(q, k_pool, v_pool, block_table, k_chunk, v_chunk,
                         k_scale=None, v_scale=None):
    C, H, hd = q.shape
    dev = q.get_device()          # an int: cheaper than comparing devices
    pool_dtype = torch.bfloat16 if k_scale is None else torch.int8
    for name, t, dtype in (("q", q, torch.bfloat16),
                           ("k_pool", k_pool, pool_dtype),
                           ("v_pool", v_pool, pool_dtype),
                           ("block_table", block_table, torch.int32),
                           ("k_chunk", k_chunk, torch.bfloat16),
                           ("v_chunk", v_chunk, torch.bfloat16),
                           ("k_scale", k_scale, torch.float32),
                           ("v_scale", v_scale, torch.float32)):
        if t is None:
            continue
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on the GPU; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Hkv = k_pool.shape[0]
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4 or \
            k_pool.shape[3] != hd or H % Hkv:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_scale is not None and (k_scale.shape != k_pool.shape[:3] or
                                v_scale.shape != k_pool.shape[:3]):
        raise ValueError(f"scale pools must be {tuple(k_pool.shape[:3])}; "
                         f"got {tuple(k_scale.shape)}/{tuple(v_scale.shape)}")
    if k_chunk.shape != (C, Hkv, hd) or v_chunk.shape != (C, Hkv, hd):
        raise ValueError(f"k_chunk/v_chunk must be {(C, Hkv, hd)}")
    if block_table.dim() != 1:
        raise ValueError("block_table must be (nb,)")
    if hd not in HEAD_DIMS or 64 % (H // Hkv):
        raise ValueError(f"kernel instantiated for head_dim in {HEAD_DIMS} "
                         f"and group sizes dividing 64; got hd={hd}, "
                         f"G={H // Hkv}")


def paged_prefill_chunk_attention(q, k_pool, v_pool, block_table,
                                  k_chunk, v_chunk, *,
                                  k_scale=None, v_scale=None,
                                  sliding_window: int = 0,
                                  attention_sinks: int = 0,
                                  logit_softcap: float = 0.0):
    """q: (C, H, hd) — one chunk's RoPE'd queries at global positions
    [P, P+C) where P = len(block_table)·block_size; k_pool/v_pool:
    HEAD-MAJOR (Hkv, num_blocks, block_size, hd); block_table: (nb,) int32
    pool ids of the sequence's already-written first nb blocks;
    k_chunk/v_chunk: (C, Hkv, hd) — this chunk's K/V (not yet in the pool).
    k_scale/v_scale: the fp32 scale pools (Hkv, num_blocks, block_size) of
    int8 pools; given, the call is
    :func:`paged_prefill_chunk_attention_int8`'s. Returns (C, H, hd).

    CPU tensors run :func:`paged_prefill_chunk_attention_plain`; CUDA
    tensors launch ``csrc/paged_prefill_attention.cu`` or raise."""
    kw = dict(sliding_window=sliding_window, attention_sinks=attention_sinks,
              logit_softcap=logit_softcap)
    if k_scale is not None or v_scale is not None:
        return paged_prefill_chunk_attention_int8(
            q, k_pool, v_pool, k_scale, v_scale, block_table, k_chunk,
            v_chunk, **kw)
    if q.device.type == "cpu":
        return paged_prefill_chunk_attention_plain(
            q, k_pool, v_pool, block_table, k_chunk, v_chunk, **kw)
    if _cuda.is_fake(q):
        return _face("paged_prefill_chunk_attention_bf16", q, k_pool, v_pool,
                     None, None, block_table, k_chunk, v_chunk)
    out = _launch("paged_prefill_chunk_attention_bf16", q, k_pool, v_pool,
                  None, None, block_table, k_chunk, v_chunk, **kw)
    paged_prefill_chunk_attention.launches += 1
    return out


def paged_prefill_chunk_attention_int8(q, k_pool, v_pool, k_scale, v_scale,
                                       block_table, k_chunk, v_chunk, *,
                                       sliding_window: int = 0,
                                       attention_sinks: int = 0,
                                       logit_softcap: float = 0.0):
    """The int8-pool chunk kernel: k_pool/v_pool int8 (Hkv, num_blocks,
    block_size, hd) with fp32 scale pools k_scale/v_scale (Hkv, num_blocks,
    block_size); q and the chunk's own K/V bf16 (scale 1.0). Other
    arguments and the result as :func:`paged_prefill_chunk_attention`.

    CPU tensors run the plain twin; CUDA tensors launch the int8 entry of
    ``csrc/paged_prefill_attention.cu`` or raise."""
    if k_scale is None or v_scale is None:
        raise ValueError("an int8 pool needs both k_scale and v_scale")
    kw = dict(sliding_window=sliding_window, attention_sinks=attention_sinks,
              logit_softcap=logit_softcap)
    if q.device.type == "cpu":
        return paged_prefill_chunk_attention_plain(
            q, k_pool, v_pool, block_table, k_chunk, v_chunk,
            k_scale=k_scale, v_scale=v_scale, **kw)
    if _cuda.is_fake(q):
        return _face("paged_prefill_chunk_attention_int8", q, k_pool, v_pool,
                     k_scale, v_scale, block_table, k_chunk, v_chunk)
    out = _launch("paged_prefill_chunk_attention_int8", q, k_pool, v_pool,
                  k_scale, v_scale, block_table, k_chunk, v_chunk, **kw)
    paged_prefill_chunk_attention_int8.launches += 1
    return out


paged_prefill_chunk_attention.launches = 0        # bf16 kernel launches
paged_prefill_chunk_attention_int8.launches = 0   # int8 kernel launches


def _launch(entry, q, k_pool, v_pool, k_scale, v_scale, block_table,
            k_chunk, v_chunk, *, sliding_window, attention_sinks,
            logit_softcap):
    if not q.is_cuda:
        raise ValueError(f"no paged prefill kernel for device {q.device}")
    _check_cuda_operands(q, k_pool, v_pool, block_table, k_chunk, v_chunk,
                         k_scale, v_scale)
    C, H, hd = q.shape
    Hkv, num_blocks, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    fn = _kernel_fn(entry)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             None if k_scale is None else k_scale.data_ptr(),
             None if v_scale is None else v_scale.data_ptr(),
             block_table.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
             out.data_ptr(), C, H, Hkv, hd, num_blocks, bs,
             block_table.shape[0], int(sliding_window), int(attention_sinks),
             float(logit_softcap), _cuda.stream_ptr(q.device))
    _cuda.check(err, entry)
    if _cuda.ACCOUNTANTS:
        _cuda.account(entry, *cost(q, k_pool, block_table,
                                   k_scale is not None))
    return out


def _face(entry, q, k_pool, v_pool, k_scale, v_scale, block_table, k_chunk,
          v_chunk):
    """The shape-only face of a launch on fake tensors: the operand checks,
    the output, the cost reported; nothing launched or counted in
    ``launches``."""
    _check_cuda_operands(q, k_pool, v_pool, block_table, k_chunk, v_chunk,
                         k_scale, v_scale)
    _cuda.account(entry, *cost(q, k_pool, block_table, k_scale is not None))
    return torch.empty_like(q)


def cost(q, k_pool, block_table, int8: bool):
    """(FLOPs, bytes) of one call from shapes alone, by the kernel table's
    bound rule with the causal mask and no window: 4·hd FLOPs a (query,
    key) pair and query head; q, the chunk's K/V and the prefix's P rows
    read once (an int8 row hd + 4 bytes a token-head), the table read, the
    output written."""
    C, H, hd = q.shape
    Hkv, _, bs, _ = k_pool.shape
    P = block_table.shape[0] * bs
    pairs = P * C + C * (C + 1) // 2
    row_bytes = (hd + 4) * 2 if int8 else hd * 2 * 2
    nbytes = (2 * (2 * q.numel() + 2 * C * Hkv * hd) + P * Hkv * row_bytes +
              4 * block_table.shape[0])
    return 4 * pairs * H * hd, nbytes


def launch_geometry(C, H, Hkv, hd, int8=False):
    """The CUDA kernel's launch for one call, from the code that launches
    it: threads and packed query rows per CTA, keys per tile, ring stages,
    dynamic shared memory (bytes) and CTAs. Needs the built library (a GPU
    host)."""
    fn = _cuda.load(_LIB_NAME).paged_prefill_chunk_geometry
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    _cuda.check(fn(C, H, Hkv, hd, int(int8), ctypes.addressof(out)),
                "paged_prefill_chunk_geometry")
    return dict(zip(("threads", "query_rows", "keys_per_tile", "stages",
                     "smem_bytes", "ctas"), out))


def _kernel_fn(entry: str):
    fn = getattr(_cuda.load(_LIB_NAME), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
