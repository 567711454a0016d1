"""Model-layer conventions around the decode kernels, and the scan entry
points. Port of ``repro/kernels/ops.py``: the serving window mapping, the
triple -> Partial conversion, the dense and paged partial backends, and
``ssm_scan``/``rwkv6_scan``. The reference chose the kernel with a
``backend`` string (and the scans with ``cfg.use_pallas_kernels``); here
the device of the operands decides (a CPU tensor runs the plain twin, a
CUDA tensor the kernel) inside the kernel wrappers themselves, so the
reference's chunk dispatch (``:37``) is
``kernels/paged_prefill_attention.paged_prefill_chunk_attention`` itself.
"""
from __future__ import annotations

import torch

from repro_torch.core.combine import Partial
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels.rwkv6_scan import rwkv6_scan  # noqa: F401
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: F401


def _serving_window(sliding_window: int, attention_sinks: int, cache_len):
    """Map the model-layer window contract (anchored to total length
    cache_len + 1 — the incoming token counts) onto the kernels' (anchored
    to cache_len): the kernel window shrinks by one. sliding_window == 1
    covers ONLY the incoming token, which the kernels cannot express as a
    window (0 means "no window"), so the stored prefix is clamped to the
    always-attendable sinks instead. Returns (kernel_sw, kernel_sinks,
    kernel_cache_len)."""
    if sliding_window == 1:
        return 0, 0, torch.clamp(cache_len, max=attention_sinks)
    sw = max(sliding_window - 1, 0) if sliding_window > 0 else 0
    return sw, attention_sinks, cache_len


def _triple_to_partial(o, l, m, B, H, hd) -> Partial:
    """Kernel (o, l, m) -> combine.Partial with a = o·l."""
    return Partial(a=o.float().reshape(B, H, hd) * l.reshape(B, H)[..., None],
                   s=l.reshape(B, H), m=m.reshape(B, H))


def decode_partial(q, k_cache, v_cache, cache_len, *,
                   k_scale=None, v_scale=None,
                   sliding_window: int = 0, attention_sinks: int = 0,
                   logit_softcap: float = 0.0, row_offset: int = 0) -> Partial:
    """Partial triple over a DENSE head-major cache (the reference's
    ``_pallas_decode_partial_backend``, ``ops.py:97``, and, for int8
    caches, its jnp partial with ``k_scale``; model-layer contract:
    cache_len = stored tokens, window w.r.t. total length cache_len + 1).
    q: (B, H, hd); caches (B, Hkv, S, hd); k_scale/v_scale: the fp32
    (B, Hkv, S) scales of an int8 cache (the int8 kernel then runs).
    ``row_offset``: the global position of the cache's first row, when it
    holds one slice of a sequence-split cache (the placed decode step):
    the lengths and sinks are taken relative to it, so the kernel masks
    the slice's rows as the whole cache's."""
    B, H, hd = q.shape
    Hkv = k_cache.shape[1]
    qg = q.reshape(B, Hkv, H // Hkv, hd).contiguous()
    sw, sinks, clen = _serving_window(sliding_window, attention_sinks,
                                      cache_len)
    if row_offset:
        clen = clen - row_offset
        sinks = max(sinks - row_offset, 0)
    o, l, m = _da.decode_attention(
        qg, k_cache, v_cache, clen, k_scale=k_scale, v_scale=v_scale,
        sliding_window=sw,
        attention_sinks=sinks, logit_softcap=logit_softcap,
        return_partials=True)
    return _triple_to_partial(o, l, m, B, H, hd)


def paged_decode_partial(q, k_pool, v_pool, block_tables, cache_len, *,
                         k_scale=None, v_scale=None,
                         sliding_window: int = 0, attention_sinks: int = 0,
                         logit_softcap: float = 0.0) -> Partial:
    """Paged partial triple over the block pool (model-layer contract:
    cache_len = stored tokens, window w.r.t. total length cache_len + 1).

    q: (B, H, hd); pools HEAD-MAJOR (Hkv, num_blocks, bs, hd); block_tables
    (B, nb) int32; k_scale/v_scale: the (Hkv, num_blocks, bs) scale pools
    of int8 pools (the int8 kernel then runs)."""
    return paged_decode_partial_pos(
        q, k_pool, v_pool, block_tables, None, cache_len, k_scale=k_scale,
        v_scale=v_scale, sliding_window=sliding_window,
        attention_sinks=attention_sinks, logit_softcap=logit_softcap)


def paged_decode_partial_pos(q, k_pool, v_pool, block_tables,
                             block_positions, cache_len, *,
                             k_scale=None, v_scale=None,
                             sliding_window: int = 0,
                             attention_sinks: int = 0,
                             logit_softcap: float = 0.0) -> Partial:
    """Positions-aware paged partial (port of the reference's
    ``pallas_paged_decode_partial_pos``, ``ops.py:139``): one worker's
    table of a block-sharded sequence holds a non-contiguous subset of its
    blocks, so ``block_positions`` (B, nb) gives each slot's global base
    position and POS_PAD slots mask out entirely; a worker with no live
    block yields the empty partial (the §4.2.2 identity). The pool is read
    in place through the table. ``block_positions=None`` is the
    contiguous-table case (slot·block_size)."""
    B, H, hd = q.shape
    Hkv = k_pool.shape[0]
    qg = q.reshape(B, Hkv, H // Hkv, hd).contiguous()
    sw, sinks, clen = _serving_window(sliding_window, attention_sinks,
                                      cache_len)
    o, l, m = _pda.paged_decode_attention(
        qg, k_pool, v_pool, block_tables, clen,
        block_positions=block_positions, k_scale=k_scale, v_scale=v_scale,
        sliding_window=sw, attention_sinks=sinks,
        logit_softcap=logit_softcap, return_partials=True)
    return _triple_to_partial(o, l, m, B, H, hd)
