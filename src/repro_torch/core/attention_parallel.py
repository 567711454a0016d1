"""Multi-rank attention partitioning (paper §5 "Attention parallelism").
Port of ``repro/core/attention_parallel.py``.

The paper spreads decode attention over a pool of memory devices by
request (imbalanced) or by head (balanced, Lamina's choice). Here the pool
is the ranks of one axis of a ``DeviceMesh``, and the split the §4.2.2
combine makes exact, by block, serves a request whose KV exceeds one
device. Three PAGED partitions of the serving engines' block pool:

  * head:    the pool's head axis sharded; each rank owns its heads' blocks
             wholesale; no collective (heads are independent);
  * block:   the pool's BLOCK axis sharded; a sequence's round-robin blocks
             span every rank; each rank computes the §4.2.2 partial
             (a, s, m) over its local blocks and ``psum_combine`` merges
             them: only the triple crosses ranks, never KV;
  * request: the batch and its tables sharded, the pool replicated (the
             paper's rejected baseline, kept for the load-imbalance
             benchmark); no collective.

Each backend is ``shard_map``'s counterpart: called on every rank of the
mesh, its operands are DTensors at the reference's ``in_specs``, its result
a DTensor at its ``out_specs``, and the work between runs on each rank's
local shards (``local_map``).

NO-DENSIFY: every paged backend attends over the pool in place through its
(local) block table: on a CUDA tensor the hand-written paged decode kernel
(rows 1 / 3 of the kernel table, ``kernels/paged_decode_attention.py``), on
a CPU tensor its plain twin. No backend gathers the pool into a dense slab
or moves it between ranks: a pool or scale pool placed otherwise than the
spec raises ``ValueError`` (re-placing it would gather it across ranks).
The small operands (q, tables, lengths) are re-placed when they arrive
elsewhere, or taken as every rank's full copy when they are plain tensors.

The dense-cache variants (seq / head / request over seq-major (B, S, Hkv,
hd) caches) are kept for the non-paged sweeps; they compute the
reference's ``_masked_partial`` in torch ops and launch no kernel.

There is no ``backend`` or ``interpret`` argument: the device decides.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.core import combine as C
from repro_torch.core.disagg import P, placements
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels.ops import _triple_to_partial
from repro_torch.launch.mesh import mesh_axes


def _shard_map(fn, mesh, in_specs: Sequence[P], out_spec: P, operands,
               kv: Sequence[int]):
    """``fn`` over the local shards of ``operands`` placed at ``in_specs``
    on ``mesh``; the result is placed at ``out_spec``. Operands whose index
    is in ``kv`` (pools, scale pools, dense caches) must already be
    DTensors at their spec; the others are re-placed."""
    args, in_pl = [], []
    for i, (t, spec) in enumerate(zip(operands, in_specs)):
        pl = list(placements(spec, mesh))
        if i in kv:
            if not isinstance(t, DTensor) or t.device_mesh != mesh or \
                    list(t.placements) != pl:
                got = (tuple(t.placements) if isinstance(t, DTensor)
                       else "a plain tensor")
                raise ValueError(
                    f"operand {i} (KV) must be a DTensor on this mesh at "
                    f"{tuple(pl)} (spec {spec}); got {got}. The backend "
                    f"attends over the pool in place and never moves it "
                    f"between ranks: place it first (core/disagg.place)")
        elif isinstance(t, DTensor):
            if list(t.placements) != pl:
                t = t.redistribute(mesh, pl)
        else:
            # every rank's full copy: take its local chunk, no collective
            t = distribute_tensor(t, mesh, pl, src_data_rank=None)
        args.append(t)
        in_pl.append(pl)
    run = local_map(fn, out_placements=list(placements(out_spec, mesh)),
                    in_placements=tuple(in_pl), device_mesh=mesh)
    return run(*args)


def _masked_partial(q, k_cache, v_cache, valid, logit_softcap=0.0):
    """q: (B, H, hd); caches (B, S, Hkv, hd); valid: (B, S)."""
    B, H, hd = q.shape
    Hkv = k_cache.shape[2]
    group = H // Hkv
    qg = q.reshape(B, Hkv, group, hd)
    # scores per kv head without materialising repeated KV
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhgk,bshk->bhgs", qg.float() * scale, k_cache.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    s = torch.where(valid[:, None, None, :], s, -math.inf)
    m = s.amax(dim=-1)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
    denom = p.sum(dim=-1)
    a = torch.einsum("bhgs,bshk->bhgk", p, v_cache.float())
    return C.Partial(a=a.reshape(B, H, hd), s=denom.reshape(B, H),
                     m=torch.where(finite, m, -math.inf).reshape(B, H))


def _valid(pos, clen, sliding_window: int):
    valid = pos < clen[:, None]
    if sliding_window > 0:
        valid &= pos >= (clen[:, None] - sliding_window)
    return valid


# ---------------------------------------------------------------------------
# Sequence-level split (partial-combine across the pool axis)
# ---------------------------------------------------------------------------
def seq_parallel_decode_attention(mesh, axis: str, q, k_cache, v_cache,
                                  cache_len, *, sliding_window: int = 0,
                                  logit_softcap: float = 0.0,
                                  batch_axis: Optional[str] = None):
    """Decode attention with the KV sequence sharded over ``axis``.

    q: (B, H, hd) replicated over ``axis``; caches (B, S, Hkv, hd) with S
    sharded over ``axis``; cache_len (B,). Each rank computes its partial
    (a, s, m) over its KV slice; ``psum_combine`` merges them, the
    cross-rank form of paper §4.2.2."""
    bspec = P(batch_axis) if batch_axis else P()

    def shard_fn(q, kc, vc, clen):
        S_shard = kc.shape[1]
        idx = mesh.get_local_rank(axis)
        pos = idx * S_shard + torch.arange(S_shard, device=kc.device)[None]
        part = _masked_partial(q, kc, vc,
                               _valid(pos, clen, sliding_window),
                               logit_softcap)
        return C.finalize(C.psum_combine(part, mesh, axis)).to(q.dtype)

    return _shard_map(
        shard_fn, mesh,
        (P(batch_axis, None, None), P(batch_axis, axis, None, None),
         P(batch_axis, axis, None, None), bspec),
        P(batch_axis, None, None), (q, k_cache, v_cache, cache_len),
        kv=(1, 2))


# ---------------------------------------------------------------------------
# Head-level split (the paper's choice for Lamina)
# ---------------------------------------------------------------------------
def head_parallel_decode_attention(mesh, axis: str, q, k_cache, v_cache,
                                   cache_len, *, sliding_window: int = 0,
                                   logit_softcap: float = 0.0,
                                   batch_axis: Optional[str] = None):
    """KV heads sharded over ``axis``; each rank handles its heads fully.
    Requires Hkv % mesh size on ``axis`` == 0 (the paper's divisibility
    caveat)."""
    Hkv = k_cache.shape[2]
    n = mesh_axes(mesh)[axis]
    if Hkv % n:
        raise ValueError(
            f"head-level partitioning needs kv_heads ({Hkv}) divisible by "
            f"pool size ({n}) — paper §5; use seq-level instead")
    bspec = P(batch_axis) if batch_axis else P()

    def shard_fn(q, kc, vc, clen):
        pos = torch.arange(kc.shape[1], device=kc.device)[None]
        part = _masked_partial(q, kc, vc,
                               _valid(pos, clen, sliding_window),
                               logit_softcap)
        return C.finalize(part).to(q.dtype)

    return _shard_map(
        shard_fn, mesh,
        (P(batch_axis, axis, None), P(batch_axis, None, axis, None),
         P(batch_axis, None, axis, None), bspec),
        P(batch_axis, axis, None), (q, k_cache, v_cache, cache_len),
        kv=(1, 2))


# ---------------------------------------------------------------------------
# Paged variants: the pool-native backends. The KV operand is the serving
# engines' block pool (Hkv, num_blocks, block_size, hd) and a (B, nb) block
# table, which the paged decode kernel reads in place on each rank.
# ---------------------------------------------------------------------------
def _paged_shard_attend(q, kp, vp, bt, clen, *, sliding_window: int,
                        attention_sinks: int, logit_softcap: float,
                        k_scale=None, v_scale=None):
    """Finalized paged attention over one rank's pool slice, in place.

    q: (B, H_local, hd); kp/vp: (Hkv_local, NB, bs, hd); bt: (B, nb);
    clen: (B,). A CUDA tensor launches the paged decode kernel (its int8
    entry given the (Hkv_local, NB, bs) scale slices), a CPU tensor runs
    its plain twin; neither builds a dense slab."""
    B, H, hd = q.shape
    Hkv = kp.shape[0]
    qg = q.reshape(B, Hkv, H // Hkv, hd).contiguous()
    out = _pda.paged_decode_attention(
        qg, kp, vp, bt, clen, k_scale=k_scale, v_scale=v_scale,
        sliding_window=sliding_window, attention_sinks=attention_sinks,
        logit_softcap=logit_softcap)
    return out.reshape(B, H, hd).to(q.dtype)


def head_parallel_paged_decode_attention(mesh, axis: str, q, k_pool,
                                         v_pool, block_tables, cache_len, *,
                                         sliding_window: int = 0,
                                         attention_sinks: int = 0,
                                         logit_softcap: float = 0.0,
                                         batch_axis: Optional[str] = None,
                                         k_scale=None, v_scale=None):
    """Head-level split over the paged pool: each rank owns Hkv/n heads of
    every pool block (the pool's head axis sharded over ``axis``); the
    block table and lengths are replicated. Each rank runs the paged kernel
    (its plain twin on the CPU) over its head slice in place: no dense
    view, no collective. Requires Hkv % n == 0 (paper §5). Int8 pools: the
    (Hkv, NB, bs) scale pools shard on the same head axis."""
    Hkv = k_pool.shape[0]
    n = mesh_axes(mesh)[axis]
    if Hkv % n:
        raise ValueError(
            f"head-level partitioning needs kv_heads ({Hkv}) divisible by "
            f"pool size ({n}) — paper §5; use block-level instead")
    bspec = P(batch_axis) if batch_axis else P()
    btspec = P(batch_axis, None) if batch_axis else P()
    kw = dict(sliding_window=sliding_window, attention_sinks=attention_sinks,
              logit_softcap=logit_softcap)

    def shard_fn(q, kp, vp, bt, clen, *scales):
        skw = dict(zip(("k_scale", "v_scale"), scales))
        return _paged_shard_attend(q, kp, vp, bt, clen, **kw, **skw)

    operands = [q, k_pool, v_pool, block_tables, cache_len]
    in_specs = [P(batch_axis, axis, None), P(axis, None, None, None),
                P(axis, None, None, None), btspec, bspec]
    if k_scale is not None:
        operands += [k_scale, v_scale]
        in_specs += [P(axis, None, None)] * 2
    return _shard_map(shard_fn, mesh, in_specs, P(batch_axis, axis, None),
                      operands, kv=(1, 2, 5, 6))


def request_parallel_paged_decode_attention(mesh, axis: str, q, k_pool,
                                            v_pool, block_tables, cache_len,
                                            *, sliding_window: int = 0,
                                            attention_sinks: int = 0,
                                            logit_softcap: float = 0.0,
                                            k_scale=None, v_scale=None):
    """Request-level split over the paged pool: the batch (q, block table,
    lengths) sharded, the pool replicated; each rank walks only its
    requests' tables through the paged kernel, in place (the paper's
    load-imbalance baseline). Int8 pools: the scale pools replicate as the
    value pools do."""
    kw = dict(sliding_window=sliding_window, attention_sinks=attention_sinks,
              logit_softcap=logit_softcap)

    def shard_fn(q, kp, vp, bt, clen, *scales):
        skw = dict(zip(("k_scale", "v_scale"), scales))
        return _paged_shard_attend(q, kp, vp, bt, clen, **kw, **skw)

    operands = [q, k_pool, v_pool, block_tables, cache_len]
    in_specs = [P(axis, None, None), P(None, None, None, None),
                P(None, None, None, None), P(axis, None), P(axis)]
    if k_scale is not None:
        operands += [k_scale, v_scale]
        in_specs += [P(None, None, None)] * 2
    return _shard_map(shard_fn, mesh, in_specs, P(axis, None, None),
                      operands, kv=(1, 2, 5, 6))


def block_parallel_paged_decode_attention(mesh, axis: str, q, k_pool,
                                          v_pool, shard_tables,
                                          shard_positions, cache_len, *,
                                          sliding_window: int = 0,
                                          attention_sinks: int = 0,
                                          logit_softcap: float = 0.0,
                                          k_scale=None, v_scale=None):
    """Block-level split: ONE sequence's KV spans every pool rank.

    The pool's block axis is sharded over ``axis`` (rank s holds global
    blocks [s·npb, (s+1)·npb), the ``PagedKVCache`` shard layout); q and
    cache_len are replicated. shard_tables / shard_positions (n, B, nbl)
    hold each rank's LOCAL table and the global base position of every
    slot (``PagedKVCache.block_table_shards``): positions, not slot
    indices, anchor the causal / window / sink masks, because a shard's walk
    is not contiguous in the sequence. Each rank computes the §4.2.2
    partial (a, s, m) over one pass of its live local blocks (the paged
    kernel with ``return_partials`` on the card, its plain twin on the CPU)
    and ``psum_combine`` merges them exactly: only the triple crosses
    ranks, never KV. A rank with no live block of a sequence contributes
    the empty partial, the combine's identity. Int8 pools: the scale pools
    shard on the same block axis, and each rank dequantizes in its own
    partial, before the merge."""
    kw = dict(sliding_window=sliding_window, attention_sinks=attention_sinks,
              logit_softcap=logit_softcap)

    def shard_fn(q, kp, vp, bt, bp, clen, *scales):
        skw = dict(zip(("k_scale", "v_scale"), scales))
        B, H, hd = q.shape
        Hkv = kp.shape[0]
        o, l, m = _pda.paged_decode_attention(
            q.reshape(B, Hkv, H // Hkv, hd).contiguous(), kp, vp,
            bt[0].contiguous(), clen, block_positions=bp[0].contiguous(),
            return_partials=True, **kw, **skw)
        part = _triple_to_partial(o, l, m, B, H, hd)
        return C.finalize(C.psum_combine(part, mesh, axis)).to(q.dtype)

    operands = [q, k_pool, v_pool, shard_tables, shard_positions, cache_len]
    in_specs = [P(), P(None, axis, None, None), P(None, axis, None, None),
                P(axis, None, None), P(axis, None, None), P()]
    if k_scale is not None:
        operands += [k_scale, v_scale]
        in_specs += [P(None, axis, None)] * 2
    return _shard_map(shard_fn, mesh, in_specs, P(), operands,
                      kv=(1, 2, 6, 7))


# ---------------------------------------------------------------------------
# Request-level split (the paper's rejected baseline, for the imbalance
# benchmark)
# ---------------------------------------------------------------------------
def request_parallel_decode_attention(mesh, axis: str, q, k_cache,
                                      v_cache, cache_len, *,
                                      sliding_window: int = 0,
                                      logit_softcap: float = 0.0):
    def shard_fn(q, kc, vc, clen):
        pos = torch.arange(kc.shape[1], device=kc.device)[None]
        return C.finalize(_masked_partial(
            q, kc, vc, _valid(pos, clen, sliding_window),
            logit_softcap)).to(q.dtype)

    return _shard_map(
        shard_fn, mesh,
        (P(axis, None, None), P(axis, None, None, None),
         P(axis, None, None, None), P(axis)),
        P(axis, None, None), (q, k_cache, v_cache, cache_len), kv=(1, 2))
