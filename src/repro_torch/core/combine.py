"""Partial-softmax attention combine (paper §4.2.2).
Port of ``repro/core/combine.py``.

Given a disjoint split of the token set I = I1 ∪ I2, with per-subset partial
results A_q(I) = Σ softmax-weighted values and S_q(I) = Σ exp(scores):

    A_q(I) = (A_q(I1)·S_q(I1) + A_q(I2)·S_q(I2)) / (S_q(I1) + S_q(I2))

The running max ``m`` rides alongside (A, S) for numerical stability. An
empty partial is the identity of :func:`combine` in both conventions the
code base uses: ``m = -inf`` (this module) and ``m = -1e30, s = 0`` (the
kernels' ``NEG_INF``).

:func:`psum_combine` is the cross-rank form (reference ``:84``): the
ranks of one mesh axis merge their partials by all-reduces over
``torch.distributed``, so only the triple crosses ranks.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Partial(NamedTuple):
    """Partial attention state for some subset of KV tokens.

    a: (..., head_dim)  — Σ exp(score - m) · v over the subset
    s: (...)            — Σ exp(score - m) over the subset
    m: (...)            — max score over the subset
    """
    a: torch.Tensor
    s: torch.Tensor
    m: torch.Tensor


def partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      logit_softcap: float = 0.0) -> Partial:
    """Compute the partial triple over one KV subset.

    q: (..., hd); k, v: (..., n, hd); mask: (..., n) True=attend."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("...k,...nk->...n", q.float() * scale, k.float())
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if mask is not None:
        s = torch.where(mask, s, -math.inf)
    m = s.amax(dim=-1)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, 0.0)  # empty subsets
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    denom = p.sum(dim=-1)
    a = torch.einsum("...n,...nk->...k", p, v.float())
    return Partial(a=a, s=denom, m=torch.where(finite, m, -math.inf))


def combine(p1: Partial, p2: Partial) -> Partial:
    """Associative, commutative merge of two disjoint partials."""
    m = torch.maximum(p1.m, p2.m)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.where(torch.isfinite(p1.m), torch.exp(p1.m - m_safe), 0.0)
    w2 = torch.where(torch.isfinite(p2.m), torch.exp(p2.m - m_safe), 0.0)
    return Partial(
        a=p1.a * w1[..., None] + p2.a * w2[..., None],
        s=p1.s * w1 + p2.s * w2,
        m=m,
    )


def finalize(p: Partial) -> torch.Tensor:
    """Partial -> attention output (normalise by the denominator)."""
    return p.a / p.s.clamp_min(1e-30)[..., None]


def combine_many(partials: list[Partial]) -> Partial:
    out = partials[0]
    for p in partials[1:]:
        out = combine(out, p)
    return out


def psum_combine(p: Partial, mesh, axis: str) -> Partial:
    """Merge the partials of every rank on ``axis`` of ``mesh`` (a
    ``DeviceMesh``), called on each of them: a MAX all-reduce of ``m``,
    each rank's (a, s) rebased onto that global max (an empty partial,
    ``m = -inf``, weighs 0), then SUM all-reduces of the rebased ``a`` and
    ``s``. Every rank returns the merged partial. The all-reduces work in
    place, so they run on new tensors; ``p`` is left as it was. The bytes
    handed to the collectives are those of the triple, 4·(hd + 2) a
    (row, head) in fp32."""
    group = mesh.get_group(axis)
    m_global = p.m.clone()
    dist.all_reduce(m_global, op=dist.ReduceOp.MAX, group=group)
    m_safe = torch.where(torch.isfinite(m_global), m_global, 0.0)
    w = torch.where(torch.isfinite(p.m), torch.exp(p.m - m_safe), 0.0)
    a = p.a * w[..., None]
    s = p.s * w
    dist.all_reduce(a, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
    return Partial(a=a, s=s, m=m_global)
