"""Mixture-of-Experts layer (GShard/Switch-style capacity dispatch).
Port of ``repro/models/moe.py`` (``set_sharding_hook``, ``init_moe``,
``_capacity``, ``moe_forward``).

Tokens are routed in fixed-size groups (default 256 tokens): an fp32
router, softmax, the top-k experts of each token (ties to the lower
expert id, as ``jax.lax.top_k``), renormalised over the k choices. Each
(token, choice) is ranked within its expert by a cumulative sum in
token-major (gs·k) order, and a choice ranked at or past the expert's
capacity C is dropped (its combine weight is zero). The dispatch and
combine tensors (G, gs, E, C) are accumulated over the k choices in fp32,
then cast to the activation dtype; four einsums move tokens to the
experts, run the SwiGLU experts batched over E (SiLU in fp32) and combine
them back. Every expert is multiplied at every call, as in the reference,
so a decode step reads all expert weights.

Every shape is static and nothing reads a device value on the host, so a
CUDA graph can capture the layer. The expert FFNs are plain batched
matrix products, which the reference also computes outside any Pallas
kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import (ModelConfig, dense_init, is_placed,
                                       whole_rows)

# Placement hook of the dispatch pipeline, ``fn(tensor, kind) -> tensor``
# with kind "tokens", "dispatch" or "expert_tokens" (the reference's five
# sites). Like the reference, no launcher installs it: pinning the
# dispatch pipeline raised the per-layer collective bytes in the
# reference's dry runs. It stays for experiments; identity when unset.
_SHARDING_HOOK = None


def set_sharding_hook(fn) -> None:
    global _SHARDING_HOOK
    _SHARDING_HOOK = fn


def _shard(x, kind: str):
    return _SHARDING_HOOK(x, kind) if _SHARDING_HOOK is not None else x


def init_moe(gen: torch.Generator, cfg: ModelConfig, device,
             dtype=None) -> Dict:
    """The router (d, E) in fp32 and the experts' w_gate / w_up (E, d, f)
    and w_down (E, f, d) in ``dtype``, each expert drawn on its own with
    the reference's fan-in rule (fan-in d for w_gate / w_up, f for
    w_down), so the fp32 draw is one expert's at a time."""
    dtype = dtype or cfg.dtype
    E, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff

    def expert(shape):
        out = torch.empty((E, *shape), dtype=dtype, device=device)
        for e in range(E):
            out[e].copy_(dense_init(gen, shape, dtype, device))
        return out

    return {
        "router": dense_init(gen, (d, E), torch.float32, device),
        "w_gate": expert((d, f)),
        "w_up": expert((d, f)),
        "w_down": expert((f, d)),
    }


def _capacity(group_size: int, k: int, num_experts: int,
              factor: float) -> int:
    cap = int(group_size * k * factor / num_experts) + 1
    # round up to a multiple of 4 (the reference's tiling rule)
    return max(4, -(-cap // 4) * 4)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes; an index outside [0, n)
    gives a row of zeros (as ``jax.nn.one_hot``). A comparison with an
    arange: no host read of the indices."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def route(router: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor,
          C: int) -> Tuple[torch.Tensor, ...]:
    """The routing of token groups xg (G, gs, d) over experts of capacity
    C: (probs (G, gs, E), the renormalised top-k weights (G, gs, k), the
    one-hot choices (G, gs, k, E), the kept choices (G, gs, k, E) and each
    choice's rank within its expert (G, gs, k, E)), all fp32."""
    G, gs, _ = xg.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    logits = torch.einsum("gtd,de->gte", xg.float(), router)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert id: a stable descending sort
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9)
    # rank of each (token, choice) within its expert, token-major order
    onehot = _one_hot(top_i, E)
    flat = onehot.reshape(G, gs * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, gs, k, E)
    keep = (pos < C).float() * onehot
    return probs, top_p, onehot, keep, pos


def _dispatch(router: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor,
              C: int) -> Tuple[torch.Tensor, ...]:
    """The routing of :func:`route` and the (G, gs, E, C) dispatch and
    combine tensors built from it one routing choice at a time: (probs,
    the one-hot choices, dispatch, combine), fp32."""
    G, gs, _ = xg.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    probs, top_p, onehot, keep, pos = route(router, cfg, xg, C)
    pos_i = pos.long()
    dispatch = torch.zeros((G, gs, E, C), dtype=torch.float32,
                           device=xg.device)
    combine = torch.zeros_like(dispatch)
    for j in range(k):
        slot = keep[:, :, j, :, None] * _one_hot(pos_i[:, :, j], C)
        dispatch = dispatch + slot
        combine = combine + slot * top_p[:, :, j, None, None]
    return probs, onehot, dispatch, combine


def _dispatch_on_shards(router, cfg: ModelConfig, xg, C: int):
    """:func:`_dispatch` of placed token groups (G, gs, d), whole rows, on
    each rank's groups: routing is per group, so a rank sorts and ranks
    its own tokens and no token crosses ranks. The results keep xg's
    group split and are replicated over its other mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.distributed.tensor import Partial
    mesh = xg.device_mesh
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in xg.placements]
    # the router's gradient from a rank's groups: a pending sum over the
    # mesh dims that split the groups
    rg = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    return local_map(lambda r, x_: _dispatch(r, cfg, x_, C),
                     out_placements=(pl,) * 4,
                     in_placements=([Replicate()] * mesh.ndim, pl),
                     in_grad_placements=(rg, pl), device_mesh=mesh,
                     redistribute_inputs=True)(router, xg)


def _experts(disp, xg, comb, w_gate, w_up, w_down) -> torch.Tensor:
    """Dispatch the token groups xg (G, gs, d) to the experts' capacity
    slots, run the SwiGLU experts batched over E (SiLU in fp32) and
    combine them back: (G, gs, d)."""
    disp = _shard(disp, "dispatch")
    xe = _shard(torch.einsum("gtec,gtd->gecd", disp, xg), "expert_tokens")
    h = torch.einsum("gecd,edf->gecf", xe, w_gate)
    u = torch.einsum("gecd,edf->gecf", xe, w_up)
    h = F.silu(h.float()).to(xg.dtype) * u
    ye = _shard(torch.einsum("gecf,efd->gecd", h, w_down), "expert_tokens")
    return torch.einsum("gtec,gecd->gtd", _shard(comb, "dispatch"), ye)


def _experts_on_shards(disp, xg, comb, w_gate, w_up, w_down):
    """:func:`_experts` of placed groups on each rank's shards, expert
    parallel: a rank runs its groups (xg's group split) through its own
    experts (the weights' expert split over ``model``, their FSDP split of
    d gathered) on its slice of the dispatch and combine tensors, so its
    output is its experts' share of every token (a pending sum over the
    expert split). No token or expert weight is gathered across the
    expert split (DTensor's einsum rules in some releases cannot view the
    expert products split over E)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = xg.device_mesh
    g_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in xg.placements]
    e_dims = [isinstance(p, Shard) and p.dim == 0 and not isinstance(
        g_pl[i], Shard) for i, p in enumerate(w_gate.placements)]
    w_pl = [Shard(0) if e else Replicate() for e in e_dims]
    dc_pl = [Shard(2) if e else g for e, g in zip(e_dims, g_pl)]
    out_pl = [Partial() if e else g for e, g in zip(e_dims, g_pl)]
    # gradients: a rank's expert slice of the tokens (a pending sum over
    # the expert split) and its groups' share of the weights (a pending
    # sum over the group split)
    x_g = [Partial() if e else g for e, g in zip(e_dims, g_pl)]
    w_g = [Shard(0) if e else Partial() if isinstance(g, Shard)
           else Replicate() for e, g in zip(e_dims, g_pl)]
    from torch.distributed.tensor.experimental import local_map
    return local_map(_experts, out_placements=out_pl,
                     in_placements=(dc_pl, g_pl, dc_pl, w_pl, w_pl, w_pl),
                     in_grad_placements=(dc_pl, x_g, dc_pl, w_g, w_g, w_g),
                     device_mesh=mesh, redistribute_inputs=True)(
        disp, xg, comb, w_gate, w_up, w_down)


def moe_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                group_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), the Switch aux loss, fp32 scalar).

    The B·S tokens route in G groups of gs = min(group_size, B·S); B·S
    must be a multiple of gs (decode batches below group_size form one
    group), as the reference asserts."""
    B, S, d = x.shape
    T = B * S
    gs = min(group_size, T)
    G = T // gs
    if G * gs != T:
        raise ValueError(f"moe_forward: tokens T={T} not divisible by the "
                         f"routing group size gs={gs}")
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(gs, k, E, cfg.capacity_factor)

    xg = _shard(x.reshape(G, gs, d), "tokens")
    if is_placed(xg):
        xg = whole_rows(xg)
        probs, onehot, dispatch, combine = _dispatch_on_shards(
            params["router"], cfg, xg, C)
    else:
        probs, onehot, dispatch, combine = _dispatch(params["router"], cfg,
                                                     xg, C)
    dtype = x.dtype
    args = (dispatch.to(dtype), xg, combine.to(dtype), params["w_gate"],
            params["w_up"], params["w_down"])
    y = _experts_on_shards(*args) if is_placed(xg) else _experts(*args)

    # Switch-style load-balance loss
    frac_tokens = onehot.sum(dim=2).mean(dim=(0, 1))          # (E,)
    mean_prob = probs.mean(dim=(0, 1))                        # (E,)
    aux = E * torch.sum(frac_tokens * mean_prob) / k
    return y.reshape(B, S, d), aux.float()
