"""Mixture-of-Experts layer (GShard/Switch-style capacity dispatch).
Port of ``repro/models/moe.py`` (``init_moe``, ``_capacity``,
``moe_forward``; the reference's ``set_sharding_hook`` is mesh tooling and
is not ported).

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

from repro_torch.models.common import ModelConfig, dense_init


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

    xg = x.reshape(G, gs, d)
    probs, top_p, onehot, keep, pos = route(params["router"], cfg, xg, C)
    pos_i = pos.long()

    # (G, gs, E, C) dispatch / combine, one routing choice at a time
    dtype = x.dtype
    dispatch = torch.zeros((G, gs, E, C), dtype=torch.float32,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    for j in range(k):
        slot = keep[:, :, j, :, None] * _one_hot(pos_i[:, :, j], C)
        dispatch = dispatch + slot
        combine = combine + slot * top_p[:, :, j, None, None]

    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(dtype), xg)
    h = torch.einsum("gecd,edf->gecf", xe, params["w_gate"])
    u = torch.einsum("gecd,edf->gecf", xe, params["w_up"])
    h = F.silu(h.float()).to(dtype) * u
    ye = torch.einsum("gecf,efd->gecd", h, params["w_down"])
    y = torch.einsum("gtec,gecd->gtd", combine.to(dtype), ye)

    # Switch-style load-balance loss
    frac_tokens = onehot.sum(dim=2).mean(dim=(0, 1))          # (E,)
    mean_prob = probs.mean(dim=(0, 1))                        # (E,)
    aux = E * torch.sum(frac_tokens * mean_prob) / k
    return y.reshape(B, S, d), aux.float()
