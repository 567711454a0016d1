"""AdamW (decoupled weight decay) on the parameter tree. Port of
``repro/training/optimizer.py``, functional as the reference is: moments
are fp32 whatever the parameter dtype, each update is computed in fp32 and
cast to the parameter's dtype once, and ``apply_updates`` returns new
tensors (``torch.optim.AdamW`` would update bf16 storage in place and round
differently). Every quantity stays on the device: no host read per step.

The tree is the port's parameter dict (``models/transformer.py``); its
leaves are visited in the reference's ``jax.tree.flatten`` order
(``repro_torch.tree``), which is also the order of a checkpoint's leaves
(``training/checkpoint.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: Any                 # fp32, the parameters' tree
    nu: Any


def init_opt_state(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio · lr``, in fp32
    (``step`` a tensor or an int)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ x²) over every leaf, in fp32, summed leaf by leaf in
    ``tree_leaves`` order."""
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(tree)[0].device)
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def apply_updates(params, grads, state: OptState, cfg: AdamWConfig
                  ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step. Gradients are clipped to a global norm of
    ``grad_clip``, and the reported ``grad_norm`` is the norm before the
    clip. Weight decay applies where ``p.ndim >= 2`` on the stacked
    leaves, as in the reference, so the per-layer norm weights (stacked to
    (L, d)) decay too. Returns (params, state, {"grad_norm", "lr"}), all
    new tensors."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:      # decay matrices only (standard exemption)
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        a, b, c = upd(p, g, m, v)
        new_p.append(a)
        new_m.append(b)
        new_v.append(c)
    return (tree_unflatten(params, new_p),
            OptState(step, tree_unflatten(params, new_m),
                     tree_unflatten(params, new_v)),
            {"grad_norm": gnorm, "lr": lr})
