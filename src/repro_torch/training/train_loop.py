"""Training step and loop. Port of ``repro/training/train_loop.py``.

``make_train_step`` builds the fused forward, backward and AdamW update
(the reference jits it; here it runs eagerly on the parameters' device):
``loss_fn`` under autograd, ``torch.autograd.grad`` for every leaf, then
``optimizer.apply_updates``. With ``cfg.remat`` each layer (zamba2: each
superblock) is recomputed in the backward, as the reference's
``jax.checkpoint`` is. On the card the recurrent families' scans launch
their hand-written forward kernels (again in the recompute) and their
backward kernels (``kernels/ssm_scan.py``, ``kernels/rwkv6_scan.py``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig, is_placed
from repro_torch.training import optimizer as opt
from repro_torch.tree import tree_leaves, tree_unflatten


def _split_batch(batch: Dict, n: int):
    """The batch's tensors (B, ...) as n microbatches along the batch
    axis. A placed tensor is split on each rank's rows, so every
    microbatch keeps the batch's placement (no rank gathers another's
    rows): microbatch i holds the i-th n-th of each rank's rows."""
    parts = {k: _chunks(v, n) for k, v in batch.items()}
    for i in range(n):
        yield {k: v[i] for k, v in parts.items()}


def _chunks(v, n: int):
    if not is_placed(v):
        return torch.as_tensor(v).chunk(n, dim=0)
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(c, v.device_mesh, v.placements,
                               run_check=False)
            for c in v.to_local().chunk(n, dim=0)]


def loss_and_grads(params, cfg: ModelConfig, batch: Dict, device
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
    """The training loss, its metrics {"ce", "aux"} and the gradient of
    every parameter (``tree_leaves`` order; zeros for a leaf the
    loss does not reach), detached."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = transformer.loss_fn(tree_unflatten(params, live),
                                        cfg, batch, device=device)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
             for p, g in zip(live, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A placed parameter's gradient at the parameter's placements (autograd
    leaves it wherever the last op put it, a pending sum included), so the
    update, and with it every leaf of the step, keeps its placement."""
    if is_placed(p) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, adamw: opt.AdamWConfig,
                    grad_accum: int = 1) -> Callable:
    """``train_step(params, state, batch) -> (params, state, metrics)`` on
    the parameters' device. With ``grad_accum > 1`` the batch is split
    into microbatches run one after another with fp32 gradient
    accumulation; the loss, "ce" and "aux" are their means. ``metrics``:
    {"ce", "aux", "loss", "grad_norm", "lr"}, fp32 device scalars."""

    def train_step(params, state: opt.OptState, batch: Dict
                   ) -> Tuple[Any, opt.OptState, Dict[str, torch.Tensor]]:
        dev = tree_leaves(params)[0].device
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch, dev)
        else:
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            msum = {"ce": torch.zeros((), dtype=torch.float32, device=dev),
                    "aux": torch.zeros((), dtype=torch.float32, device=dev)}
            for mb in _split_batch(batch, grad_accum):
                l_, m_, g_ = loss_and_grads(params, cfg, mb, dev)
                gsum = [s + x.float() for s, x in zip(gsum, g_)]
                loss = loss + l_
                msum = {k: msum[k] + m_[k] for k in msum}
            grads = [g / grad_accum for g in gsum]
            loss = loss / grad_accum
            metrics = {k: v / grad_accum for k, v in msum.items()}
        params, state, om = opt.apply_updates(
            params, tree_unflatten(params, grads), state, adamw)
        return params, state, dict(metrics, loss=loss, **om)

    return train_step


def train(cfg: ModelConfig, adamw: opt.AdamWConfig, data_iter,
          num_steps: int, *, params=None, state=None,
          log_every: int = 10, seed: int = 0,
          checkpoint_dir: Optional[str] = None,
          checkpoint_every: int = 0,
          device="cuda") -> Tuple[Any, opt.OptState, list]:
    """``num_steps`` steps over ``data_iter``, from ``params`` (default:
    ``init_params(seed, cfg)`` on ``device``) and ``state`` (default: a
    fresh ``OptState``). Logs the reference's line at step 1 and every
    ``log_every`` steps (the only host reads of the metrics) and saves a
    checkpoint every ``checkpoint_every`` steps. Returns (params, state,
    history)."""
    from repro_torch.training import checkpoint as ckpt

    if params is None:
        params = transformer.init_params(seed, cfg, device=device)
    if state is None:
        state = opt.init_opt_state(params)
    step_fn = make_train_step(cfg, adamw)
    history = []
    t0 = time.time()
    for i in range(num_steps):
        batch = next(data_iter)
        params, state, metrics = step_fn(params, state, batch)
        if (i + 1) % log_every == 0 or i == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i + 1
            m["wall_s"] = time.time() - t0
            history.append(m)
            print(f"step {i+1:5d} loss={m['loss']:.4f} "
                  f"ce={m['ce']:.4f} gnorm={m['grad_norm']:.3f} "
                  f"lr={m['lr']:.2e} ({m['wall_s']:.1f}s)")
        if checkpoint_dir and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, params, state, step=i + 1)
    return params, state, history
