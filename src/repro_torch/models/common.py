"""Common building blocks shared by every architecture family.

Port of ``repro/models/common.py``. Parameters are plain dicts of tensors;
per-layer parameters are stacked along a leading L axis, exactly like the
reference pytree, so weights cross over value for value
(``transformer.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes every supported family; unused fields stay 0.

    Field for field the reference ``ModelConfig``; ``dtype`` is a torch
    dtype."""

    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- attention variants ---
    sliding_window: int = 0  # 0 = full attention
    # StreamingLLM-style sinks kept attendable beside the sliding window
    attention_sinks: int = 0
    kv_cache_bits: int = 16
    local_global: bool = False  # gemma2-style alternating local/global
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    qk_norm: bool = False
    post_norms: bool = False  # gemma2 pre+post sandwich norms
    # --- SSM / RWKV ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    rwkv_head_dim: int = 64
    # --- hybrid (zamba2): one shared attention block every `period` layers ---
    shared_attn_period: int = 0
    # --- encoder/decoder (seamless) ---
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # --- modality frontend stubs ---
    modality: str = "text"  # text | vision | audio
    frontend_tokens: int = 0
    # --- kernels / lowering (kept for field parity with the reference) ---
    use_pallas_kernels: bool = False
    remat: bool = True
    lower_unrolled: bool = False
    # --- numerics ---
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    source: str = ""  # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def gqa_group(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Device
# ---------------------------------------------------------------------------
def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument. A CUDA
    device on a machine without one raises — nothing falls back to the
    CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    return dev


# ---------------------------------------------------------------------------
# Activation-placement hook (installed by the dry run's launcher; identity
# by default). Lives here so every model module (the layer stacks, the
# rwkv mixer) can pin an activation's placement without import cycles.
# ---------------------------------------------------------------------------
_ACT_CONSTRAINT = None


def set_activation_constraint(fn) -> None:
    """Install ``fn(x) -> x`` (or ``None`` to uninstall), called on the
    residual stream after every layer of the full-sequence stacks and on
    rwkv's fused mixer input (``launch/entrypoints.py``
    ``install_activation_constraint``)."""
    global _ACT_CONSTRAINT
    _ACT_CONSTRAINT = fn


def constrain_activation(x):
    return _ACT_CONSTRAINT(x) if _ACT_CONSTRAINT is not None else x


# ---------------------------------------------------------------------------
# Placed (DTensor) operands
# ---------------------------------------------------------------------------
def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor. Asked without importing
    ``torch.distributed.tensor`` (a second of start-up): before anything
    imported it, no DTensor exists."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def whole_rows(x):
    """A placed ``x`` with its last dim whole on every rank: a mesh dim
    that splits it is replicated (an all-gather); one that holds a pending
    sum is reduce-scattered over the last dim first, then gathered (the
    two halves of an all-reduce, the first of which the activation
    placement would pay anyway). The other mesh dims stay as they are."""
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    pl = tuple(x.placements)
    if any(p.is_partial() for p in pl) and \
            not any(isinstance(p, Shard) and p.dim == last for p in pl):
        n = x.device_mesh.size([p.is_partial() for p in pl].index(True))
        if x.shape[last] % n == 0:
            i = [p.is_partial() for p in pl].index(True)
            pl = pl[:i] + (Shard(last),) + pl[i + 1:]
            x = x.redistribute(x.device_mesh, pl)
    want = tuple(Replicate() if p.is_partial() or isinstance(p, Shard) and
                 p.dim == last else p for p in pl)
    return x if want == pl else x.redistribute(x.device_mesh, want)


def on_local_shards(fn, tensors, positions=(), dims=(0, 2)):
    """``fn(*tensors, *positions)`` on every rank's local shards of the
    DTensor ``tensors[0]`` (callers ask ``is_placed`` first). The common
    placement keeps each mesh dim on which ``tensors[0]`` is sharded over a
    tensor dim in ``dims`` that every tensor's size divides; other mesh
    dims are replicated first. The
    (B, S) ``positions`` follow the batch (Shard(0)) and are replicated
    otherwise. The result is placed as the tensors are. Used where a
    function mixes its operands with tensors it makes itself (RoPE's
    frequencies, the blockwise attention's masks and running state): on
    the local shards they are all plain tensors, so the function runs
    unchanged and a single device's result is untouched."""
    lead = tensors[0]
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = lead.device_mesh
    # placements as lists: local_map reads a tuple as one entry an output
    pl = [p if isinstance(p, Shard) and p.dim in dims and
          all(t.shape[p.dim] % mesh.size(i) == 0 for t in tensors)
          else Replicate() for i, p in enumerate(lead.placements)]
    pos_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
              for p in pl]
    positions = tuple(
        t if isinstance(t, DTensor) else DTensor.from_local(
            t.expand(lead.shape[0], t.shape[-1]).contiguous(), mesh,
            [Replicate()] * mesh.ndim, run_check=False)
        for t in positions)
    run = local_map(fn, out_placements=pl,
                    in_placements=(pl,) * len(tensors) +
                    (pos_pl,) * len(positions),
                    device_mesh=mesh, redistribute_inputs=True)
    return run(*tensors, *positions)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A placed table whose vocab rows are sharded
    (Shard(0) on a mesh dim) is looked up on each rank's rows: tokens
    outside them give zeros, and the result is pending a sum over that mesh
    dim (Partial), as a vocab-parallel embedding is; DTensor's own index
    rules are not used (an index over the sharded dim yields a mask that
    the next op cannot take, and some releases' rule for the gradient's
    ``index_put`` fails). On one device nothing changes."""
    if not is_placed(table):
        return table[tokens.long()]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0]
    if len(vocab) > 1 or vocab and table.shape[0] % mesh.size(vocab[0]):
        raise ValueError(f"vocab-parallel lookup needs the rows split "
                         f"evenly over one mesh dim; got "
                         f"{table.placements}")
    t_pl = [p if i in vocab else Replicate()
            for i, p in enumerate(table.placements)]
    k_pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 and
            i not in vocab else Replicate()
            for i, p in enumerate(tokens.placements)]
    o_pl = [Partial() if i in vocab else k_pl[i] for i in range(mesh.ndim)]
    rows = table.shape[0] // (mesh.size(vocab[0]) if vocab else 1)
    lo = mesh.get_local_rank(vocab[0]) * rows if vocab else 0

    def lookup(t, k):
        idx = k.long() - lo
        ok = (idx >= 0) & (idx < rows)
        return torch.where(ok[..., None], t[idx.clamp(0, rows - 1)], 0.0)

    # a rank's table gradient covers its own batch rows only: pending a
    # sum over the mesh dims that split the batch
    g_pl = [p if i in vocab else Partial() if isinstance(k_pl[i], Shard)
            else Replicate() for i, p in enumerate(t_pl)]
    return local_map(lookup, out_placements=o_pl,
                     in_placements=(t_pl, k_pl),
                     in_grad_placements=(g_pl, k_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


# ---------------------------------------------------------------------------
# Initialisation helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float = 1.0) -> torch.Tensor:
    """Truncated normal at ±3σ with σ = scale/sqrt(fan_in), fan_in =
    ``shape[0]`` (so ``wo (H, hd, d)`` has fan-in H) — the reference rule.
    Drawn in fp32 from ``gen`` (which must live on ``device``), then cast."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    std = scale / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (w * std).to(dtype)


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``(1 + weight)`` scale, computed in fp32. A placed
    ``x`` whose hidden dim is split (the activation placement of
    ``launch/entrypoints.py``) is gathered whole on that dim first, so
    the projections after the norm run column-parallel on full rows (the
    Megatron order: one all-gather in, one reduce-scatter out)."""
    if is_placed(x):
        x = whole_rows(x)
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + weight.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions broadcastable to (..., seq).
    Split-half convention: the first and second halves of head_dim rotate
    as pairs (not interleaved even/odd lanes). A placed ``x`` rotates on
    each rank's local shards (``on_local_shards``)."""
    if is_placed(x):
        return on_local_shards(lambda x_, p_: apply_rope(x_, p_, theta),
                               (x,), (positions,))
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., :, None].float() * freqs  # (..., s, hd/2)
    cos = torch.cos(angles)[..., :, None, :]          # (..., s, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    gate = torch.matmul(x, w_gate)
    up = torch.matmul(x, w_up)
    hidden = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    return torch.matmul(hidden, w_down)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL in fp32 (reference ``common.py:194``): the
    logsumexp of fp32 logits minus the gold logit, gathered at int64
    labels; with ``mask``, the masked sum over ``max(sum(mask), 1)``.
    Placed logits give each rank's rows their whole vocab first
    (``on_local_shards``): a gather over a vocab-sharded DTensor has no
    working rule."""
    if is_placed(logits):
        nll = on_local_shards(_token_nll, (logits,), (labels,), dims=(0,))
    else:
        nll = _token_nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold
