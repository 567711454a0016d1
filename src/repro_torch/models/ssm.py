"""Attention-free sequence mixers: Mamba2 (SSD) and RWKV6 (Finch).
Port of ``repro/models/ssm.py``.

Both have (a) a full-sequence prefill path whose recurrence is a kernel
(``kernels/ssm_scan.py`` / ``kernels/rwkv6_scan.py``: the CUDA kernel on
the card, its plain twin on the CPU) and (b) an O(1)-state single-token
decode step. The reference switches its prefill recurrence between a
``lax.scan`` and the Pallas kernel with ``cfg.use_pallas_kernels``; here
the device decides, and that flag changes nothing.

``final_state=True`` also returns the recurrent state after the last
position, for decoding. The reference rebuilds it with a second sequential
scan (``blocks._mamba_final_state`` / ``_rwkv_final_state``); here it is the
closed form, a sum of outer products weighted by suffix products of the
decays (:func:`mamba_final_state`, :func:`rwkv_final_state`), from the
kernel's own inputs.

Mamba2 follows the scalar-decay SSD formulation (one decay per head);
RWKV6 follows the Finch data-dependent-decay recurrence with token-shift
lerps and LoRA-modulated mixing.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import (ModelConfig, constrain_activation,
                                       dense_init, is_placed, rms_norm)


def _suffix_products(a: torch.Tensor) -> torch.Tensor:
    """a: (B, S, ...) -> Π_{s > t} a_s along axis 1 (1 at the last t).
    A product of factors in [0, 1], never an exp of log differences: a
    decay that rounded to 0 gives 0, not NaN."""
    rev = torch.cumprod(a.flip(1), dim=1).flip(1)        # Π_{s >= t}
    return torch.cat([rev[:, 1:], torch.ones_like(rev[:, :1])], dim=1)


_HEAD_DIM = {"bh": 2, "s": 1, "h": 0}


def _on_heads(fn, operands, kinds: str, outs: str = "bh"):
    """``fn(*operands)``; placed operands run on each rank's shards of
    batch and heads (every head and sequence is independent: the scans,
    their closed-form final states, the decode recurrence). ``kinds``
    names each operand's layout and ``outs`` each result's: "bh" (B, S,
    H, ...), "s" (B, H, ...), "b" (B, S, N) shared by every head (split
    over batch only), "h" (H, ...) (split over heads only). The batch
    and heads are split as the first operand splits them, the heads also
    over a ``model`` dim it is replicated on (a local slice)."""
    lead = operands[0]
    if not is_placed(lead):
        return fn(*operands)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = lead.device_mesh
    kinds, outs = kinds.split(), outs.split()
    hd = _HEAD_DIM[kinds[0]]
    H = lead.shape[hd]

    def keep(p, i):
        if not isinstance(p, Shard):
            return None
        if p.dim == 0 and lead.shape[0] % mesh.size(i) == 0:
            return "b"
        if p.dim == hd and H % mesh.size(i) == 0:
            return "h"
        return None

    kept = [keep(p, i) for i, p in enumerate(lead.placements)]
    names = mesh.mesh_dim_names or ()
    if "h" not in kept and "model" in names:
        i = names.index("model")
        if lead.placements[i].is_replicate() and H % mesh.size(i) == 0:
            kept[i] = "h"

    def pl(kind, grad=False):
        """An operand's placements; for its gradient, a mesh dim it is
        replicated over but the work splits (heads for "b", batch for
        "h") holds each rank's share: a pending sum."""
        out = []
        for k in kept:
            if k is None:
                out.append(Replicate())
            elif (kind, k) in (("b", "h"), ("h", "b")):
                out.append(Partial() if grad else Replicate())
            else:
                out.append(Shard(0 if k == "b" else _HEAD_DIM[kind]))
        return out

    out_pl = tuple(pl(k) for k in outs)
    return local_map(fn, out_placements=out_pl[0] if len(outs) == 1
                     else out_pl,
                     in_placements=tuple(pl(k) for k in kinds),
                     in_grad_placements=tuple(pl(k, True) for k in kinds),
                     device_mesh=mesh, redistribute_inputs=True)(*operands)


# ===========================================================================
# Mamba2
# ===========================================================================
def mamba_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device,
               dtype=None) -> Dict:
    dtype = dtype or cfg.dtype
    d_inner, H, P, N = mamba_dims(cfg)
    d = cfg.d_model
    conv_ch = d_inner + 2 * N  # conv over x, B, C
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj -> [z (d_inner), x (d_inner), B (N), C (N), dt (H)]
        "w_in": dense_init(gen, (d, 2 * d_inner + 2 * N + H), dtype, device),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), dtype, device,
                             0.5),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "a_log": torch.zeros((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "d_skip": torch.ones((H,), **f32),
        "out_norm": torch.zeros((d_inner,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (d_inner, d), dtype, device),
    }


def _mamba_project(params, cfg, x, conv_state=None):
    """Shared pre-recurrence math. x: (B, S, d).

    Returns (z, xh, Bm, Cm, dt, new_conv_state) with
      z, xh: (B, S, H, P); Bm, Cm: (B, S, N); dt: (B, S, H) fp32;
      new_conv_state: the last K-1 pre-activation conv inputs.
    """
    proj = torch.matmul(x, params["w_in"])
    args = (params["conv_w"], params["conv_b"], params["dt_bias"], proj) + \
        (() if conv_state is None else (conv_state,))
    if is_placed(proj):
        return _mamba_conv_on_shards(cfg, *args)
    return _mamba_conv(cfg, *args)


def _mamba_conv_on_shards(cfg, *args):
    """:func:`_mamba_conv` of a placed projection on each rank's rows,
    whole on the channels (the split into z / x / B / C / dt and the
    causal conv need them whole; some DTensor releases cannot pad a
    channel-split tensor). The results keep the batch split; the conv
    weights' gradients from a rank's rows are pending sums over it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from functools import partial
    proj = args[3]
    mesh = proj.device_mesh
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in proj.placements]
    rep = [Replicate()] * mesh.ndim
    wg = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    extra = len(args) - 4                     # the decode step's conv state
    return local_map(partial(_mamba_conv, cfg), out_placements=(pl,) * 6,
                     in_placements=(rep,) * 3 + (pl,) * (1 + extra),
                     in_grad_placements=(wg,) * 3 + (pl,) * (1 + extra),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _mamba_conv(cfg, conv_w, conv_b, dt_bias, proj, conv_state=None):
    d_inner, H, P, N = mamba_dims(cfg)
    x = proj
    z, xr, Bm, Cm, dt = torch.split(proj, [d_inner, d_inner, N, N, H],
                                    dim=-1)
    # causal depthwise conv over (x, B, C)
    conv_in = torch.cat([xr, Bm, Cm], dim=-1)  # (B, S, conv_ch)
    K = cfg.ssm_conv
    S = conv_in.shape[1]
    if conv_state is None:  # full sequence: pad left
        padded = F.pad(conv_in, (0, 0, K - 1, 0))
    else:  # decode: prepend cached last K-1 inputs
        padded = torch.cat([conv_state, conv_in], dim=1)
    new_conv_state = padded[:, -(K - 1):, :]
    if conv_state is None:   # a copy: a view would keep all S rows alive
        new_conv_state = new_conv_state.clone()
    conv = sum(padded[:, i:i + S, :] * conv_w[i] for i in range(K)) + conv_b
    conv = F.silu(conv.float()).to(x.dtype)
    xr, Bm, Cm = torch.split(conv, [d_inner, N, N], dim=-1)
    B_ = x.shape[0]
    xh = xr.reshape(B_, S, H, P)
    z = z.reshape(B_, S, H, P)
    dt = F.softplus(dt.float() + dt_bias)
    return z, xh, Bm, Cm, dt, new_conv_state


def _mamba_finish(params, cfg, y, z, B_, S):
    d_inner, H, P, N = mamba_dims(cfg)
    y = y * F.silu(z.float()).to(y.dtype)
    y = y.reshape(B_, S, d_inner)
    y = rms_norm(y, params["out_norm"], cfg.norm_eps)
    return torch.matmul(y, params["w_out"])


def mamba_final_state(xdt, Bm, decay) -> torch.Tensor:
    """Closed-form state after the last position:
    h_S = Σ_t (Π_{s>t} a_s) x_t ⊗ B_t. xdt (B, S, H, P) fp32; Bm (B, S, N)
    fp32; decay (B, S, H). Returns (B, H, P, N) fp32."""
    w = _suffix_products(decay.float())                       # (B, S, H)
    xw = (xdt * w[..., None]).permute(0, 2, 3, 1)              # (B, H, P, S)
    return xw @ Bm[:, None]                                    # (B, H, P, N)


def mamba_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                  final_state: bool = False):
    """Full-sequence Mamba2 mixer. x: (B, S, d) -> (B, S, d); with
    ``final_state`` -> (y, {"h", "conv"}), the decode state after x."""
    B_, S, _ = x.shape
    z, xh, Bm, Cm, dt, conv_state = _mamba_project(params, cfg, x)
    decay = torch.exp(-torch.exp(params["a_log"]) * dt)  # (B, S, H)
    xdt = xh.float() * dt[..., None]  # (B, S, H, P)
    Bf = Bm.float().contiguous()
    y = _on_heads(ops.ssm_scan, (xdt, Bf, Cm.float().contiguous(), decay),
                  "bh b b bh")
    y = y + xh.float() * params["d_skip"][None, None, :, None]
    out = _mamba_finish(params, cfg, y.to(x.dtype), z, B_, S)
    if not final_state:
        return out
    h = _on_heads(mamba_final_state, (xdt, Bf, decay), "bh b bh", "s")
    return out, {"h": h, "conv": conv_state}


def init_mamba_state(cfg: ModelConfig, batch: int, device) -> Dict:
    d_inner, H, P, N = mamba_dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=cfg.dtype, device=device),
    }


def mamba_decode_step(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                      state: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d) -> (y (B,1,d), new_state)."""
    B_, S, _ = x.shape
    z, xh, Bm, Cm, dt, conv_state = _mamba_project(
        params, cfg, x, conv_state=state["conv"])
    decay = torch.exp(-torch.exp(params["a_log"]) * dt)  # (B, 1, H)
    h = state["h"] * decay[:, 0, :, None, None] + \
        (xh.float() * dt[..., None])[:, 0, ..., None] * \
        Bm.float()[:, 0, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cm.float()[:, 0])
    y = y[:, None] + xh.float() * params["d_skip"][None, None, :, None]
    out = _mamba_finish(params, cfg, y.to(x.dtype), z, B_, S)
    return out, {"h": h, "conv": conv_state}


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================
def rwkv_dims(cfg: ModelConfig):
    P = cfg.rwkv_head_dim
    H = cfg.d_model // P
    return H, P


_RWKV_MIX = ("r", "k", "v", "w", "g")


def init_rwkv_time_mix(gen: torch.Generator, cfg: ModelConfig, device,
                       dtype=None) -> Dict:
    """Time-mix params; the five ddlerp loras and the four r/k/v/g
    projections are stored fused ((5, d, l) / (4, d, d)), as in the
    reference."""
    dtype = dtype or cfg.dtype
    H, P = rwkv_dims(cfg)
    d = cfg.d_model
    lora = max(32, d // 64)
    n = len(_RWKV_MIX)
    return {
        "mu": torch.zeros((n, d), dtype=dtype, device=device),
        "lora_a": dense_init(gen, (n, d, lora), dtype, device, 0.1),
        "lora_b": dense_init(gen, (n, lora, d), dtype, device, 0.1),
        "w_rkvg": dense_init(gen, (4, d, d), dtype, device),
        "w_o": dense_init(gen, (d, d), dtype, device),
        "decay_base": torch.full((d,), -6.0, dtype=torch.float32,
                                 device=device),
        # small positive bonus so the first token's wkv output is not 0
        "bonus_u": torch.full((H, P), 0.5, dtype=torch.float32,
                              device=device),
        "ln_x": torch.zeros((d,), dtype=dtype, device=device),
    }


def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig, device,
                          dtype=None) -> Dict:
    dtype = dtype or cfg.dtype
    d = cfg.d_model
    return {
        "mu_k": torch.zeros((d,), dtype=dtype, device=device),
        "mu_r": torch.zeros((d,), dtype=dtype, device=device),
        "w_k": dense_init(gen, (d, cfg.d_ff), dtype, device),
        "w_v": dense_init(gen, (cfg.d_ff, d), dtype, device),
        "w_r": dense_init(gen, (d, d), dtype, device),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); last: (B, d) previous token (zeros at start)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix_inputs(params, x, x_prev):
    """Data-dependent lerps for r/k/v/w/g (RWKV6 ddlerp), the five lora
    paths as one stacked einsum. Returns (B, 5, S, d)."""
    if is_placed(x):
        mixed = _time_mix_on_shards(params, x, x_prev)
    else:
        mixed = _time_mix(params["mu"], params["lora_a"], params["lora_b"],
                          x, x_prev)
    # kept in the residual's placement when the launcher installs a
    # constraint (the reference's site)
    return constrain_activation(mixed)


def _time_mix(mu, lora_a, lora_b, x, x_prev):
    xx = x_prev - x
    lora = torch.tanh(torch.einsum("bsd,xdl->bxsl", xx, lora_a))
    mix = mu[None, :, None, :] + torch.einsum("bxsl,xld->bxsd", lora,
                                              lora_b)
    return x[:, None] + xx[:, None] * mix


def _time_mix_on_shards(params, x, x_prev):
    """:func:`_time_mix` of placed (B, S, d) inputs on each rank's rows,
    whole on d, with the small fused lora weights whole (DTensor's rules
    split their stacked 5-dim in the backward, which a later view cannot
    take). The result keeps the batch split, whole on d; the weights'
    gradients from a rank's rows are pending sums over the batch split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    pl = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in x.placements]
    rep = [Replicate()] * mesh.ndim
    wg = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    return local_map(_time_mix, out_placements=pl,
                     in_placements=(rep, rep, rep, pl, pl),
                     in_grad_placements=(wg, wg, wg, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        params["mu"], params["lora_a"], params["lora_b"], x, x_prev)


def _rwkv_rkvwg(params, cfg, x, x_prev):
    H, P = rwkv_dims(cfg)
    B_, S, d = x.shape
    mixed = _time_mix_inputs(params, x, x_prev)
    # fused r/k/v/g projection; _RWKV_MIX order is (r, k, v, w, g): the
    # projected four are 0, 1, 2, 4
    proj = torch.einsum("bxsd,xde->bxse",
                        torch.cat([mixed[:, :3], mixed[:, 4:]], dim=1),
                        params["w_rkvg"])
    r = proj[:, 0].reshape(B_, S, H, P)
    k = proj[:, 1].reshape(B_, S, H, P)
    v = proj[:, 2].reshape(B_, S, H, P)
    g = F.silu(proj[:, 3].float()).to(x.dtype)
    # data-dependent decay w in (0, 1) per channel (the "w" lora on xx)
    wlog = params["decay_base"] + torch.matmul(
        torch.tanh(torch.matmul(x_prev - x, params["lora_a"][3])),
        params["lora_b"][3]).float()
    w = torch.exp(-torch.exp(wlog)).reshape(B_, S, H, P).to(x.dtype)
    return r, k, v, g, w


def _rwkv_out(params, cfg, wkv, g, B_, S):
    d = cfg.d_model
    out = wkv.reshape(B_, S, d)
    out = rms_norm(out, params["ln_x"], cfg.norm_eps)
    out = out * g.reshape(B_, S, d).to(out.dtype)
    return torch.matmul(out, params["w_o"])


def rwkv_final_state(k, v, w) -> torch.Tensor:
    """Closed-form state after the last position:
    S_fin = Σ_t diag(Π_{s>t} w_s) k_t ⊗ v_t. k/v/w (B, S, H, P).
    Returns (B, H, P, P) fp32."""
    kw = (k.float() * _suffix_products(w.float())).permute(0, 2, 3, 1)
    return kw @ v.float().permute(0, 2, 1, 3)          # (B,H,P,S)@(B,H,S,P)


def rwkv_time_mix_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                          *, final_state: bool = False):
    """Full-sequence RWKV6 time-mix. x: (B, S, d) -> (B, S, d); with
    ``final_state`` -> (y, {"S", "x_tm"}), the decode state after x."""
    B_, S, d = x.shape
    x_prev = _token_shift(x, torch.zeros_like(x[:, 0]))
    r, k, v, g, w = _rwkv_rkvwg(params, cfg, x, x_prev)
    r, k, v, w = (a.contiguous() for a in (r, k, v, w))
    wkv = _on_heads(ops.rwkv6_scan, (r, k, v, w, params["bonus_u"]),
                    "bh bh bh bh h").to(x.dtype)
    out = _rwkv_out(params, cfg, wkv, g, B_, S)
    if not final_state:
        return out
    # x_tm a copy: a view of x would keep the layer's whole input alive
    return out, {"S": _on_heads(rwkv_final_state, (k, v, w), "bh bh bh",
                                "s"), "x_tm": x[:, -1].clone()}


def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> Dict:
    H, P = rwkv_dims(cfg)
    return {
        "S": torch.zeros((batch, H, P, P), dtype=torch.float32,
                         device=device),
        "x_tm": torch.zeros((batch, cfg.d_model), dtype=cfg.dtype,
                            device=device),
        "x_cm": torch.zeros((batch, cfg.d_model), dtype=cfg.dtype,
                            device=device),
    }


def rwkv_time_mix_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                         state: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d) single token."""
    B_, S, d = x.shape
    x_prev = state["x_tm"][:, None, :]
    r, k, v, g, w = _rwkv_rkvwg(params, cfg, x, x_prev)
    y, S_new = _on_heads(_rwkv_step, (r[:, 0], k[:, 0], v[:, 0], w[:, 0],
                                      state["S"], params["bonus_u"]),
                         "s s s s s h", "s s")
    out = _rwkv_out(params, cfg, y[:, None].to(x.dtype), g, B_, S)
    new_state = dict(state)
    new_state["S"] = S_new
    new_state["x_tm"] = x[:, 0]
    return out, new_state


def _rwkv_step(r, k, v, w, S, u):
    """One token of the RWKV6 recurrence: r/k/v/w (B, H, P), the state S
    (B, H, P, P) fp32 -> (y (B, H, P), the new state), fp32."""
    r_t, k_t, v_t, w_t = (a.float() for a in (r, k, v, w))
    kv = k_t[..., :, None] * v_t[..., None, :]
    y = torch.einsum("bhp,bhpq->bhq", r_t, S + u[..., None] * kv)
    return y, w_t[..., :, None] * S + kv


def rwkv_channel_mix_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                             last: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d); last: (B, d). Returns (y, new_last)."""
    x_prev = _token_shift(x, last)
    xk = x + (x_prev - x) * params["mu_k"]
    xr = x + (x_prev - x) * params["mu_r"]
    kk = torch.matmul(xk, params["w_k"])
    kk = torch.square(F.relu(kk.float())).to(x.dtype)
    vv = torch.matmul(kk, params["w_v"])
    rr = torch.sigmoid(torch.matmul(xr, params["w_r"]).float())
    return rr.to(x.dtype) * vv, x[:, -1]
