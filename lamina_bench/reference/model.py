"""The reference forward pass of a dense decoder (glm4-9b, pixtral-12b's
text decoder) in float32, layer by layer and in blocks of queries, so
that it fits on the card beside the weights it reads.

The layer, as the configurations' ``departures`` state it: x + attn(norm1
(x)), then + SwiGLU(norm2(x)); RMSNorm in float32 with the scale 1 + w;
q/k/v projections without bias; RoPE on every lane of a head, split-half
(the first and second halves rotate as pairs), base ``rope_theta``; GQA
where query head h reads KV head h // G; softmax at 1/sqrt(hd); causal;
final norm, then the LM head. No logit soft-capping.

A sequence is ``tokens`` at positions ``start`` .. ``start + T - 1``,
after a prefix of ``start`` positions whose K/V (per layer, head-major
(Hkv, start, hd), as a cache holds them, RoPE included) are given. The
logits of ``rows`` come back.

``precision="fp8"`` is the control: every matmul operand (weights per
output channel, activations per row) and the cached K/V rounded to
float8 e4m3 with a scale, the step below the bfloat16 the
configurations state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

Prefix = Callable[[int], Tuple[torch.Tensor, torch.Tensor]]
FP8_MAX = 448.0


@dataclasses.dataclass
class Sequence_:
    tokens: Sequence[int]
    start: int = 0
    prefix: Optional[Prefix] = None     # layer -> (k, v) (Hkv, start, hd)
    rows: Optional[Sequence[int]] = None  # token indices to return logits of


def no_tf32():
    """Matmuls in true float32 (the H100 would otherwise run them as
    TF32, a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (the amax maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (N, k) @ w (k, m) in float32; the control rounds x per row and w
    per output column first."""
    if fp8:
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def _norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        (1.0 + w.float())


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (N, heads, hd) at positions pos (N,)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos.float()[:, None] * freqs                      # (N, hd/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, qpos, kpos, q_block: int) -> torch.Tensor:
    """q (T, H, hd); k, v (S, Hkv, hd); causal by position; blocks of
    ``q_block`` queries. Returns (T, H, hd)."""
    T, H, hd = q.shape
    G = H // k.shape[1]
    kk = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (H, S, hd)
    vv = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for i in range(0, T, q_block):
        qb = q[i:i + q_block].transpose(0, 1) * scale       # (H, t, hd)
        s = qb @ kk.transpose(1, 2)                         # (H, t, S)
        mask = kpos[None, :] <= qpos[i:i + q_block, None]   # (t, S)
        s = s.masked_fill(~mask[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[i:i + q_block] = (p @ vv).transpose(0, 1)
    return out


def forward(weights: Dict, dims: Dict, seqs: List[Sequence_],
            precision: str = "fp32", q_block: int = 512) -> List[torch.Tensor]:
    """The float32 logits (len(rows), vocab) of every sequence. Layer
    outer, sequence inner: each layer's weights are widened to float32
    once for all the sequences."""
    fp8 = precision == "fp8"
    if precision not in ("fp32", "fp8"):
        raise ValueError(f"precision must be fp32 or fp8; got {precision!r}")
    no_tf32()
    lay = weights["layers"]
    dev = weights["embed"].device
    eps, theta = float(dims["norm_eps"]), float(dims["rope_theta"])
    H, Hkv, hd = dims["num_heads"], dims["num_kv_heads"], dims["head_dim"]
    xs, poss = [], []
    for s in seqs:
        ids = torch.as_tensor(list(s.tokens), dtype=torch.long, device=dev)
        xs.append(weights["embed"][ids].float())
        poss.append(torch.arange(s.start, s.start + len(ids), device=dev))
    for layer in range(dims["num_layers"]):
        w = {k: v[layer].float() for k, v in
             (("wq", lay["attn"]["wq"]), ("wk", lay["attn"]["wk"]),
              ("wv", lay["attn"]["wv"]), ("wo", lay["attn"]["wo"]),
              ("w_gate", lay["ffn"]["w_gate"]), ("w_up", lay["ffn"]["w_up"]),
              ("w_down", lay["ffn"]["w_down"]))}
        d = w["wq"].shape[0]
        wq, wk = w["wq"].reshape(d, -1), w["wk"].reshape(d, -1)
        wv, wo = w["wv"].reshape(d, -1), w["wo"].reshape(-1, d)
        for j, s in enumerate(seqs):
            x, pos = xs[j], poss[j]
            h = _norm(x, lay["norm1"][layer], eps)
            q = _rope(_mm(h, wq, fp8).view(-1, H, hd), pos, theta)
            k = _rope(_mm(h, wk, fp8).view(-1, Hkv, hd), pos, theta)
            v = _mm(h, wv, fp8).view(-1, Hkv, hd)
            kpos = pos
            if s.start:
                pk, pv = s.prefix(layer)                    # (Hkv, P, hd)
                k = torch.cat([pk.float().transpose(0, 1), k])
                v = torch.cat([pv.float().transpose(0, 1), v])
                kpos = torch.arange(0, s.start + len(pos), device=dev)
            if fp8:
                q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
            a = _attend(q, k, v, pos, kpos, q_block)
            x = x + _mm(a.reshape(len(pos), -1), wo, fp8)
            h = _norm(x, lay["norm2"][layer], eps)
            g = _mm(h, w["w_gate"], fp8)
            u = _mm(h, w["w_up"], fp8)
            xs[j] = x + _mm(torch.nn.functional.silu(g) * u, w["w_down"],
                            fp8)
        del w, wq, wk, wv, wo
    head = weights["lm_head"].float()
    out = []
    for j, s in enumerate(seqs):
        rows = list(range(len(s.tokens))) if s.rows is None else list(s.rows)
        h = _norm(xs[j][rows], weights["final_norm"], eps)
        out.append(_mm(h, head, fp8))
    return out
