"""Dense oracles the kernels' plain twins are held against.
Port of ``repro/kernels/ref.py`` (the decode references, bf16/fp32 and
int8, and the two recurrent-scan oracles). The reference's int8 oracles replay the Pallas kernels' grid in host loops; the
copies here are vectorised, with the scale multiplies where the reference
puts them (k scale on the scores before the softcap, v scale on the
probabilities before the PV product)."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k_cache, v_cache, cache_len, *,
                         sliding_window: int = 0, attention_sinks: int = 0,
                         logit_softcap: float = 0.0,
                         k_scale=None, v_scale=None) -> torch.Tensor:
    """q: (B, Hkv, G, hd); caches: HEAD-MAJOR (B, Hkv, S, hd); cache_len:
    (B,). Returns (B, Hkv, G, hd). fp32 math throughout.

    int8 caches pass per-token ``k_scale``/``v_scale`` (B, Hkv, S): the k
    scale folds into the scores right after the QK einsum (before softcap),
    the v scale into the probabilities before the PV einsum."""
    B, Hkv, G, hd = q.shape
    S = k_cache.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhgk,bhsk->bhgs", q.float() * scale, k_cache.float())
    if k_scale is not None:
        s = s * k_scale[:, :, None, :].float()
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    clen = cache_len.long()[:, None]
    valid = pos < clen
    if sliding_window > 0:
        in_window = pos >= clen - sliding_window
        if attention_sinks > 0:
            in_window |= pos < attention_sinks
        valid &= in_window
    s = torch.where(valid[:, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :].float()
    out = torch.einsum("bhgs,bhsk->bhgk", p, v_cache.float())
    return out.to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, cache_len, *,
                               sliding_window: int = 0,
                               attention_sinks: int = 0,
                               logit_softcap: float = 0.0) -> torch.Tensor:
    """Oracle for the paged flash-decode kernel: gather the dense head-major
    view through the block table, then the dense oracle math."""
    from repro_torch.kernels.paged_decode_attention import paged_gather_dense

    kc, vc = paged_gather_dense(k_pool, v_pool, block_tables)
    return decode_attention_ref(q, kc, vc, cache_len,
                                sliding_window=sliding_window,
                                attention_sinks=attention_sinks,
                                logit_softcap=logit_softcap)


def paged_decode_attention_int8_ref(q, k_pool, v_pool, k_scale, v_scale,
                                    block_tables, cache_len, *,
                                    block_positions=None,
                                    sliding_window: int = 0,
                                    attention_sinks: int = 0,
                                    logit_softcap: float = 0.0
                                    ) -> torch.Tensor:
    """Oracle for the int8 paged flash-decode kernel. q: (B, Hkv, G, hd);
    k_pool/v_pool: int8 (Hkv, num_blocks, bs, hd); k_scale/v_scale: fp32
    (Hkv, num_blocks, bs); block_tables (B, nb); optional block_positions
    (B, nb) (POS_PAD slots mask out). Returns (B, Hkv, G, hd)."""
    from repro_torch.kernels.paged_decode_attention import (
        default_block_positions, paged_gather_dense, paged_gather_scales)

    B, Hkv, G, hd = q.shape
    bs = k_pool.shape[2]
    nb = block_tables.shape[1]
    if block_positions is None:
        block_positions = default_block_positions(B, nb, bs, q.device)
    kc, vc = paged_gather_dense(k_pool, v_pool, block_tables)
    ks = paged_gather_scales(k_scale, block_tables)
    vs = paged_gather_scales(v_scale, block_tables)
    pos = (block_positions[:, :, None].long() +
           torch.arange(bs, device=q.device)).reshape(B, nb * bs)
    clen = cache_len.long()[:, None]
    valid = pos < clen
    if sliding_window > 0:
        in_window = pos >= clen - sliding_window
        if attention_sinks > 0:
            in_window |= pos < attention_sinks
        valid &= in_window
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bhgk,bhsk->bhgs", q.float() * scale, kc.float())
    s = s * ks[:, :, None, :]
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, -1e30)
    p = torch.where(vmask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    ell = p.sum(dim=-1, keepdim=True)
    v = torch.where(valid[:, None, :, None], vc.float(), 0.0)
    acc = torch.einsum("bhgs,bhsk->bhgk", p * vs[:, :, None, :], v)
    return (acc / ell.clamp_min(1e-30)).to(q.dtype)


def paged_prefill_chunk_attention_int8_ref(q, k_pool, v_pool, k_scale,
                                           v_scale, block_table, k_chunk,
                                           v_chunk, *,
                                           sliding_window: int = 0,
                                           attention_sinks: int = 0,
                                           logit_softcap: float = 0.0
                                           ) -> torch.Tensor:
    """Oracle for the int8 paged chunk-prefill kernel. q: (C, H, hd);
    int8 pools with fp32 scale pools as above; block_table (nb,);
    k_chunk/v_chunk (C, Hkv, hd) full precision (their scale is exactly
    1.0). Returns (C, H, hd)."""
    from repro_torch.kernels.paged_prefill_attention import (
        gather_prefix_dense, gather_prefix_scales)

    C, H, hd = q.shape
    Hkv, _, bs, _ = k_pool.shape
    G = H // Hkv
    P = block_table.shape[0] * bs
    kp, vp = gather_prefix_dense(k_pool, v_pool, block_table)
    one = torch.ones((C, Hkv), dtype=torch.float32, device=q.device)
    ks = torch.cat([gather_prefix_scales(k_scale, block_table), one])
    vs = torch.cat([gather_prefix_scales(v_scale, block_table), one])
    k_all = torch.cat([kp.float(), k_chunk.float()])       # (P+C, Hkv, hd)
    v_all = torch.cat([vp.float(), v_chunk.float()])
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(C, Hkv, G, hd) * scale
    s = torch.einsum("chgd,khd->hgck", qg, k_all)          # (Hkv,G,C,P+C)
    s = s * ks.T[:, None, None, :]
    if logit_softcap > 0.0:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    pos_q = P + torch.arange(C, device=q.device)[:, None]
    pos_k = torch.arange(P + C, device=q.device)[None, :]
    valid = pos_k <= pos_q
    if sliding_window > 0:
        in_window = pos_k > pos_q - sliding_window
        if attention_sinks > 0:
            in_window |= pos_k < attention_sinks
        valid &= in_window
    s = torch.where(valid, s, -1e30)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    ell = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("hgck,khd->hgcd", p * vs.T[:, None, None, :], v_all)
    out = (acc / ell.clamp_min(1e-30)).permute(2, 0, 1, 3)
    return out.reshape(C, H, hd).to(q.dtype)


def rwkv6_scan_ref(r, k, v, w, u) -> torch.Tensor:
    """RWKV6 recurrence oracle (reference ``ref.py:217``).

    r, k, v, w: (B, S, H, P) (w = per-step decay in (0,1), fp32 math);
    u: (H, P) bonus. Returns y: (B, S, H, P), fp32.
      y_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t);  S_t = w_t ⊙ S_{t-1} + k_t ⊗ v_t
    """
    B, S, H, P = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    state = torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B, H, P, P)
        ys.append(torch.einsum("bhp,bhpq->bhq", rf[:, t],
                               state + uf[..., None] * kv))
        state = wf[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1)


def ssm_scan_ref(x, dt, B_in, C_in, decay) -> torch.Tensor:
    """Mamba2 scalar-decay SSD oracle (reference ``ref.py:239``).

    x: (B, S, H, P) (already dt-scaled inputs), dt unused placeholder kept
    for API parity; B_in, C_in: (B, S, N); decay: (B, S, H) in (0,1].
    Returns y: (B, S, H, P) fp32:  h_t = decay_t h_{t-1} + x_t ⊗ B_t;
    y_t = h_t · C_t.
    """
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    xf, bf, cf, af = (a.float() for a in (x, B_in, C_in, decay))
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * af[:, t, :, None, None] + \
            xf[:, t, ..., None] * bf[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1)
