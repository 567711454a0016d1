"""RWKV6 (Finch) recurrence: CUDA kernel wrapper + plain twins.

Port of ``repro/kernels/rwkv6_scan.py``. The TPU kernel ``_rwkv6_kernel``
is replaced by the hand-written Hopper kernel in ``csrc/rwkv6_scan.cu``,
which computes

    y_t = r_t · S + (r_t · (u ⊙ k_t)) v_t ;   S <- diag(w_t) S + k_t ⊗ v_t

with one (P, P) fp32 state per (batch, head) starting at zero, in chunked
form: tiles of ``CHUNK`` steps whose products run on the tensor cores, the
state advancing once per tile. :func:`rwkv6_scan_plain` is its plain twin,
the step loop (the CPU path and the reference the kernel is held to);
:func:`rwkv6_scan_chunked_plain` is a plain PyTorch model of the kernel's
chunked algorithm (same tiles, same decay products), which the CPU tests
hold against the step loop. The TPU wrapper pads the tail with w = 1 to
whole VMEM chunks; the CUDA kernel masks its ragged last tile and needs no
padding.

:func:`rwkv6_scan` dispatches on the device of ``r``: a CPU tensor runs the
plain twin, a CUDA tensor launches the kernel or raises. The wrapper counts
its kernel's launches (``rwkv6_scan.launches``).

The scan is differentiable (a ``torch.autograd.Function``). The reference
differentiates its ``lax.scan`` and has no backward kernel; here the
backward is a second hand-written kernel, ``rwkv6_scan_bwd_{bf16,f32}`` in
the same source, behind :func:`rwkv6_scan_bwd` (CPU tensors: the plain twin
:func:`rwkv6_scan_bwd_plain`; launches counted in
``rwkv6_scan_bwd.launches``). The forward reads the state before the
update, y_t = r_t·S_{t-1} + (r_t·(u⊙k_t)) v_t, so with G_t = ∂L/∂S_t
(G_{S-1} = 0) and ⟨v_t, dy_t⟩ = Σ_q v_t dy_t:

    G_{t-1} = diag(w_t) G_t + r_t ⊗ dy_t
    dr_t = S_{t-1} dy_t + u ⊙ k_t ⟨v_t, dy_t⟩
    dk_t = G_t v_t + r_t ⊙ u ⟨v_t, dy_t⟩
    dv_t = G_tᵀ k_t + (r_t·(u⊙k_t)) dy_t
    dw_t = Σ_q G_t ⊙ S_{t-1} ;  du = Σ_{b,t} r_t ⊙ k_t ⟨v_t, dy_t⟩

The backward kernel is chunked on the forward's ``CHUNK``-step tiles:
pass 1 advances the state tile by tile on the tensor cores and keeps the
state before each tile; pass 2 walks the tiles in reverse, advancing the
adjoint tile by tile, and computes each tile's gradients from products
with that state and the incoming adjoint (tensor cores) plus the in-tile
terms of dr, dk and dw, whose decays are per channel, in fp32 on the
CUDA cores. dw is ``Σ_q G_t ⊙ S_{t-1}`` expanded over the tile into four
terms whose decay factors are running products of factors in [0, 1]: no
decay is ever divided out (bf16 decays round to exactly 0 and 1.0).
:func:`rwkv6_scan_bwd_chunked_plain` is that algorithm in plain PyTorch,
which the CPU tests hold against the step twin and ``jax.grad``; on the
card the kernel is held against :func:`rwkv6_scan_bwd_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ssm_scan import CHUNK, segment_products

_LIB_NAME = "rwkv6_scan"
HEAD_SIZES = (32, 64)                  # P the kernel is instantiated for
_ENTRIES = {torch.bfloat16: "rwkv6_scan_bf16", torch.float32: "rwkv6_scan_f32"}
_BWD_ENTRIES = {torch.bfloat16: "rwkv6_scan_bwd_bf16",
                torch.float32: "rwkv6_scan_bwd_f32"}


def rwkv6_scan_plain(r, k, v, w, u) -> torch.Tensor:
    """Plain twin: r/k/v/w (B, S, H, P), u (H, P); returns y (B, S, H, P)
    fp32. fp32 math, one step per position."""
    B, S, H, P = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    state = torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=r.device)
    for t in range(S):
        r_t, k_t, v_t = rf[:, t], kf[:, t], vf[:, t]
        bonus = (r_t * uf * k_t).sum(-1, keepdim=True)          # (B, H, 1)
        y[:, t] = (r_t[:, :, None, :] @ state)[:, :, 0] + bonus * v_t
        state = wf[:, t, :, :, None] * state + \
            k_t[:, :, :, None] * v_t[:, :, None, :]
    return y


def rwkv6_scan_chunked_plain(r, k, v, w, u, chunk: int = CHUNK,
                             return_state: bool = False):
    """The kernel's chunked algorithm in plain PyTorch (fp32): per tile of
    ``chunk`` steps starting at b, with E(s, t) = Π_{s<m<t} w_m (a vector
    over the key channel),

        y_t = (r_t ⊙ E(b-1, t)) · S_b + Σ_{b≤s<t} G[t, s] v_s
              + (r_t · (u ⊙ k_t)) v_t,   G[t, s] = Σ_p r_t k_s E(s, t)
        S_end = diag(Π_tile w) S_b + Σ_s (k_s ⊙ E(s, end+1)) ⊗ v_s

    Same shapes as :func:`rwkv6_scan_plain`; with ``return_state`` also the
    state after the last step, (B, H, P, P)."""
    B, S, H, P = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    state = torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=r.device)
    for b0 in range(0, S, chunk):
        rc, kc, vc, wc = (a[:, b0:b0 + chunk] for a in (rf, kf, vf, wf))
        D = segment_products(wc)                     # Π_{s<m≤t}: (B, n, n, H, P)
        E = torch.zeros_like(D)                      # Π_{s<m<t}, 0 for s ≥ t
        E[:, 1:] = D[:, :-1]
        ones = torch.ones_like(wc[:, :1])
        r_t = rc * torch.cumprod(torch.cat([ones, wc[:, :-1]], 1), dim=1)
        k_t = kc * D[:, -1]                          # Π_{s<m≤end}
        G = torch.einsum("bthp,bshp,btshp->bhts", rc, kc, E) + \
            torch.diag_embed(torch.einsum("bthp,hp,bthp->bht", rc, uf, kc))
        y[:, b0:b0 + chunk] = (
            torch.einsum("bthp,bhpq->bthq", r_t, state) +
            torch.einsum("bhts,bshq->bthq", G, vc))
        state = state * torch.prod(wc, dim=1)[..., None] + torch.einsum(
            "bshp,bshq->bhpq", k_t, vc)
    return (y, state) if return_state else y


def _check_operands(r, u, operands) -> None:
    B, S, H, P = r.shape
    if r.dtype not in _ENTRIES:
        raise TypeError(f"r/k/v/w must be bfloat16 or float32 on the GPU; "
                        f"got {r.dtype}")
    for name, t, shape, dtype in (("r", r, (B, S, H, P), r.dtype),
                                  ("u", u, (H, P), torch.float32),
                                  *operands):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype} on the GPU; got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if P not in HEAD_SIZES:
        raise ValueError(f"kernel instantiated for P in {HEAD_SIZES}; "
                         f"got P={P}")


def _rwkv6_scan_forward(r, k, v, w, u) -> torch.Tensor:
    """The forward's dispatch: the plain twin on the CPU, the kernel on the
    card (counted in ``rwkv6_scan.launches``)."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"no rwkv6_scan kernel for device {r.device}")
    B, S, H, P = r.shape
    _check_operands(r, u, [(n, t, (B, S, H, P), r.dtype)
                           for n, t in (("k", k), ("v", v), ("w", w))])
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=r.device)
    if _cuda.is_fake(r):                 # a shape-only trace's face
        _cuda.account(_ENTRIES[r.dtype], *cost(r))
        return y
    if S:
        entry = _ENTRIES[r.dtype]
        err = _kernel_fn(entry)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                w.data_ptr(), u.data_ptr(), y.data_ptr(), B,
                                S, H, P, _cuda.stream_ptr(r.device))
        _cuda.check(err, entry)
        rwkv6_scan.launches += 1
        if _cuda.ACCOUNTANTS:
            _cuda.account(entry, *cost(r))
    return y


def cost(r, backward: bool = False):
    """(FLOPs, bytes) of one call from shapes alone. FLOPs: the recurrence's
    5·P² a step and head (the reference's per-step accounting,
    ``launch/analytic.py`` ``recurrence_corrections``), twice that for the
    backward; bytes by the kernel table's bound rule (inputs read once,
    outputs written once)."""
    B, S, H, P = r.shape
    e = r.element_size()
    flops = 5 * B * S * H * P * P * (2 if backward else 1)
    if backward:     # r, k, v, w, dr, dk, dv, dw; dy; u, du
        return flops, e * 8 * r.numel() + 4 * r.numel() + 4 * 2 * H * P
    return flops, e * 4 * r.numel() + 4 * H * P + 4 * r.numel()


class _Rwkv6Scan(torch.autograd.Function):
    """y = rwkv6(r, k, v, w, u) with the hand-written backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        return _rwkv6_scan_forward(r, k, v, w, u)

    @staticmethod
    def backward(ctx, dy):
        r, k, v, w, u = ctx.saved_tensors
        grads = rwkv6_scan_bwd(r, k, v, w, u, dy.contiguous())
        return tuple(g.to(t.dtype) for g, t in zip(grads, (r, k, v, w, u)))


def rwkv6_scan(r, k, v, w, u) -> torch.Tensor:
    """r/k/v/w: (B, S, H, P) in the model dtype (w the per-step decay in
    [0, 1]); u: (H, P) bonus. Returns y: (B, S, H, P) fp32, differentiable
    in all five inputs.

    CPU tensors run :func:`rwkv6_scan_plain`; CUDA tensors launch
    ``csrc/rwkv6_scan.cu`` (r/k/v/w all bf16 or all fp32 and u fp32,
    contiguous; P in ``HEAD_SIZES``) or raise. The backward is
    :func:`rwkv6_scan_bwd`."""
    return _Rwkv6Scan.apply(r, k, v, w, u)


rwkv6_scan.launches = 0


def rwkv6_scan_bwd_plain(r, k, v, w, u, dy):
    """Plain twin of the backward: (dr, dk, dv, dw (B, S, H, P), du (H,
    P)), all fp32, for y's gradient dy (B, S, H, P). An fp32 step loop in
    two passes: the forward, keeping the state before every tile of
    ``CHUNK`` steps; then the tiles in reverse, each recomputing its states
    from its boundary and running the adjoint recurrence (module docstring)
    back through them."""
    chunk = CHUNK
    B, S, H, P = r.shape
    rf, kf, vf, wf, gy = (a.float() for a in (r, k, v, w, dy))
    uf = u.float()
    dev = r.device
    state = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
    bounds = []
    for t in range(S):
        if t % chunk == 0:
            bounds.append(state)
        state = wf[:, t, :, :, None] * state + \
            kf[:, t, :, :, None] * vf[:, t, :, None, :]
    grads = [torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((H, P), dtype=torch.float32, device=dev)
    G = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
    for c in reversed(range(len(bounds))):
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        prev = [bounds[c]]                               # S_{t0-1}, ...
        for t in range(t0, t1 - 1):
            prev.append(wf[:, t, :, :, None] * prev[-1] +
                        kf[:, t, :, :, None] * vf[:, t, :, None, :])
        for t in reversed(range(t0, t1)):
            r_t, k_t, v_t, w_t, dy_t = (a[:, t] for a in (rf, kf, vf, wf,
                                                          gy))
            s_prev = prev[t - t0]
            vdy = (v_t * dy_t).sum(-1, keepdim=True)            # (B, H, 1)
            dr[:, t] = (s_prev @ dy_t[..., None])[..., 0] + uf * k_t * vdy
            dk[:, t] = (G @ v_t[..., None])[..., 0] + r_t * uf * vdy
            dv[:, t] = (G.transpose(-1, -2) @ k_t[..., None])[..., 0] + \
                (r_t * uf * k_t).sum(-1, keepdim=True) * dy_t
            dw[:, t] = (G * s_prev).sum(-1)
            du += (r_t * k_t * vdy).sum(0)
            G = w_t[..., None] * G + r_t[..., None] * dy_t[:, :, None, :]
    return dr, dk, dv, dw, du


def rwkv6_scan_bwd_chunked_plain(r, k, v, w, u, dy):
    """The backward kernel's chunked algorithm in plain PyTorch (fp32); the
    same outputs as :func:`rwkv6_scan_bwd_plain`. Pass 1 advances the state
    tile by tile, keeping the state ``S0 = S_{b-1}`` before each tile [b,
    e]; pass 2 walks the tiles in reverse with the incoming adjoint ``Gc =
    G_e``. With E(s, t) = Π_{s<m<t} w_m (a vector over the key channel p),
    pre(t) = E(b-1, t), F(t) = E(t, e+1), A[s, s'] = dy_s·v_{s'} and
    c_t = A[t, t] = ⟨v_t, dy_t⟩:

        dr_t = pre(t) ⊙ S0 dy_t + Σ_{s<t} A[t, s] E(s, t) ⊙ k_s + u⊙k_t c_t
        dk_t = F(t) ⊙ Gc v_t + Σ_{s>t} A[s, t] E(t, s) ⊙ r_s + r_t⊙u c_t
        dv_t = (k_t ⊙ F(t)) Gc + Σ_{s≥t} Gf[s, t] dy_s
        with Gf the forward's score matrix (u bonus on its diagonal)
        Gc <- diag(pre(e+1)) Gc + Σ_s (r_s ⊙ pre(s)) ⊗ dy_s

    and dw_t = Σ_q G_t ⊙ S_{t-1} expanded over the tile per channel p into
    four terms, no decay ever divided out:

        F(t) pre(t) Σ_q Gc ⊙ S0
        + F(t) Σ_{s'<t} E(s', t) k_{s'} (Gc v_{s'})
        + pre(t) Σ_{s>t} E(t, s) r_s (S0 dy_s)
        + Σ_{s>t>s'} E(t, s) E(s', t) r_s k_{s'} A[s, s']"""
    B, S, H, P = r.shape
    rf, kf, vf, wf, gy = (a.float() for a in (r, k, v, w, dy))
    uf = u.float()
    dev = r.device
    state = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
    bounds = []
    for b0 in range(0, S, CHUNK):
        bounds.append(state)
        kc, vc, wc = (a[:, b0:b0 + CHUNK] for a in (kf, vf, wf))
        D = segment_products(wc)
        state = state * torch.cumprod(wc, dim=1)[:, -1, ..., None] + \
            torch.einsum("bshp,bshq->bhpq", kc * D[:, -1], vc)
    grads = [torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((H, P), dtype=torch.float32, device=dev)
    Gc = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
    for c in reversed(range(len(bounds))):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        S0 = bounds[c]
        rc, kc, vc, wc, gc = (a[:, sl] for a in (rf, kf, vf, wf, gy))
        D = segment_products(wc)                     # Π_{s<m≤t} at [t, s]
        E = torch.zeros_like(D)                      # E(s, t) at [t, s], s < t
        E[:, 1:] = D[:, :-1]
        pre = torch.cumprod(torch.cat([torch.ones_like(wc[:, :1]),
                                       wc[:, :-1]], 1), dim=1)
        F = D[:, -1]
        A = torch.einsum("bshq,buhq->bhsu", gc, vc)
        ct = torch.diagonal(A, dim1=-2, dim2=-1).permute(0, 2, 1)[..., None]
        drc = torch.einsum("bhpq,bthq->bthp", S0, gc)    # (S0 dy_t)[p]
        dkc = torch.einsum("bhpq,bthq->bthp", Gc, vc)    # (Gc v_t)[p]
        dr[:, sl] = pre * drc + torch.einsum("bhts,btshp,bshp->bthp", A, E,
                                             kc) + uf * kc * ct
        dk[:, sl] = F * dkc + torch.einsum("bhst,bsthp,bshp->bthp", A, E,
                                           rc) + rc * uf * ct
        Gf = torch.einsum("bshp,bthp,bsthp->bhst", rc, kc, E) + \
            torch.diag_embed(torch.einsum("bthp,hp,bthp->bht", rc, uf, kc))
        dv[:, sl] = torch.einsum("bthp,bhpq->bthq", kc * F, Gc) + \
            torch.einsum("bhst,bshq->bthq", Gf, gc)
        dw[:, sl] = (
            F * pre * (Gc * S0).sum(-1)[:, None] +
            F * torch.einsum("btuhp,buhp->bthp", E, kc * dkc) +
            pre * torch.einsum("bsthp,bshp->bthp", E, rc * drc) +
            torch.einsum("bsthp,btuhp,bshp,buhp,bhsu->bthp", E, E, rc, kc,
                         A))
        du += (rc * kc * ct).sum((0, 1))
        Gc = Gc * torch.cumprod(wc, dim=1)[:, -1, ..., None] + torch.einsum(
            "bshp,bshq->bhpq", rc * pre, gc)
    return dr, dk, dv, dw, du


def rwkv6_scan_bwd(r, k, v, w, u, dy):
    """Gradients (dr, dk, dv, dw, du) of :func:`rwkv6_scan` for dy (B, S,
    H, P) fp32: on the CPU the plain twin's (fp32); on the card
    ``rwkv6_scan_bwd_{bf16,f32}`` computes in fp32 and writes dr/dk/dv/dw
    in the inputs' dtype and du in fp32 (the forward's operand rules; dy
    fp32 and contiguous) or raises.

    The kernel's scratch, one fp32 buffer from the caching allocator of
    the size ``rwkv6_scan_bwd_scratch_floats`` gives (the kernel source
    defines its layout): the state before every tile of every CTA and the
    per-CTA partials of du, which a last launch sums in a fixed order
    (deterministic; no atomics)."""
    if r.device.type == "cpu":
        return rwkv6_scan_bwd_plain(r, k, v, w, u, dy)
    if r.device.type != "cuda":
        raise ValueError(f"no rwkv6_scan_bwd kernel for device {r.device}")
    B, S, H, P = r.shape
    _check_operands(r, u, [*((n, t, (B, S, H, P), r.dtype)
                             for n, t in (("k", k), ("v", v), ("w", w))),
                           ("dy", dy, (B, S, H, P), torch.float32)])
    dr, dk, dv, dw = (torch.empty((B, S, H, P), dtype=r.dtype,
                                  device=r.device) for _ in range(4))
    du = torch.empty((H, P), dtype=torch.float32, device=r.device)
    if S:
        n = _scratch_fn()(B, S, H, P)
        scratch = torch.empty(n, dtype=torch.float32, device=r.device)
        entry = _BWD_ENTRIES[r.dtype]
        if _cuda.is_fake(r):             # a shape-only trace's face
            _cuda.account(entry, *cost(r, True))
            return dr, dk, dv, dw, du
        err = _bwd_fn(entry)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                             w.data_ptr(), u.data_ptr(), dy.data_ptr(),
                             dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             dw.data_ptr(), du.data_ptr(), scratch.data_ptr(),
                             n, B, S, H, P, _cuda.stream_ptr(r.device))
        _cuda.check(err, entry)
        rwkv6_scan_bwd.launches += 1
        if _cuda.ACCOUNTANTS:
            _cuda.account(entry, *cost(r, True))
    else:
        du.zero_()
    return dr, dk, dv, dw, du


rwkv6_scan_bwd.launches = 0


def bwd_design(B: int, S: int, H: int, P: int, dtype) -> dict:
    """The backward kernel's launches at these sizes on the current card
    (``rwkv6_scan_bwd_design``, the ``dtype`` entry's kernels): warps a
    CTA, CTAs, dynamic shared bytes a CTA and the CTAs an SM holds (the
    occupancy query) of pass 2 and of pass 1, and the scratch bytes of the
    tile-boundary states and of the per-CTA partials of du."""
    out = (ctypes.c_int64 * 7)()
    fn = _cuda.load(_LIB_NAME).rwkv6_scan_bwd_design
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.check(fn(B, S, H, P, int(dtype == torch.bfloat16),
                   ctypes.addressof(out)), "rwkv6_scan_bwd_design")
    floats = _scratch_fn()(B, S, H, P)
    return dict(warps=out[0], ctas=out[1], smem_bytes=out[2],
                ctas_per_sm=out[3], pass1_smem_bytes=out[5],
                pass1_ctas_per_sm=out[6], state_bytes=4 * out[4],
                partial_bytes=4 * (floats - out[4]))


def _kernel_fn(entry: str):
    fn = getattr(_cuda.load(_LIB_NAME), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn(entry: str):
    fn = getattr(_cuda.load(_LIB_NAME), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int64] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _scratch_fn():
    fn = _cuda.load(_LIB_NAME).rwkv6_scan_bwd_scratch_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int64
    return fn
