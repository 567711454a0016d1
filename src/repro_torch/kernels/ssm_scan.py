"""Mamba2 scalar-decay selective scan: CUDA kernel wrapper + plain twins.

Port of ``repro/kernels/ssm_scan.py``. The TPU kernel ``_ssm_kernel`` is
replaced by the hand-written Hopper kernel in ``csrc/ssm_scan.cu``, which
computes

    h_t = decay_t ⊙ h_{t-1} + x_t ⊗ B_t ;   y_t = h_t · C_t

with the (H, P, N) fp32 state starting at zero, in chunked (SSD) form: tiles
of ``CHUNK`` steps whose products run on the tensor cores, the state
advancing once per tile. :func:`ssm_scan_plain` is its plain twin, the step
loop (the CPU path and the reference the kernel is held to);
:func:`ssm_scan_chunked_plain` is a plain PyTorch model of the kernel's
chunked algorithm (same tiles, same decay products), which the CPU tests
hold against the step loop. The TPU wrapper pads the sequence with decay 1.0
to whole VMEM chunks; the CUDA kernel masks its ragged last tile and needs
no padding.

:func:`ssm_scan` dispatches on the device of ``x``: a CPU tensor runs the
plain twin, a CUDA tensor launches the kernel or raises. The wrapper counts
its kernel's launches (``ssm_scan.launches``).

The scan is differentiable (a ``torch.autograd.Function``). The reference
differentiates its ``lax.scan`` and has no backward kernel; here the
backward is a second hand-written kernel, ``ssm_scan_bwd_f32`` in the same
source, behind :func:`ssm_scan_bwd` (CPU tensors: the plain twin
:func:`ssm_scan_bwd_plain`; launches counted in ``ssm_scan_bwd.launches``).
With ``g_t = ∂L/∂h_t``:

    g_t = decay_{t+1} g_{t+1} + dy_t ⊗ C_t
    dx_t = g_t B_t ;  dB_t = Σ_{h,p} g_t x_t ;  dC_t = Σ_{h,p} h_t dy_t
    ddecay_t = Σ_{p,n} g_t ⊙ h_{t-1}

The backward kernel is chunked on the forward's ``CHUNK``-step tiles:
pass 1 advances the state tile by tile on the tensor cores and keeps the
state before each tile; pass 2 walks the tiles in reverse, advancing the
adjoint tile by tile, and computes each tile's dx, dB, dC from products
of the tile's operands with that state and the incoming adjoint. ddecay
is ``⟨g_t, h_{t-1}⟩`` expanded over the tile into four terms whose decay
factors are running products of factors in [0, 1]: no decay is ever
divided out (a decay may be exactly 0).
:func:`ssm_scan_bwd_chunked_plain` is that algorithm in plain PyTorch,
which the CPU tests hold against the step twin and ``jax.grad``; on the
card the kernel is held against :func:`ssm_scan_bwd_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda

_LIB_NAME = "ssm_scan"
STATE_SIZES = (16, 32, 64, 128)        # N the kernel is instantiated for
CHUNK = 16                             # the kernels' tile: steps per state update


def ssm_scan_plain(x, B_in, C_in, decay) -> torch.Tensor:
    """Plain twin: x (B, S, H, P), B_in/C_in (B, S, N), decay (B, S, H);
    returns y (B, S, H, P) fp32. fp32 math, one step per position."""
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    xf, bf, cf, af = (a.float() for a in (x, B_in, C_in, decay))
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    for t in range(S):
        h = h * af[:, t, :, None, None] + \
            xf[:, t, :, :, None] * bf[:, t, None, None, :]
        y[:, t] = (h @ cf[:, t, None, :, None])[..., 0]
    return y


def segment_products(a: torch.Tensor) -> torch.Tensor:
    """a: (B, n, ...) -> D (B, n, n, ...) with D[:, t, s] = Π_{s<m≤t} a_m
    for s ≤ t (1 on the diagonal) and 0 above it. A running product of
    factors in [0, 1] down each column, never a ratio or an exp of log
    differences: a decay of exactly 0 gives 0, not NaN."""
    n = a.shape[1]
    lower = torch.ones((n, n), dtype=torch.bool, device=a.device).tril(-1)
    lower = lower.view((1, n, n) + (1,) * (a.dim() - 2))
    factors = torch.where(lower, a[:, :, None], torch.ones_like(a[:, :, None]))
    return torch.cumprod(factors, dim=1) * lower.logical_or(
        torch.eye(n, dtype=torch.bool, device=a.device).view(lower.shape))


def ssm_scan_chunked_plain(x, B_in, C_in, decay, chunk: int = CHUNK,
                           return_state: bool = False):
    """The kernel's chunked algorithm in plain PyTorch (fp32): per tile of
    ``chunk`` steps starting at b, with D(s, t) = Π_{s<m≤t} decay_m,

        y_t = D(b-1, t) (h_{b-1} · C_t) + Σ_{b≤s≤t} (C_t·B_s) D(s, t) x_s
        h_end = D(b-1, end) h_{b-1} + Σ_s D(s, end) x_s ⊗ B_s

    Same shapes as :func:`ssm_scan_plain`; with ``return_state`` also the
    state after the last step, (B, H, P, N)."""
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    xf, bf, cf, af = (a.float() for a in (x, B_in, C_in, decay))
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    for b0 in range(0, S, chunk):
        xc, bc, cc = xf[:, b0:b0 + chunk], bf[:, b0:b0 + chunk], \
            cf[:, b0:b0 + chunk]
        ac = af[:, b0:b0 + chunk]                                # (B, n, H)
        D = segment_products(ac)                                 # (B, n, n, H)
        pre = torch.cumprod(ac, dim=1)                           # D(b-1, t)
        suf = D[:, -1]                                           # D(s, end)
        G = torch.einsum("btn,bsn->bts", cc, bc)[..., None] * D
        y[:, b0:b0 + chunk] = (
            torch.einsum("bhpn,btn->bthp", h, cc) * pre[..., None] +
            torch.einsum("btsh,bshp->bthp", G, xc))
        h = h * pre[:, -1, :, None, None] + torch.einsum(
            "bshp,bsn->bhpn", xc * suf[..., None], bc)
    return (y, h) if return_state else y


def _ssm_scan_forward(x, B_in, C_in, decay) -> torch.Tensor:
    """The forward's dispatch: the plain twin on the CPU, the kernel on the
    card (counted in ``ssm_scan.launches``)."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, B_in, C_in, decay)
    if x.device.type != "cuda":
        raise ValueError(f"no ssm_scan kernel for device {x.device}")
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    _check_operands(x, (("x", x, (Bb, S, H, P)), ("B_in", B_in, (Bb, S, N)),
                        ("C_in", C_in, (Bb, S, N)),
                        ("decay", decay, (Bb, S, H))))
    _check_shape(P, N)
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=x.device)
    if _cuda.is_fake(x):                 # a shape-only trace's face
        _cuda.account("ssm_scan_f32", *cost(x, B_in))
        return y
    if S:
        err = _kernel_fn()(x.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
                           decay.data_ptr(), y.data_ptr(), Bb, S, H, P, N,
                           _cuda.stream_ptr(x.device))
        _cuda.check(err, "ssm_scan_f32")
        ssm_scan.launches += 1
        if _cuda.ACCOUNTANTS:
            _cuda.account("ssm_scan_f32", *cost(x, B_in))
    return y


def cost(x, B_in, backward: bool = False):
    """(FLOPs, bytes) of one call from shapes alone. FLOPs: the recurrence's
    5·P·N a step and head (the reference's per-step accounting,
    ``launch/analytic.py`` ``recurrence_corrections``), twice that for the
    backward; bytes by the kernel table's bound rule (fp32 inputs read
    once, outputs written once)."""
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    flops = 5 * Bb * S * H * P * N * (2 if backward else 1)
    if backward:     # x, dy, dx; B, C, dB, dC; decay, ddecay
        return flops, 4 * (3 * x.numel() + 4 * B_in.numel() + 2 * Bb * S * H)
    return flops, 4 * (2 * x.numel() + 2 * B_in.numel() + Bb * S * H)


def _check_operands(x, operands) -> None:
    for name, t, shape in operands:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the GPU; got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_shape(P: int, N: int) -> None:
    if P % 8 or not 8 <= P <= 256 or N not in STATE_SIZES:
        raise ValueError(f"kernel instantiated for P a multiple of 8 in "
                         f"[8, 256] and N in {STATE_SIZES}; got P={P}, N={N}")


class _SsmScan(torch.autograd.Function):
    """y = scan(x, B, C, decay) with the hand-written backward."""

    @staticmethod
    def forward(ctx, x, B_in, C_in, decay):
        ctx.save_for_backward(x, B_in, C_in, decay)
        return _ssm_scan_forward(x, B_in, C_in, decay)

    @staticmethod
    def backward(ctx, dy):
        x, B_in, C_in, decay = ctx.saved_tensors
        grads = ssm_scan_bwd(x, B_in, C_in, decay, dy.contiguous())
        return tuple(g.to(t.dtype) for g, t in
                     zip(grads, (x, B_in, C_in, decay)))


def ssm_scan(x, B_in, C_in, decay) -> torch.Tensor:
    """x: (B, S, H, P) dt-scaled inputs; B_in/C_in: (B, S, N) (shared by
    every head); decay: (B, S, H) in [0, 1]. Returns y: (B, S, H, P) fp32,
    differentiable in all four inputs.

    CPU tensors run :func:`ssm_scan_plain`; CUDA tensors launch
    ``csrc/ssm_scan.cu`` (fp32, contiguous; P a multiple of 8 up to 256,
    N in ``STATE_SIZES``) or raise. The backward is :func:`ssm_scan_bwd`."""
    return _SsmScan.apply(x, B_in, C_in, decay)


ssm_scan.launches = 0


def ssm_scan_bwd_plain(x, B_in, C_in, decay, dy):
    """Plain twin of the backward: (dx (B, S, H, P), dB (B, S, N), dC (B,
    S, N), ddecay (B, S, H)), all fp32, for y's gradient dy (B, S, H, P).
    An fp32 step loop in two passes: the forward, keeping the state before
    every tile of ``CHUNK`` steps; then the tiles in reverse, each
    recomputing its states from its boundary and running the adjoint
    recurrence (module docstring) back through them. The values do not
    depend on the tile, which only bounds the states held at once."""
    chunk = CHUNK
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    xf, bf, cf, af, gy = (a.float() for a in (x, B_in, C_in, decay, dy))
    dev = x.device
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=dev)
    bounds = []
    for t in range(S):
        if t % chunk == 0:
            bounds.append(h)
        h = h * af[:, t, :, None, None] + \
            xf[:, t, :, :, None] * bf[:, t, None, None, :]
    dx = torch.empty((Bb, S, H, P), dtype=torch.float32, device=dev)
    dB = torch.empty((Bb, S, N), dtype=torch.float32, device=dev)
    dC = torch.empty((Bb, S, N), dtype=torch.float32, device=dev)
    dd = torch.empty((Bb, S, H), dtype=torch.float32, device=dev)
    g = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=dev)
    a_next = torch.zeros((Bb, H), dtype=torch.float32, device=dev)
    for c in reversed(range(len(bounds))):
        t0, t1 = c * chunk, min(S, (c + 1) * chunk)
        hs = [bounds[c]]                                 # h_{t0-1}, ...
        for t in range(t0, t1):
            hs.append(hs[-1] * af[:, t, :, None, None] +
                      xf[:, t, :, :, None] * bf[:, t, None, None, :])
        for t in reversed(range(t0, t1)):
            g = g * a_next[:, :, None, None] + \
                gy[:, t, :, :, None] * cf[:, t, None, None, :]
            dx[:, t] = (g @ bf[:, t, None, :, None])[..., 0]
            dB[:, t] = torch.einsum("bhpn,bhp->bn", g, xf[:, t])
            dC[:, t] = torch.einsum("bhpn,bhp->bn", hs[t - t0 + 1], gy[:, t])
            dd[:, t] = (g * hs[t - t0]).sum(dim=(-2, -1))
            a_next = af[:, t]
    return dx, dB, dC, dd


def ssm_scan_bwd_chunked_plain(x, B_in, C_in, decay, dy):
    """The backward kernel's chunked algorithm in plain PyTorch (fp32); the
    same outputs as :func:`ssm_scan_bwd_plain`. Pass 1 advances the state
    tile by tile, keeping the state ``H0 = h_{b-1}`` before each tile [b,
    e]; pass 2 walks the tiles in reverse with the incoming adjoint
    ``Gc = decay_{e+1} g_{e+1}``. With D(s, t) = Π_{s<m≤t} decay_m,
    pre(t) = D(b-1, t) and suf(t) = D(t, e), per head:

        dx_t = suf(t) Gc B_t + Σ_{s≥t} (C_s·B_t) D(t, s) dy_s
        dB_t = Σ_h suf(t) x_t Gc + Σ_{s≥t} V[s, t] C_s
        dC_t = Σ_h pre(t) dy_t H0 + Σ_{s≤t} V[t, s] B_s
        with V[t, s] = (dy_t·x_s) D(s, t)
        Gc <- pre(e) Gc + Σ_s pre(s) dy_s ⊗ C_s   (the previous tile's)

    and ddecay_t = ⟨g_t, h_{t-1}⟩ expanded over the tile into four terms,
    no decay ever divided out:

        suf(t) pre(t-1) ⟨Gc, H0⟩
        + suf(t) Σ_{s'<t} D(s', t-1) q1[s'],   q1[s] = x_s · (Gc B_s)
        + pre(t-1) Σ_{s≥t} D(t, s) q2[s],      q2[s] = dy_s · (H0 C_s)
        + Σ_{s≥t>s'} D(t, s) D(s', t-1) (dy_s·x_{s'}) (C_s·B_{s'})"""
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    xf, bf, cf, af, gy = (a.float() for a in (x, B_in, C_in, decay, dy))
    dev = x.device
    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=dev)
    bounds = []
    for b0 in range(0, S, CHUNK):
        bounds.append(h)
        xc, bc, ac = (a[:, b0:b0 + CHUNK] for a in (xf, bf, af))
        D = segment_products(ac)
        h = h * torch.cumprod(ac, dim=1)[:, -1, :, None, None] + \
            torch.einsum("bshp,bsn->bhpn", xc * D[:, -1, :, :, None], bc)
    dx = torch.empty((Bb, S, H, P), dtype=torch.float32, device=dev)
    dB = torch.empty((Bb, S, N), dtype=torch.float32, device=dev)
    dC = torch.empty((Bb, S, N), dtype=torch.float32, device=dev)
    dd = torch.empty((Bb, S, H), dtype=torch.float32, device=dev)
    Gc = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=dev)
    for c in reversed(range(len(bounds))):
        b0 = c * CHUNK
        sl = slice(b0, b0 + CHUNK)
        H0 = bounds[c]
        xc, bc, cc, ac, gc = xf[:, sl], bf[:, sl], cf[:, sl], af[:, sl], gy[:, sl]
        n = ac.shape[1]
        D = segment_products(ac)                         # [t, s] = D(s, t)
        pre = torch.cumprod(ac, dim=1)                   # D(b-1, t)
        prem1 = torch.cat([torch.ones_like(pre[:, :1]), pre[:, :-1]], 1)
        suf = D[:, -1]                                   # D(t, e)
        Dm1 = torch.zeros_like(D)                        # [t, s'] = D(s', t-1)
        Dm1[:, 1:] = D[:, :-1]
        CB = torch.einsum("btn,bsn->bts", cc, bc)
        dyx = torch.einsum("bthp,bshp->bhts", gc, xc)    # dy_t · x_s
        V = dyx * D.permute(0, 3, 1, 2)
        dxc = torch.einsum("bhpn,bsn->bshp", Gc, bc)     # (Gc B_s)[p]
        dx[:, sl] = dxc * suf[..., None] + torch.einsum(
            "bts,btsh,bthp->bshp", CB, D, gc)
        dB[:, sl] = torch.einsum("bthp,bhpn->btn", xc * suf[..., None], Gc) \
            + torch.einsum("bhst,bsn->btn", V, cc)
        dC[:, sl] = torch.einsum("bthp,bhpn->btn", gc * pre[..., None], H0) \
            + torch.einsum("bhts,bsn->btn", V, bc)
        q1 = (xc * dxc).sum(-1)                                     # (B, n, H)
        q2 = (gc * torch.einsum("bhpn,btn->bthp", H0, cc)).sum(-1)
        M4 = dyx * CB[:, None]                                      # [s, s']
        dd[:, sl] = (
            suf * prem1 * (Gc * H0).sum((-2, -1))[:, None] +
            suf * torch.einsum("btuh,buh->bth", Dm1, q1) +
            prem1 * torch.einsum("bsth,bsh->bth", D, q2) +
            torch.einsum("bsth,btuh,bhsu->bth", D, Dm1, M4))
        Gc = Gc * pre[:, n - 1, :, None, None] + torch.einsum(
            "bshp,bsn->bhpn", gc * pre[..., None], cc)
    return dx, dB, dC, dd


def ssm_scan_bwd(x, B_in, C_in, decay, dy):
    """Gradients (dx, dB, dC, ddecay) of :func:`ssm_scan` for dy (B, S, H,
    P), fp32. CPU tensors run :func:`ssm_scan_bwd_plain`; CUDA tensors
    launch ``ssm_scan_bwd_f32`` (fp32, contiguous; the forward's shapes)
    or raise.

    The kernel's scratch, one fp32 buffer from the caching allocator of
    the size ``ssm_scan_bwd_scratch_floats`` gives (the kernel source
    defines its layout): the state before every tile of every CTA and the
    per-(head, CTA) partials of dB, dC and ddecay, which a last launch sums
    in a fixed order (deterministic; no atomics)."""
    if x.device.type == "cpu":
        return ssm_scan_bwd_plain(x, B_in, C_in, decay, dy)
    if x.device.type != "cuda":
        raise ValueError(f"no ssm_scan_bwd kernel for device {x.device}")
    Bb, S, H, P = x.shape
    N = B_in.shape[-1]
    _check_operands(x, (("x", x, (Bb, S, H, P)), ("B_in", B_in, (Bb, S, N)),
                        ("C_in", C_in, (Bb, S, N)),
                        ("decay", decay, (Bb, S, H)),
                        ("dy", dy, (Bb, S, H, P))))
    _check_shape(P, N)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bb, S, H, P), **f32)
    dB = torch.empty((Bb, S, N), **f32)
    dC = torch.empty((Bb, S, N), **f32)
    dd = torch.empty((Bb, S, H), **f32)
    if S:
        n = _scratch_fn()(Bb, S, H, P, N)
        scratch = torch.empty(n, **f32)
        if _cuda.is_fake(x):             # a shape-only trace's face
            _cuda.account("ssm_scan_bwd_f32", *cost(x, B_in, True))
            return dx, dB, dC, dd
        err = _bwd_fn()(x.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
                        decay.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                        dB.data_ptr(), dC.data_ptr(), dd.data_ptr(),
                        scratch.data_ptr(), n, Bb, S, H, P, N,
                        _cuda.stream_ptr(x.device))
        _cuda.check(err, "ssm_scan_bwd_f32")
        ssm_scan_bwd.launches += 1
        if _cuda.ACCOUNTANTS:
            _cuda.account("ssm_scan_bwd_f32", *cost(x, B_in, True))
    return dx, dB, dC, dd


ssm_scan_bwd.launches = 0


def bwd_design(B: int, S: int, H: int, P: int, N: int) -> dict:
    """The backward kernel's launches at these sizes on the current card
    (``ssm_scan_bwd_design``): warps a CTA, CTAs, dynamic shared bytes a
    CTA and the CTAs an SM holds (the occupancy query) of pass 2 and of
    pass 1, and the scratch bytes of the tile-boundary states and of the
    per-CTA partials."""
    out = (ctypes.c_int64 * 7)()
    fn = _cuda.load(_LIB_NAME).ssm_scan_bwd_design
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.check(fn(B, S, H, P, N, ctypes.addressof(out)),
                "ssm_scan_bwd_design")
    floats = _scratch_fn()(B, S, H, P, N)
    return dict(warps=out[0], ctas=out[1], smem_bytes=out[2],
                ctas_per_sm=out[3], pass1_smem_bytes=out[5],
                pass1_ctas_per_sm=out[6], state_bytes=4 * out[4],
                partial_bytes=4 * (floats - out[4]))


def _kernel_fn():
    fn = _cuda.load(_LIB_NAME).ssm_scan_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _cuda.load(_LIB_NAME).ssm_scan_bwd_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _scratch_fn():
    fn = _cuda.load(_LIB_NAME).ssm_scan_bwd_scratch_floats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_int64
    return fn
