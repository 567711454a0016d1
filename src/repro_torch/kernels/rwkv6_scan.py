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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.ssm_scan import CHUNK, segment_products

_LIB_NAME = "rwkv6_scan"
HEAD_SIZES = (32, 64)                  # P the kernel is instantiated for
_ENTRIES = {torch.bfloat16: "rwkv6_scan_bf16", torch.float32: "rwkv6_scan_f32"}


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


def rwkv6_scan(r, k, v, w, u) -> torch.Tensor:
    """r/k/v/w: (B, S, H, P) in the model dtype (w the per-step decay in
    (0, 1)); u: (H, P) bonus. Returns y: (B, S, H, P) fp32.

    CPU tensors run :func:`rwkv6_scan_plain`; CUDA tensors launch
    ``csrc/rwkv6_scan.cu`` (r/k/v/w all bf16 or all fp32 and u fp32,
    contiguous; P in ``HEAD_SIZES``) or raise."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"no rwkv6_scan kernel for device {r.device}")
    B, S, H, P = r.shape
    if r.dtype not in _ENTRIES:
        raise TypeError(f"r/k/v/w must be bfloat16 or float32 on the GPU; "
                        f"got {r.dtype}")
    for name, t, shape, dtype in (("r", r, (B, S, H, P), r.dtype),
                                  ("k", k, (B, S, H, P), r.dtype),
                                  ("v", v, (B, S, H, P), r.dtype),
                                  ("w", w, (B, S, H, P), r.dtype),
                                  ("u", u, (H, P), torch.float32)):
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
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=r.device)
    if S:
        entry = _ENTRIES[r.dtype]
        err = _kernel_fn(entry)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                w.data_ptr(), u.data_ptr(), y.data_ptr(), B,
                                S, H, P, _cuda.stream_ptr(r.device))
        _cuda.check(err, entry)
        rwkv6_scan.launches += 1
    return y


rwkv6_scan.launches = 0


def _kernel_fn(entry: str):
    fn = getattr(_cuda.load(_LIB_NAME), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
