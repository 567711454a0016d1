"""RWKV6 (Finch) recurrence: CUDA kernel wrapper + plain twin.

Port of ``repro/kernels/rwkv6_scan.py``. The TPU kernel ``_rwkv6_kernel``
is replaced by the hand-written Hopper kernel in ``csrc/rwkv6_scan.cu``;
:func:`rwkv6_scan_plain` is its plain PyTorch twin (a step loop with the
kernel's arithmetic):

    y_t = r_t · S + (r_t · (u ⊙ k_t)) v_t ;   S <- diag(w_t) S + k_t ⊗ v_t

with one (P, P) fp32 state per (batch, head) starting at zero. The TPU
wrapper pads the tail with w = 1 to whole VMEM chunks; the CUDA kernel
loops to S and needs no padding.

:func:`rwkv6_scan` dispatches on the device of ``r``: a CPU tensor runs the
plain twin, a CUDA tensor launches the kernel or raises. The wrapper counts
its kernel's launches (``rwkv6_scan.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda

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
