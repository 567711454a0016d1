"""The chunked adjoint of the scans' backward kernels, on the CPU.

``ssm_scan_bwd_f32`` and ``rwkv6_scan_bwd_{bf16,f32}`` compute the
gradients of the scans in chunked form: tiles of ``CHUNK`` = 16 steps, the
state and the adjoint advancing once per tile through products on the
tensor cores, and ddecay / dw expanded over the tile into four terms whose
decay factors are running products of factors in [0, 1] (never a ratio).
The CUDA code runs only on the card; ``ssm_scan_bwd_chunked_plain`` and
``rwkv6_scan_bwd_chunked_plain`` are that algorithm in plain PyTorch, held
here against the step-loop backward twins (``ssm_scan_bwd_plain``,
``rwkv6_scan_bwd_plain``) and ``jax.grad`` of the reference oracles
(``repro.kernels.ref`` ``ssm_scan_ref`` / ``rwkv6_scan_ref``).

Cases: those of ``tests/test_torch_scan_grad.py`` (ragged S of 1, 17, 37
and 40; exact 0 and 1.0 decays, a whole tile of 1.0; RWKV6 in the model's
bf16 decays), plus a full-tile run at P = N = 32. Tolerance: that file's,
1e-5 of each gradient's largest entry plus 1e-5 relative (fp32 on both
sides, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import rwkv6_scan as trw
from repro_torch.kernels import ssm_scan as tssm
from test_torch_scan_grad import (RWKV_CASES, SSM_CASES, _close,
                                  _rwkv_inputs, _ssm_inputs)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("B,S,H,P,N,edges",
                         SSM_CASES + [(1, 48, 2, 32, 32, True)])
def test_ssm_scan_bwd_chunked_matches_step_twin_and_jax(B, S, H, P, N,
                                                        edges):
    ops, dy = _ssm_inputs(S + N + 7, B, S, H, P, N, edges)
    t = [torch.from_numpy(a) for a in (*ops, dy)]
    got = tssm.ssm_scan_bwd_chunked_plain(*t)
    step = tssm.ssm_scan_bwd_plain(*t)
    _, vjp = jax.vjp(lambda x, b, c, a: jref.ssm_scan_ref(x, None, b, c, a),
                     *map(jnp.asarray, ops))
    ref = vjp(jnp.asarray(dy))
    for name, g, s, r in zip(("dx", "dB", "dC", "ddecay"), got, step, ref):
        assert g.shape == s.shape and g.dtype == torch.float32
        _close(g, s, name + " vs the step twin")
        _close(g, np.asarray(r), name + " vs jax")


@pytest.mark.parametrize("B,S,H,P,decays,bf16",
                         RWKV_CASES + [(1, 48, 2, 32, "edges", False)])
def test_rwkv6_scan_bwd_chunked_matches_step_twin_and_jax(B, S, H, P,
                                                          decays, bf16):
    ops, dy = _rwkv_inputs(S + P + 7, B, S, H, P, decays)
    if bf16:             # the model's bf16 r/k/v/w (u stays fp32)
        ops = tuple(torch.from_numpy(a).bfloat16().float().numpy()
                    for a in ops[:4]) + ops[4:]
    t = [torch.from_numpy(a) for a in (*ops, dy)]
    got = trw.rwkv6_scan_bwd_chunked_plain(*t)
    step = trw.rwkv6_scan_bwd_plain(*t)
    _, vjp = jax.vjp(jref.rwkv6_scan_ref, *map(jnp.asarray, ops))
    ref = vjp(jnp.asarray(dy))
    for name, g, s, r in zip(("dr", "dk", "dv", "dw", "du"), got, step, ref):
        assert g.shape == s.shape and g.dtype == torch.float32
        _close(g, s, name + " vs the step twin")
        _close(g, np.asarray(r), name + " vs jax")
