"""The chunked algorithm of the Mamba2 and RWKV6 scan kernels, on the CPU.

``csrc/ssm_scan.cu`` and ``csrc/rwkv6_scan.cu`` compute the recurrences in
chunked form: tiles of ``CHUNK`` = 16 steps whose products run on the
tensor cores, the state advancing once per tile, and every decay factor a
product of factors in [0, 1] (never a ratio or an exp of log differences).
The CUDA code runs only on the card; ``ssm_scan_chunked_plain`` and
``rwkv6_scan_chunked_plain`` are that algorithm in plain PyTorch, held here
against the step twins (``ssm_scan_plain``, ``rwkv6_scan_plain``), the JAX
Pallas kernels in interpret mode, and the closed-form final states the
model layer uses (``mamba_final_state``, ``rwkv_final_state``).

Cases: S in {1, L-1, L, L+1, 3L+5} (a ragged last tile, a single short
tile); decays with exact 0 and exact 1.0 and a run of 1.0 over a whole tile;
an RWKV6 decay drawn as the model draws it (exp(-exp(-6 + noise)) in bf16,
mostly 0.99609375 or 1.0); both RWKV6 dtypes; Mamba2 at N = 16 and 128 and
P = 8. Inputs come from numpy seeds. Tolerance: the fp32 kernel tolerance
of ``tests/test_torch_recurrent.py`` (KTOL = 1e-5, atol and rtol: the same
fp32 operations in another order); states to KTOL of their largest entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rwkv6_scan as jrw
from repro.kernels import ssm_scan as jssm
from repro_torch.kernels import rwkv6_scan as trw
from repro_torch.kernels import ssm_scan as tssm
from repro_torch.models import ssm as tssm_mod
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

KTOL = 1e-5      # as tests/test_torch_recurrent.py: fp32, reordered sums
L = tssm.CHUNK
LENGTHS = [1, L - 1, L, L + 1, 3 * L + 5]


def _close(got, want, tol=KTOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _close_state(got, want, tol=KTOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _decays(rng, shape, kind):
    """Decays in (0, 1] by ``kind``: "smooth" (0.45-0.95), "edges" (exact 0
    and exact 1.0 sprinkled in, and a run of 1.0 over the whole second
    tile), or "model" (exp(-exp(-6 + noise)) rounded to bf16, the RWKV6
    model's decay at its init, mostly 0.99609375 or exactly 1.0)."""
    if kind == "model":
        w = np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal(shape)))
        return np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    a = (1 / (1 + np.exp(-rng.standard_normal(shape))) * 0.5 + 0.45)
    if kind == "edges":
        pick = rng.random(shape)
        a = np.where(pick < 0.1, 0.0, np.where(pick > 0.85, 1.0, a))
        a[:, L:2 * L] = 1.0
    return a.astype(np.float32)


def _ssm_inputs(seed, B, S, H, P, N, kind):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    Bi = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Ci = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    return x, Bi, Ci, _decays(rng, (B, S, H), kind)


def _rwkv_inputs(seed, B, S, H, P, kind, dtype):
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
               for _ in range(3))
    w = _decays(rng, (B, S, H, P), kind)
    u = (rng.standard_normal((H, P)) * 0.3).astype(np.float32)
    jin = [jnp.asarray(z).astype(dtype) for z in (r, k, v, w)]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tin = [torch.from_numpy(np.array(z.astype(jnp.float32))).to(tdt)
           for z in jin]
    return jin, tin, u


def test_segment_products_are_exact_products_with_zero_and_one():
    a = torch.tensor([[0.5, 0.0, 1.0, 0.25]])
    D = tssm.segment_products(a)[0]
    want = torch.tensor([[1.0, 0.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0, 0.0],
                         [0.0, 1.0, 1.0, 0.0],
                         [0.0, 0.25, 0.25, 1.0]])
    assert D.equal(want)


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("kind", ["smooth", "edges"])
def test_ssm_chunked_matches_step_twin_and_pallas(S, kind):
    B, H, P, N = 2, 3, 16, 32
    x, Bi, Ci, a = _ssm_inputs(S + 7 * (kind == "edges"), B, S, H, P, N,
                               kind)
    tin = [torch.from_numpy(z) for z in (x, Bi, Ci, a)]
    got, h = tssm.ssm_scan_chunked_plain(*tin, return_state=True)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    assert bool(torch.isfinite(got).all())
    _close(got, tssm.ssm_scan_plain(*tin))
    _close(got, jssm.ssm_scan(x, Bi, Ci, a, chunk=L, interpret=True))
    _close_state(h, tssm_mod.mamba_final_state(tin[0], tin[1], tin[3]))


@pytest.mark.parametrize("P,N", [(8, 16), (8, 128), (24, 128)])
def test_ssm_chunked_state_and_head_sizes(P, N):
    B, S, H = 1, 3 * L + 5, 2
    x, Bi, Ci, a = _ssm_inputs(P + N, B, S, H, P, N, "edges")
    tin = [torch.from_numpy(z) for z in (x, Bi, Ci, a)]
    got, h = tssm.ssm_scan_chunked_plain(*tin, return_state=True)
    _close(got, tssm.ssm_scan_plain(*tin))
    _close(got, jssm.ssm_scan(x, Bi, Ci, a, chunk=L, interpret=True))
    _close_state(h, tssm_mod.mamba_final_state(tin[0], tin[1], tin[3]))


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rwkv6_chunked_matches_step_twin_and_pallas(S, dtype):
    B, H, P = 2, 2, 32
    jin, tin, u = _rwkv_inputs(S, B, S, H, P, "smooth", dtype)
    got, st = trw.rwkv6_scan_chunked_plain(*tin, torch.from_numpy(u),
                                           return_state=True)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    _close(got, trw.rwkv6_scan_plain(*tin, torch.from_numpy(u)))
    _close(got, jrw.rwkv6_scan(*jin, u, chunk=L, interpret=True))
    _close_state(st, tssm_mod.rwkv_final_state(*tin[1:]))


@pytest.mark.parametrize("kind", ["edges", "model"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rwkv6_chunked_exact_and_model_decays(kind, dtype):
    B, S, H, P = 1, 3 * L + 5, 2, 64
    jin, tin, u = _rwkv_inputs(17, B, S, H, P, kind, dtype)
    w = tin[3].float()
    if kind == "edges":
        assert bool((w == 0).any()) and bool((w[:, L:2 * L] == 1).all())
    else:
        assert bool((w == 1).any()) and bool((w < 1).any())
    got, st = trw.rwkv6_scan_chunked_plain(*tin, torch.from_numpy(u),
                                           return_state=True)
    assert bool(torch.isfinite(got).all())
    _close(got, trw.rwkv6_scan_plain(*tin, torch.from_numpy(u)))
    _close(got, jrw.rwkv6_scan(*jin, u, chunk=L, interpret=True))
    _close_state(st, tssm_mod.rwkv_final_state(*tin[1:]))


@pytest.mark.parametrize("chunk", [4, 32])
def test_chunked_models_do_not_depend_on_the_tile(chunk):
    """The tile is the kernel's choice: another tile gives the same scan."""
    x, Bi, Ci, a = (torch.from_numpy(z) for z in
                    _ssm_inputs(5, 1, 3 * L + 5, 2, 8, 16, "edges"))
    _close(tssm.ssm_scan_chunked_plain(x, Bi, Ci, a, chunk=chunk),
           tssm.ssm_scan_plain(x, Bi, Ci, a))
    _, tin, u = _rwkv_inputs(6, 1, 3 * L + 5, 2, 32, "edges", jnp.float32)
    _close(trw.rwkv6_scan_chunked_plain(*tin, torch.from_numpy(u),
                                        chunk=chunk),
           trw.rwkv6_scan_plain(*tin, torch.from_numpy(u)))
