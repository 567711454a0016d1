"""The shapes the port's attention kernels were widened to: the plain
twins of TPU kernels 1-5 (paged decode bf16 and int8, paged chunk prefill
bf16 and int8, dense decode) against the JAX Pallas kernels in interpret
mode (as ``tests/test_torch_kernels.py`` runs them) at glm4-9b's group
size G = 16 (H = 32 over Hkv = 2, and at hd = 64 where 16 heads exceed
the bf16 lanes of a 16-byte-load row) and at kimi-k2's head size hd = 112,
over full-precision and int8 pools, with windows, sinks and softcaps.
And each wrapper's check: exactly the instantiated shapes pass, every
other one raises a ValueError that names it.

Inputs are fp32 from numpy seeds (int8 pools with positive scales).
Tolerance 2e-5: fp32 attention over at most a few hundred keys, sums in
another order (the reference's own kernel-vs-oracle tolerance). The CUDA
kernels are held against these twins on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jda
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as j_paged_decode_kernel
from repro.kernels.paged_prefill_attention import \
    paged_prefill_chunk_attention as j_paged_prefill_kernel
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_prefill_attention as ppa
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _pools(rng, shape, int8):
    """(k, v, k_scale, v_scale) pools: fp32 normal, or int8 with positive
    per-token scales (None for fp32)."""
    if not int8:
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32), None, None)
    return (rng.integers(-127, 128, size=shape).astype(np.int8),
            rng.integers(-127, 128, size=shape).astype(np.int8),
            rng.uniform(0.002, 0.03, size=shape[:-1]).astype(np.float32),
            rng.uniform(0.002, 0.03, size=shape[:-1]).astype(np.float32))


def _scales(ks, vs, conv):
    return {} if ks is None else dict(k_scale=conv(ks), v_scale=conv(vs))


# (G, hd, sliding_window, sinks, softcap)
SHAPES = [(16, 64, 0, 0, 0.0), (16, 128, 0, 0, 0.0),
          (16, 112, 13, 2, 30.0), (8, 112, 0, 0, 0.0),
          (4, 112, 20, 3, 0.0), (2, 112, 0, 0, 50.0)]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("G,hd,sw,sinks,cap", SHAPES)
def test_paged_decode_twin_matches_pallas(G, hd, sw, sinks, cap, int8):
    rng = np.random.default_rng(G * 1000 + hd + sw)
    B, Hkv, bs, nb = 2, 2, 8, 4
    NB = B * nb + 2
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    kp, vp, ks, vs = _pools(rng, (Hkv, NB, bs, hd), int8)
    lens = np.array([nb * bs, 11], np.int32)
    bt = np.zeros((B, nb), np.int32)
    bt[0] = [3, 1, 7, 5]
    bt[1, :2] = [2, 9]
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap,
              return_partials=True)
    got = pda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(lens), **_scales(ks, vs, _t), **kw)
    want = j_paged_decode_kernel(
        *map(jnp.asarray, (q, kp, vp, bt, lens)), interpret=True,
        **_scales(ks, vs, jnp.asarray), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("H,Hkv,hd,C,nb,sw,sinks,cap", [
    (32, 2, 64, 9, 2, 0, 0, 0.0),         # G = 16
    (32, 2, 112, 13, 3, 12, 2, 30.0),     # G = 16, hd = 112, masks
    (16, 2, 112, 8, 0, 0, 0, 0.0),        # first chunk, G = 8
])
def test_chunk_prefill_twin_matches_pallas(H, Hkv, hd, C, nb, sw, sinks,
                                           cap, int8):
    rng = np.random.default_rng(H + hd + C)
    bs, NB = 8, 7
    kp, vp, ks, vs = _pools(rng, (Hkv, NB, bs, hd), int8)
    table = rng.permutation(NB)[:nb].astype(np.int32)
    q = rng.standard_normal((C, H, hd)).astype(np.float32)
    kc = rng.standard_normal((C, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((C, Hkv, hd)).astype(np.float32)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    got = ppa.paged_prefill_chunk_attention(
        *map(_t, (q, kp, vp, table, kc, vc)), **_scales(ks, vs, _t), **kw)
    want = j_paged_prefill_kernel(
        *map(jnp.asarray, (q, kp, vp, table, kc, vc)), interpret=True,
        **_scales(ks, vs, jnp.asarray), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G,hd,sw,sinks,cap", SHAPES[:4])
def test_dense_decode_twin_matches_pallas(G, hd, sw, sinks, cap):
    rng = np.random.default_rng(G + hd)
    B, Hkv, S = 3, 2, 40
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    lens = np.array([S, 17, 1], np.int32)
    for b, n in enumerate(lens):             # stale slots past cache_len
        kc[b, :, n:] = np.nan
        vc[b, :, n:] = np.nan
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap,
              return_partials=True)
    got = tda.decode_attention(*map(_t, (q, kc, vc, lens)), **kw)
    want = jda.decode_attention(q, kc, vc, lens, block_k=16, interpret=True,
                                **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# the wrappers' checks: exactly the instantiated shapes
# ---------------------------------------------------------------------------
def _decode_operands(G, hd, bs=8):
    bf = dict(dtype=torch.bfloat16)
    q = torch.zeros((1, 1, G, hd), **bf)
    pool = torch.zeros((1, 2, bs, hd), **bf)
    return q, pool, torch.zeros((1, 1), dtype=torch.int32), \
        torch.ones(1, dtype=torch.int32)


INSTANTIATED = [(G, hd) for G in (1, 2, 4, 8, 16) for hd in (64, 112, 128)]
REFUSED = [(3, 128), (32, 128), (4, 96), (16, 80), (6, 112)]


@pytest.mark.parametrize("G,hd", INSTANTIATED + REFUSED)
def test_decode_wrappers_take_exactly_the_instantiated_shapes(G, hd):
    q, pool, table, lens = _decode_operands(G, hd)
    cache = torch.zeros((1, 1, 8, hd), dtype=torch.bfloat16)
    checks = [
        lambda: pda._check_cuda_operands(q, pool, pool, table, lens, None),
        lambda: tda._check_cuda_operands(q, cache, cache, lens)]
    for check in checks:
        if (G, hd) in REFUSED:
            with pytest.raises(ValueError, match=f"hd={hd}, G={G}"):
                check()
        else:
            check()


@pytest.mark.parametrize("G,hd", [(16, 112), (64, 112), (2, 64),
                                  (3, 128), (4, 96), (128, 64)])
def test_chunk_wrapper_takes_group_sizes_dividing_64(G, hd):
    C, Hkv = 5, 2
    bf = dict(dtype=torch.bfloat16)
    q = torch.zeros((C, Hkv * G, hd), **bf)
    pool = torch.zeros((Hkv, 3, 8, hd), **bf)
    kc = torch.zeros((C, Hkv, hd), **bf)
    args = (q, pool, pool, torch.zeros(1, dtype=torch.int32), kc, kc)
    if 64 % G or hd not in (64, 112, 128):
        with pytest.raises(ValueError, match=f"hd={hd}, G={G}"):
            ppa._check_cuda_operands(*args)
    else:
        ppa._check_cuda_operands(*args)


def test_decode_block_size_above_1024_is_refused():
    q, _, table, lens = _decode_operands(4, 128)
    pool = torch.zeros((1, 2, 1025, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block size 1025"):
        pda._check_cuda_operands(q, pool, pool, table, lens, None)


@pytest.mark.parametrize("B,Hkv,nb,G,want", [
    (1, 1, 4096, 16, 256), (1, 1, 4096, 8, 512), (8, 2, 128, 16, 33),
    (1, 1, 600 * 512, 16, None)])
def test_split_plan_holds_the_g16_merge(B, Hkv, nb, G, want):
    """G = 16 caps the splits of one (sequence, kv head) at half, the (m, l)
    pairs the kernel's last CTA keeps in shared memory."""
    if want is None:
        with pytest.raises(ValueError, match="256 splits"):
            pda.plan_splits(B, Hkv, nb, 132, G)
        return
    assert pda.plan_splits(B, Hkv, nb, 132, G) == want
