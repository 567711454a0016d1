"""The port's paged-attention kernels' plain twins (what a CPU tensor runs)
against the JAX reference: the Pallas kernels in interpret mode, exactly as
``tests/test_paged_attention.py`` runs them, and the pure-jnp oracles
(``kernels/ref.py``, ``*_jnp``). Plus the §4.2.2 combine rules, the
serving-window conventions and the wrappers' device dispatch.

All inputs are fp32 from numpy seeds. Tolerance 2e-5: fp32 attention over
at most a few hundred keys, reordered sums (the reference's own
kernel-vs-oracle tolerance).

The CUDA kernels themselves are held against these twins on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import combine as jC
from repro.kernels import ref as jref
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as j_paged_decode_kernel
from repro.kernels.paged_prefill_attention import (
    paged_prefill_chunk_attention as j_paged_prefill_kernel,
    paged_prefill_chunk_attention_jnp)
from repro.models import attention as jattn
from repro_torch.core import combine as tC
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rand_paged(seed, B, Hkv, G, hd, bs, nb, spare=3):
    """Random pool, per-sequence tables of distinct blocks padded with
    block 0 past each sequence's live blocks, ragged lengths."""
    rng = np.random.default_rng(seed)
    NB = B * nb + spare
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    kp = rng.standard_normal((Hkv, NB, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((Hkv, NB, bs, hd)).astype(np.float32)
    lens = rng.integers(1, nb * bs + 1, size=B).astype(np.int32)
    lens[0] = nb * bs
    perm = rng.permutation(np.arange(1, NB))[:B * nb].reshape(B, nb)
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        live = -(-int(lens[b]) // bs)
        bt[b, :live] = perm[b, :live]
    return q, kp, vp, bt, lens


DECODE_MASKS = [(0, 0, 0.0), (20, 0, 0.0), (17, 4, 0.0), (0, 0, 30.0),
                (11, 2, 50.0)]


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("sw,sinks,cap", DECODE_MASKS)
def test_decode_plain_matches_reference_oracle(G, sw, sinks, cap):
    q, kp, vp, bt, lens = _rand_paged(G * 31 + sw, 3, 2, G, 32, 8, 5)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    # the reference's oracle (what its paged_decode_attention_jnp runs)
    want = jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), **kw)
    got = pda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(lens), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # ... and the port's own oracle (kernels/ref.py)
    got2 = tref.paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(bt),
                                           _t(lens), **kw)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G,sw,sinks,cap", [(1, 0, 0, 0.0), (4, 17, 4, 30.0)])
def test_decode_plain_matches_pallas_kernel_partials(G, sw, sinks, cap):
    """(o, l, m) of the plain twin == the Pallas kernel (interpret mode),
    including the empty-partial convention m = NEG_INF, l = 0 for a
    sequence whose every slot is masked (cache_len 0)."""
    q, kp, vp, bt, lens = _rand_paged(G + 5, 3, 2, G, 32, 8, 4)
    lens[2] = 0
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap,
              return_partials=True)
    jo, jl, jm = j_paged_decode_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), interpret=True, **kw)
    o, l, m = pda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                         _t(lens), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    assert (m[2] == np.float32(pda.NEG_INF)).all() and (l[2] == 0).all()


def test_decode_plain_block_positions_with_pos_pad_match_pallas():
    """A block-sharded table: foreign slots carry POS_PAD and are skipped,
    owned slots keep their true base positions."""
    B, Hkv, G, hd, bs, nb = 2, 2, 4, 32, 8, 4
    q, kp, vp, bt, lens = _rand_paged(9, B, Hkv, G, hd, bs, nb)
    lens[:] = nb * bs
    pos = np.tile(np.arange(nb, dtype=np.int32) * bs, (B, 1))
    pos[:, 1::2] = pda.POS_PAD
    jo, jl, jm = j_paged_decode_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), block_positions=jnp.asarray(pos),
        sliding_window=20, attention_sinks=3, interpret=True,
        return_partials=True)
    o, l, m = pda.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(bt), _t(lens), block_positions=_t(pos),
        sliding_window=20, attention_sinks=3, return_partials=True)
    for got, want in ((o, jo), (l, jl), (m, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_plain_selects_away_stale_nan_memory():
    """Stale NaN behind padded table slots (block 0) and past cache_len in
    a sequence's last block never reaches the output: select, not
    multiply."""
    q, kp, vp, bt, lens = _rand_paged(4, 3, 2, 4, 32, 8, 4)
    lens[1] = 5
    clean = pda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                       _t(lens), return_partials=True)
    kp[:, 0] = np.nan
    vp[:, 0] = np.nan
    kp[:, bt[1, 0], 5:] = np.nan
    vp[:, bt[1, 0], 5:] = np.inf
    dirty = pda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt),
                                       _t(lens), return_partials=True)
    for a, b in zip(clean, dirty):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("sw,sinks", [(1, 0), (1, 2), (2, 0), (9, 2)])
@pytest.mark.parametrize("G", [1, 4])
def test_paged_decode_combine_serving_window_matches_reference(sw, sinks, G):
    """Full decode attention (pool partial ⊕ new-token partial) through the
    serving-window mapping: window w - 1 anchored at cache_len, and
    sliding_window == 1 clamping cache_len to the sinks."""
    q, kp, vp, bt, lens = _rand_paged(sw * 7 + sinks + G, 3, 2, G, 32, 8, 3)
    rng = np.random.default_rng(sw)
    H = 2 * G
    qf = q.reshape(3, H, 32)
    kn = rng.standard_normal((3, 2, 32)).astype(np.float32)
    vn = rng.standard_normal((3, 2, 32)).astype(np.float32)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=20.0)
    want = jattn.paged_decode_attention_combine(
        jnp.asarray(qf), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray(kn), jnp.asarray(vn), **kw)
    got = tattn.paged_decode_attention_combine(
        _t(qf), _t(kp), _t(vp), _t(bt), _t(lens), _t(kn), _t(vn), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serving_window_and_triple_to_partial_conventions():
    lens = torch.tensor([0, 3, 9], dtype=torch.int32)
    assert tops._serving_window(0, 0, lens)[:2] == (0, 0)
    sw, sinks, clen = tops._serving_window(5, 2, lens)
    assert (sw, sinks) == (4, 2) and clen is lens
    sw, sinks, clen = tops._serving_window(1, 2, lens)
    assert (sw, sinks) == (0, 0) and clen.tolist() == [0, 2, 2]
    o = torch.randn(2, 3, 2, 8)
    l, m = torch.rand(2, 3, 2), torch.randn(2, 3, 2)
    p = tops._triple_to_partial(o, l, m, 2, 6, 8)
    np.testing.assert_allclose(p.a.numpy(),
                               (o.reshape(2, 6, 8) * l.reshape(2, 6, 1))
                               .numpy(), rtol=1e-6)
    np.testing.assert_allclose(tC.finalize(p).numpy(),
                               o.reshape(2, 6, 8).numpy(), rtol=1e-5,
                               atol=1e-6)


PREFILL_MASKS = [(0, 0, 0.0), (12, 0, 0.0), (12, 2, 0.0), (0, 0, 30.0)]


@pytest.mark.parametrize("C,nb", [(5, 4), (8, 0), (13, 2), (1, 3)])
@pytest.mark.parametrize("sw,sinks,cap", PREFILL_MASKS)
def test_prefill_plain_matches_reference_jnp(C, nb, sw, sinks, cap):
    """Empty prefix (nb=0), a chunk that is not a multiple of the block
    size, windows, sinks and softcap, G=3 — against the reference's gather
    oracle (blockwise attention over prefix + chunk)."""
    rng = np.random.default_rng(C * 17 + nb)
    Hkv, G, hd, bs = 2, 3, 16, 8
    kp = rng.standard_normal((Hkv, 16, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((Hkv, 16, bs, hd)).astype(np.float32)
    table = rng.permutation(16)[:nb].astype(np.int32)
    q = rng.standard_normal((C, Hkv * G, hd)).astype(np.float32)
    kc = rng.standard_normal((C, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((C, Hkv, hd)).astype(np.float32)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    want = paged_prefill_chunk_attention_jnp(
        *map(jnp.asarray, (q, kp, vp, table, kc, vc)), **kw)
    got = ppa.paged_prefill_chunk_attention(
        *map(_t, (q, kp, vp, table, kc, vc)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("G,C,nb,sw,sinks,cap", [
    (1, 8, 0, 0, 0, 0.0),          # first chunk of a fresh prompt
    (4, 13, 3, 12, 2, 30.0),       # partial chunk, window + sinks + softcap
])
def test_prefill_plain_matches_pallas_kernel(G, C, nb, sw, sinks, cap):
    rng = np.random.default_rng(G * 100 + C)
    Hkv, hd, bs = 2, 16, 8
    kp = rng.standard_normal((Hkv, 12, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((Hkv, 12, bs, hd)).astype(np.float32)
    table = rng.permutation(12)[:nb].astype(np.int32)
    q = rng.standard_normal((C, Hkv * G, hd)).astype(np.float32)
    kc = rng.standard_normal((C, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((C, Hkv, hd)).astype(np.float32)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    want = j_paged_prefill_kernel(
        *map(jnp.asarray, (q, kp, vp, table, kc, vc)), interpret=True, **kw)
    got = ppa.paged_prefill_chunk_attention(
        *map(_t, (q, kp, vp, table, kc, vc)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------------
# §4.2.2 combine
# ----------------------------------------------------------------------
def _partials(seed, n1, n2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    k = rng.standard_normal((3, n1 + n2, 16)).astype(np.float32)
    v = rng.standard_normal((3, n1 + n2, 16)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("cap", [0.0, 20.0])
def test_combine_matches_reference_and_full_attention(cap):
    q, k, v = _partials(1, 7, 5)
    tp = [tC.partial_attention(_t(q), _t(k[:, s]), _t(v[:, s]),
                               logit_softcap=cap)
          for s in (slice(0, 7), slice(7, 12))]
    jp = [jC.partial_attention(jnp.asarray(q), jnp.asarray(k[:, s]),
                               jnp.asarray(v[:, s]), logit_softcap=cap)
          for s in (slice(0, 7), slice(7, 12))]
    got = tC.finalize(tC.combine_many(tp))
    want = jC.finalize(jC.combine_many(jp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    whole = tC.finalize(tC.partial_attention(_t(q), _t(k), _t(v),
                                             logit_softcap=cap))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)


@pytest.mark.parametrize("empty_m", [-np.inf, pda.NEG_INF])
def test_empty_partial_is_the_combine_identity(empty_m):
    """An empty partial merges as the identity in both conventions: m=-inf
    (core/combine.py) and m=NEG_INF=-1e30 with l=0 (the kernels)."""
    q, k, v = _partials(2, 6, 0)
    mask = np.zeros((3, 6), bool)
    mask[0] = True                              # row 0 has keys, rows 1-2 not
    p = tC.partial_attention(_t(q), _t(k), _t(v), mask=torch.from_numpy(mask))
    assert np.isneginf(p.m[1:].numpy()).all() and (p.s[1:] == 0).all()
    empty = tC.Partial(a=torch.zeros(3, 16), s=torch.zeros(3),
                       m=torch.full((3,), float(empty_m)))
    full = tC.partial_attention(_t(q), _t(k), _t(v))
    for merged in (tC.combine(full, empty), tC.combine(empty, full)):
        np.testing.assert_allclose(tC.finalize(merged).numpy(),
                                   tC.finalize(full).numpy(), **TOL)


# ----------------------------------------------------------------------
# wrapper dispatch
# ----------------------------------------------------------------------
def test_wrappers_run_plain_twins_on_cpu_without_counting_launches():
    q, kp, vp, bt, lens = _rand_paged(3, 2, 2, 4, 32, 8, 2)
    n0 = pda.paged_decode_attention.launches
    out = pda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lens))
    plain = pda.paged_decode_attention_plain(_t(q), _t(kp), _t(vp), _t(bt),
                                             _t(lens))
    np.testing.assert_array_equal(out.numpy(), plain.numpy())
    assert pda.paged_decode_attention.launches == n0
    qc = torch.randn(5, 8, 32)
    kc, vc = torch.randn(5, 2, 32), torch.randn(5, 2, 32)
    tbl = torch.tensor([1, 3], dtype=torch.int32)
    n1 = ppa.paged_prefill_chunk_attention.launches
    ppa.paged_prefill_chunk_attention(qc, _t(kp), _t(vp), tbl, kc, vc)
    assert ppa.paged_prefill_chunk_attention.launches == n1


def test_int8_scale_pools_are_refused():
    """An int8 pool needs both scale pools: a lone one is refused by both
    wrappers (the int8 twins themselves are held against the reference in
    tests/test_torch_int8.py)."""
    q, kp, vp, bt, lens = _rand_paged(3, 2, 2, 4, 32, 8, 2)
    scales = torch.ones(kp.shape[:3])
    with pytest.raises(ValueError, match="int8"):
        pda.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(bt), _t(lens),
                                   k_scale=scales)
    with pytest.raises(ValueError, match="int8"):
        ppa.paged_prefill_chunk_attention(
            torch.randn(5, 8, 32), _t(kp), _t(vp),
            torch.tensor([1], dtype=torch.int32), torch.randn(5, 2, 32),
            torch.randn(5, 2, 32), v_scale=scales)
