"""The split-KV plan of the port's paged decode kernel, on the CPU.

The CUDA kernel (``csrc/paged_decode_attention.cu``) cuts each sequence's
block table into S contiguous slot ranges (``plan_splits``,
``split_ranges``), runs one CTA per range and merges the ranges' (o, l, m)
partials by the §4.2.2 rule in the same launch. Here, without a card:

* the planner covers every table slot exactly once, leaves no split empty
  of slots, keeps every split within the kernel's slot list, and gives at
  least two CTAs a SM wherever the table has the slots for that;
* merging the plain twin's partials over the planner's ranges with
  ``repro_torch.core.combine`` equals the unsplit plain twin, and the JAX
  package's Pallas kernel (interpret mode), on the same numpy inputs: bf16
  and int8 pools, POS_PAD slots, a window with sinks that masks whole
  splits, a sequence with cache_len 0.

Inputs are fp32 (int8 pools with fp32 scales) from numpy seeds. Tolerance
1e-5: the same fp32 math summed in another grouping.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode_attention import \
    paged_decode_attention as j_paged_decode_kernel
from repro_torch.core import combine as tC
from repro_torch.kernels import paged_decode_attention as pda
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
SM = 132                     # the H100's SM count


# (B, Hkv, nb): the main decode shape, one head-partition worker, long
# context, tiny and empty tables, a batch large enough for one split, a
# table longer than one split's slot list
PLAN_CASES = [(8, 8, 128), (8, 4, 128), (8, 8, 2048), (1, 1, 1), (2, 2, 3),
              (1, 8, 5), (64, 8, 128), (128, 8, 16), (1, 1, 200000),
              (3, 5, 77), (8, 8, 0)]


@pytest.mark.parametrize("B,Hkv,nb", PLAN_CASES)
def test_plan_splits_covers_each_slot_once_and_fills_the_card(B, Hkv, nb):
    splits = pda.plan_splits(B, Hkv, nb, SM)
    ranges = pda.split_ranges(nb, splits)
    assert len(ranges) == splits >= 1
    covered = [s for lo, hi in ranges for s in range(lo, hi)]
    assert covered == list(range(nb))               # each slot exactly once
    if nb:
        assert all(hi > lo for lo, hi in ranges)    # no split without slots
        assert splits <= nb
    else:
        assert splits == 1
    assert splits <= pda.MAX_SPLITS
    assert max(hi - lo for lo, hi in ranges) <= pda.MAX_SLOTS_PER_SPLIT
    if nb >= -(-2 * SM // (B * Hkv)):               # enough slots for it
        assert B * Hkv * splits >= 2 * SM
    geo = pda.launch_geometry(B, Hkv, nb, SM)
    assert geo["ctas"] == B * Hkv * splits and geo["grid"] == [splits, Hkv,
                                                               B]


def test_plan_splits_never_reads_the_device():
    """The plan is a function of shapes only: a one-SM card takes one
    split where the slots allow no more, and a table too long for
    MAX_SPLITS splits is refused."""
    assert pda.plan_splits(8, 8, 128, 1) == 1
    with pytest.raises(ValueError):
        pda.plan_splits(1, 1, pda.MAX_SPLITS * pda.MAX_SLOTS_PER_SPLIT + 1,
                        SM)


def _inputs(seed, B, Hkv, G, hd, bs, nb, *, int8, pos_pad):
    """fp32 queries over fp32 pools (or int8 pools with positive fp32
    scales), per-sequence tables of distinct blocks padded with block 0,
    ragged lengths with the second sequence empty (cache_len 0)."""
    rng = np.random.default_rng(seed)
    NB = B * nb + 3
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    if int8:
        kp = rng.integers(-127, 128, size=(Hkv, NB, bs, hd)).astype(np.int8)
        vp = rng.integers(-127, 128, size=(Hkv, NB, bs, hd)).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, size=(Hkv, NB, bs)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, size=(Hkv, NB, bs)).astype(np.float32)
    else:
        kp = rng.standard_normal((Hkv, NB, bs, hd)).astype(np.float32)
        vp = rng.standard_normal((Hkv, NB, bs, hd)).astype(np.float32)
        ks = vs = None
    lens = rng.integers(1, nb * bs + 1, size=B).astype(np.int32)
    lens[0], lens[1] = nb * bs, 0
    perm = rng.permutation(np.arange(1, NB))[:B * nb].reshape(B, nb)
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        live = -(-int(lens[b]) // bs)
        bt[b, :live] = perm[b, :live]
    pos = np.tile(np.arange(nb, dtype=np.int32) * bs, (B, 1))
    if pos_pad:             # a block-sharded table: foreign slots POS_PAD
        pos[:, 1::3] = pda.POS_PAD
    return q, kp, vp, ks, vs, bt, lens, pos


def _split_merged(q, kp, vp, ks, vs, bt, lens, pos, splits, **kw):
    """The plain twin on each split's slot range (its true base positions),
    merged with core.combine: what the kernel's one launch computes."""
    parts = []
    for lo, hi in pda.split_ranges(bt.shape[1], splits):
        o, l, m = pda.paged_decode_attention(
            q, kp, vp, bt[:, lo:hi].contiguous(), lens,
            block_positions=pos[:, lo:hi].contiguous(), k_scale=ks,
            v_scale=vs, return_partials=True, **kw)
        parts.append(tC.Partial(a=o * l[..., None], s=l, m=m))
    merged = tC.combine_many(parts)
    return tC.finalize(merged), merged.s, merged.m


# (G, hd, bs, nb, window, sinks, softcap, int8, POS_PAD)
MERGE_CASES = [
    (4, 32, 8, 24, 0, 0, 0.0, False, False),    # bf16-pool math, fp32
    (4, 32, 8, 24, 0, 0, 0.0, True, False),     # int8 pool + scales
    (2, 32, 4, 30, 0, 0, 0.0, False, True),     # POS_PAD slots
    (2, 32, 4, 30, 0, 0, 30.0, True, True),     # int8 + POS_PAD + softcap
    (1, 32, 2, 150, 13, 2, 0.0, False, False),  # window masks whole splits
    (4, 32, 4, 40, 9, 3, 50.0, True, False)]    # ... over an int8 pool


@pytest.mark.parametrize("G,hd,bs,nb,sw,sinks,cap,int8,pos_pad",
                         MERGE_CASES)
def test_split_merge_equals_unsplit_plain(G, hd, bs, nb, sw, sinks, cap,
                                          int8, pos_pad):
    B, Hkv = 3, 2
    args = [None if x is None else torch.from_numpy(x) for x in _inputs(
        nb + G, B, Hkv, G, hd, bs, nb, int8=int8, pos_pad=pos_pad)]
    q, kp, vp, ks, vs, bt, lens, pos = args
    splits = pda.plan_splits(B, Hkv, nb, SM)
    assert splits > 1
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    o, l, m = _split_merged(*args, splits, **kw)
    wo, wl, wm = pda.paged_decode_attention(
        q, kp, vp, bt, lens, block_positions=pos, k_scale=ks, v_scale=vs,
        return_partials=True, **kw)
    for got, want in ((o, wo), (l, wl), (m, wm)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert (o[1] == 0).all() and (l[1] == 0).all()      # cache_len 0
    assert (m[1] == np.float32(pda.NEG_INF)).all()


@pytest.mark.parametrize("G,hd,bs,nb,sw,sinks,cap,int8,pos_pad",
                         [MERGE_CASES[i] for i in (0, 1, 3, 5)])
def test_split_merge_equals_jax_kernel(G, hd, bs, nb, sw, sinks, cap, int8,
                                       pos_pad):
    B, Hkv = 3, 2
    arrays = _inputs(nb + G + 1, B, Hkv, G, hd, bs, nb, int8=int8,
                     pos_pad=pos_pad)
    q, kp, vp, ks, vs, bt, lens, pos = arrays
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    jkw = dict(kw)
    if int8:
        jkw.update(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = j_paged_decode_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), block_positions=jnp.asarray(pos), interpret=True,
        return_partials=True, **jkw)
    splits = pda.plan_splits(B, Hkv, nb, SM)
    got = _split_merged(*[None if x is None else torch.from_numpy(x)
                          for x in arrays], splits, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
