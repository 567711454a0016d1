"""The split-KV plan of the port's dense-cache decode kernel, on the CPU.

The CUDA kernel (``csrc/decode_attention.cu``) cuts each sequence's cache
rows into S ranges of whole 16-row units (``plan_splits``,
``split_ranges``), runs one CTA per range and merges the ranges' (o, l, m)
partials by the §4.2.2 rule in the same launch. Here, without a card:

* the planner covers every cache row exactly once, leaves no split empty
  of rows, keeps G = 16 within its halved split cap, and gives at least
  two CTAs a SM wherever the cache has the rows (and the cap the splits),
  except where the (sequence, kv head) pairs alone give every SM a CTA:
  those caches are not split (a split there adds only the merge's chain);
* merging the plain twin's partials over the planner's ranges with
  ``repro_torch.core.combine`` equals the unsplit plain twin, and the JAX
  package's own functions, on the same numpy inputs: the Pallas kernel
  (interpret mode) for full-precision caches, the reference's jnp partial
  with scales for int8 caches; with windows that mask whole splits, sinks,
  softcaps, a sequence with cache_len 0, hd = 112 and G = 16;
* an emulation of the kernel's rounding, written here (bf16 q and K as
  stored, fp32 scores scaled after the product, P or p · v_scale split
  into bf16 hi + lo for PV, 16-row chunks dealt to 4 warps), stays within
  the card's tolerance of the fp32 twin, and the hi + lo split is what
  keeps it there.

Inputs are fp32 (int8 caches with fp32 scales) from numpy seeds. Tolerance
1e-5: the same fp32 math summed in another grouping.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import \
    decode_attention as j_decode_kernel
from repro.models.attention import decode_attention_partial_jnp
from repro_torch.core import combine as tC
from repro_torch.kernels import decode_attention as da
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
SM = 132                     # the H100's SM count
# the card's gate (chip_smoke.check_close): bf16 o within 2 ulp relative
# plus a floor; l relative 1e-3; m absolute 1e-3
O_RTOL, O_ATOL = 8e-3, 1e-3


# (B, Hkv, S, G): glm4-9b at 2K and 16K, zamba2, llama3-8b, kimi-k2, tiny
# and empty caches, a batch large enough for one split, caches past the
# split caps at G = 16 and G = 1, ragged S
PLAN_CASES = [(8, 2, 2048, 16), (8, 2, 16384, 16), (8, 32, 2080, 1),
              (8, 8, 2048, 4), (8, 8, 2048, 8), (1, 1, 1, 1), (1, 1, 16, 16),
              (2, 2, 48, 4), (1, 1, 200000, 16), (1, 1, 200000, 1),
              (3, 5, 77, 2), (8, 8, 0, 4), (64, 8, 128, 4), (1, 2, 100, 16)]


@pytest.mark.parametrize("B,Hkv,S,G", PLAN_CASES)
def test_plan_splits_covers_each_row_once_and_fills_the_card(B, Hkv, S, G):
    splits = da.plan_splits(B, Hkv, S, SM, G)
    ranges = da.split_ranges(S, splits)
    assert len(ranges) == splits >= 1
    covered = [r for lo, hi in ranges for r in range(lo, hi)]
    assert covered == list(range(S))                # each row exactly once
    units = -(-S // da.SPLIT_UNIT)
    if S:
        assert all(hi > lo for lo, hi in ranges)    # no split without rows
        assert all(lo % da.SPLIT_UNIT == 0 for lo, _ in ranges)
        assert splits <= units
    else:
        assert splits == 1
    assert splits <= da.max_splits(G)
    if B * Hkv >= SM:                               # every SM has a CTA
        assert splits == 1
    elif units >= -(-2 * SM // (B * Hkv)):          # enough rows for it
        assert B * Hkv * splits >= min(2 * SM, B * Hkv * da.max_splits(G))
    geo = da.launch_geometry(B, Hkv, S, SM, G)
    assert geo["ctas"] == B * Hkv * splits
    assert geo["grid"] == [splits, Hkv, B]
    assert geo["rows_per_split"] == max((hi - lo for lo, hi in ranges),
                                        default=0)
    assert geo["design"] == ("mma.sync m16n8k16"
                             if G >= da.TENSOR_CORE_MIN_G
                             else "cuda-core lanes")


def test_plan_splits_caps_g16_and_never_reads_the_device():
    """G = 16 holds half the splits (its merge keeps twice the (m, l)
    pairs a split); the plan is a function of shapes only: a one-SM card
    takes one split where one CTA a SM is reached; zamba2's 256 pairs
    are not split, glm4-9b's 16 are split 17 ways, llama3-8b's 64 five."""
    assert da.max_splits(16) == da.MAX_SPLITS // 2
    assert da.max_splits(8) == da.max_splits(1) == da.MAX_SPLITS
    assert da.plan_splits(1, 1, 1 << 20, SM, 16) == da.MAX_SPLITS // 2
    assert da.plan_splits(1, 1, 1 << 20, SM, 8) == da.CTAS_PER_SM * SM
    assert da.plan_splits(8, 8, 2048, 1, 4) == 1
    assert da.plan_splits(1, 1, 2048, 2, 4) == 2 * da.CTAS_PER_SM
    assert da.plan_splits(8, 32, 2080, SM, 1) == 1
    assert da.plan_splits(8, 2, 16384, SM, 16) == 17
    assert da.plan_splits(8, 8, 2048, SM, 4) == 5


def _inputs(seed, B, Hkv, G, hd, S, *, int8):
    """fp32 queries over fp32 caches (or int8 caches with positive fp32
    scales); lengths: the full cache, an empty sequence, ragged rest."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    if int8:
        kc = rng.integers(-127, 128, size=(B, Hkv, S, hd)).astype(np.int8)
        vc = rng.integers(-127, 128, size=(B, Hkv, S, hd)).astype(np.int8)
        ks = rng.uniform(0.002, 0.03, size=(B, Hkv, S)).astype(np.float32)
        vs = rng.uniform(0.002, 0.03, size=(B, Hkv, S)).astype(np.float32)
    else:
        kc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
        vc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
        ks = vs = None
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    lens[0], lens[1] = S, 0
    return q, kc, vc, ks, vs, lens


def _split_partial(q, kc, vc, ks, vs, lens, lo, hi, *, sliding_window,
                   attention_sinks, logit_softcap):
    """The plain twin over cache rows [lo, hi) only: the rows shifted to
    0, cache_len and the sinks shifted with them (the window, anchored to
    cache_len, moves along)."""
    sl = slice(lo, hi)
    scales = {} if ks is None else dict(k_scale=ks[:, :, sl].contiguous(),
                                        v_scale=vs[:, :, sl].contiguous())
    return da.decode_attention(
        q, kc[:, :, sl].contiguous(), vc[:, :, sl].contiguous(), lens - lo,
        sliding_window=sliding_window,
        attention_sinks=max(attention_sinks - lo, 0),
        logit_softcap=logit_softcap, return_partials=True, **scales)


def _split_merged(q, kc, vc, ks, vs, lens, splits, **kw):
    """The plain twin on each split's rows, merged with core.combine:
    what the kernel's one launch computes."""
    parts = []
    for lo, hi in da.split_ranges(kc.shape[2], splits):
        o, l, m = _split_partial(q, kc, vc, ks, vs, lens, lo, hi, **kw)
        parts.append(tC.Partial(a=o * l[..., None], s=l, m=m))
    merged = tC.combine_many(parts)
    return tC.finalize(merged), merged.s, merged.m


# (G, hd, S, window, sinks, softcap, int8)
MERGE_CASES = [
    (16, 128, 300, 0, 0, 0.0, False),     # glm4-9b's G = 16
    (16, 112, 300, 0, 0, 30.0, True),     # G = 16 at hd = 112, int8, cap
    (8, 112, 256, 40, 3, 0.0, False),     # window masks whole splits; sinks
    (4, 64, 500, 50, 2, 50.0, True),      # ... over an int8 cache
    (1, 64, 200, 0, 0, 0.0, False),       # zamba2's G = 1
    (2, 128, 333, 17, 0, 0.0, True)]      # window, no sinks, ragged S


@pytest.mark.parametrize("G,hd,S,sw,sinks,cap,int8", MERGE_CASES)
def test_split_merge_equals_unsplit_plain(G, hd, S, sw, sinks, cap, int8):
    B, Hkv = 3, 1
    q, kc, vc, ks, vs, lens = [None if x is None else torch.from_numpy(x)
                               for x in _inputs(S + G, B, Hkv, G, hd, S,
                                                int8=int8)]
    splits = da.plan_splits(B, Hkv, S, SM, G)
    assert splits > 1
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    o, l, m = _split_merged(q, kc, vc, ks, vs, lens, splits, **kw)
    wo, wl, wm = da.decode_attention(q, kc, vc, lens, k_scale=ks,
                                     v_scale=vs, return_partials=True, **kw)
    for got, want in ((o, wo), (l, wl), (m, wm)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert (o[1] == 0).all() and (l[1] == 0).all()      # cache_len 0
    assert (m[1] == np.float32(da.NEG_INF)).all()
    if sw:        # some split holds no live row: its partial is empty
        parts = [_split_partial(q, kc, vc, ks, vs, lens, lo, hi, **kw)
                 for lo, hi in da.split_ranges(S, splits)]
        assert any(bool((p[1][0] == 0).all()) for p in parts)


@pytest.mark.parametrize("G,hd,S,sw,sinks,cap,int8",
                         [MERGE_CASES[i] for i in (0, 1, 2, 3)])
def test_split_merge_equals_jax(G, hd, S, sw, sinks, cap, int8):
    """Full-precision caches against the Pallas kernel in interpret mode;
    int8 caches against the reference's jnp partial with scales (the path
    its int8 dense caches take), anchored to cache_len as the kernel is."""
    B, Hkv = 3, 1
    arrays = _inputs(S + G + 1, B, Hkv, G, hd, S, int8=int8)
    q, kc, vc, ks, vs, lens = arrays
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    splits = da.plan_splits(B, Hkv, S, SM, G)
    o, l, m = _split_merged(*[None if x is None else torch.from_numpy(x)
                              for x in arrays], splits, **kw)
    if not int8:
        want = j_decode_kernel(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(lens),
                               interpret=True, return_partials=True, **kw)
        for g, w in zip((o, l, m), want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        return
    H = Hkv * G
    want = decode_attention_partial_jnp(
        jnp.asarray(q.reshape(B, H, hd)), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(lens), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        window_total=jnp.asarray(lens), **kw)
    live = lens > 0      # an empty row: the reference's m is -inf, ours
    a = (o * l[..., None]).reshape(B, H, hd).numpy()   # the finite sentinel
    np.testing.assert_allclose(a[live], np.asarray(want.a)[live], **TOL)
    np.testing.assert_allclose(l.reshape(B, H).numpy()[live],
                               np.asarray(want.s)[live], **TOL)
    np.testing.assert_allclose(m.reshape(B, H).numpy()[live],
                               np.asarray(want.m)[live], **TOL)
    assert (l.numpy()[~live] == 0).all()


# ---------------------------------------------------------------------------
# the kernel's rounding, emulated
# ---------------------------------------------------------------------------
def _bf16(x):
    return x.to(torch.bfloat16).float()


def _live_positions(n_rows, clen, lo, hi, sw, sinks):
    """The live cache rows of split [lo, hi) in the kernel's order: the
    sinks' run, then the window's."""
    pos = torch.arange(lo, min(hi, n_rows))
    valid = pos < clen
    if sw > 0:
        valid &= (pos >= clen - sw) | (pos < sinks)
    return pos[valid]


def _emulate(q, kc, vc, ks, vs, lens, *, sliding_window, attention_sinks,
             logit_softcap, hi_lo=True):
    """The kernel's arithmetic for G >= 8: per split, 16-row chunks of the
    live rows dealt to 4 warps (chunks w, w + 4, ...); S = Q·Kᵀ of bf16 q
    and K as stored, summed in fp32, then scaled (and k-dequantized,
    capped) in fp32; an online softmax per warp; PV's A operand, p or
    p · v_scale, as bf16 hi + lo (or hi alone); the warps' and the splits'
    partials merged by the §4.2.2 rule. Returns fp32 (o, l, m)."""
    B, Hkv, G, hd = q.shape
    S = kc.shape[2]
    splits = da.plan_splits(B, Hkv, S, SM, G)
    scale = 1.0 / np.sqrt(hd)
    o = torch.zeros(B, Hkv, G, hd)
    l = torch.zeros(B, Hkv, G)
    m = torch.full((B, Hkv, G), da.NEG_INF)
    for b in range(B):
        for h in range(Hkv):
            qb = _bf16(q[b, h])
            parts = []
            for lo, hi in da.split_ranges(S, splits):
                rows = _live_positions(S, int(lens[b]), lo, hi,
                                       sliding_window, attention_sinks)
                chunks = [rows[i:i + 16] for i in range(0, len(rows), 16)]
                for w in range(4):
                    acc = torch.zeros(G, hd)
                    mr = torch.full((G,), da.NEG_INF)
                    lr = torch.zeros(G)
                    for ch in chunks[w::4]:
                        k = kc[b, h, ch].float()
                        v = vc[b, h, ch].float()
                        s = (qb @ k.T) * scale
                        if ks is not None:
                            s = s * ks[b, h, ch]
                        if logit_softcap > 0:
                            s = logit_softcap * torch.tanh(s / logit_softcap)
                        m_new = torch.maximum(mr, s.amax(-1))
                        alpha = torch.exp(mr - m_new)
                        p = torch.exp(s - m_new[:, None])
                        lr = lr * alpha + p.sum(-1)
                        pw = p if vs is None else p * vs[b, h, ch]
                        ph = _bf16(pw)
                        pl = _bf16(pw - ph) if hi_lo else torch.zeros_like(pw)
                        acc = acc * alpha[:, None] + pl @ v + ph @ v
                        mr = m_new
                    parts.append(tC.Partial(a=acc, s=lr, m=mr))
            merged = tC.combine_many(parts)
            o[b, h] = tC.finalize(merged)
            l[b, h], m[b, h] = merged.s, merged.m
    return o, l, m


@pytest.mark.parametrize("G,hd,S,sw,sinks,cap,int8", [
    (16, 128, 300, 0, 0, 0.0, False), (16, 112, 300, 0, 0, 30.0, True),
    (8, 112, 256, 40, 3, 0.0, False), (16, 64, 200, 0, 0, 0.0, True)])
def test_kernel_rounding_stays_within_the_card_tolerance(G, hd, S, sw, sinks,
                                                         cap, int8):
    B, Hkv = 3, 1
    q, kc, vc, ks, vs, lens = [None if x is None else torch.from_numpy(x)
                               for x in _inputs(S + 7 * G, B, Hkv, G, hd, S,
                                                int8=int8)]
    q = _bf16(q)
    if not int8:                     # bf16 caches, as the card holds them
        kc, vc = _bf16(kc), _bf16(vc)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    po, pl, pm = da.decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs,
                                     return_partials=True, **kw)
    eo, el, em = _emulate(q, kc, vc, ks, vs, lens, **kw)
    got, want = eo.bfloat16().float(), po.bfloat16().float()
    assert ((got - want).abs() <= O_ATOL + O_RTOL * want.abs()).all()
    np.testing.assert_allclose(el.numpy(), pl.numpy(), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(em.numpy(), pm.numpy(), rtol=0, atol=1e-3)
    # the hi + lo split keeps P to 2^-17 of itself: the fp32 result sits
    # far closer to the twin than with P rounded to bf16 once
    err = float((eo - po).abs().max())
    one = float((_emulate(q, kc, vc, ks, vs, lens, hi_lo=False, **kw)[0]
                 - po).abs().max())
    assert err < 1e-5 * float(po.abs().max()) and err * 64 < one
