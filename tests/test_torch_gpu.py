"""The port's CUDA kernels (paged decode and chunk prefill over bf16 and
int8 pools, dense-cache decode, the Mamba2 and RWKV6 scans and their
backward kernels) against their plain PyTorch twins, on the card; and
the engine's compiled programs
(CUDA graph replays of the decode step and of the chunk step, the one-shot
prefill and the suffix prefill) against the eager programs at the same
operands, bit for bit.

Marked ``gpu``: without a CUDA device every test skips (the kernels are
CUDA C++ for sm_90a and have no interpret mode). The file imports neither
JAX nor the JAX package, so it also runs on a GPU host without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Tolerances: bf16 outputs within 2 ulp relative (8e-3) plus a 1e-3 floor —
the kernel and its twin both accumulate in fp32 and differ by summation
order and exp approximation before the final bf16 rounding; l and m are
fp32 (1e-3). The scan kernels take their chunked products in three bf16
passes (hi + lo, ~1e-5 of each product) against the fp32 step twins:
1e-4 relative plus 1e-4 of the output's largest entry. A replay runs the
same kernels on the same inputs as the eager step: no tolerance.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.kernels import ssm_scan as ssm
from repro_torch.tree import tree_map


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for "
                    "sm_90a and have no interpret mode")
    return torch.device("cuda")


def _bf16(x, dev):
    return torch.from_numpy(np.asarray(x)).to(dev).bfloat16()


@pytest.mark.gpu
@pytest.mark.parametrize("G,sw,sinks,cap", [(4, 0, 0, 0.0), (2, 40, 4, 50.0),
                                            (8, 0, 0, 0.0), (1, 9, 0, 0.0)])
def test_cuda_decode_kernel_matches_plain(cuda, G, sw, sinks, cap):
    q, kp, vp, bt, lens = _rand_paged(G, 5, 2, G, 128, 16, 6)
    kp[:, 0] = np.nan                        # padded slots point here
    args = (_bf16(q, cuda), _bf16(kp, cuda), _bf16(vp, cuda),
            torch.from_numpy(bt).to(cuda), torch.from_numpy(lens).to(cuda))
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap,
              return_partials=True)
    got = pda.paged_decode_attention(*args, **kw)
    want = pda.paged_decode_attention_plain(*args, **kw)
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=1e-3)


# Split-KV decode cases: long tables span many splits (plan_splits; the
# grid is (S, Hkv, B)), whole splits fall outside a window (or past a short
# cache_len), one sequence has cache_len 0, one row of block_positions is
# all POS_PAD, the pools may be the head partition's contiguous Hkv/2 slice,
# block sizes 1, 8, 12 and 32 cut rows across slots. Every value (bf16) or
# scale (int8) the masks drop is NaN.
SPLIT_CASES = [  # G, hd, bs, nb, window, sinks, softcap, pos_pad, half_pool
    (4, 128, 16, 128, 0, 0, 0.0, False, False),
    (4, 128, 16, 128, 0, 0, 0.0, False, True),
    (4, 128, 16, 96, 100, 4, 0.0, False, False),
    (2, 128, 16, 64, 300, 0, 50.0, True, False),
    (8, 64, 16, 40, 0, 0, 0.0, True, True),
    (1, 64, 1, 700, 33, 2, 0.0, False, False),
    (4, 128, 8, 90, 0, 0, 30.0, False, True),
    (2, 64, 12, 50, 77, 3, 0.0, True, False),
    (4, 128, 32, 33, 0, 0, 0.0, False, False),
    (8, 128, 32, 20, 50, 0, 0.0, False, True)]


def _split_inputs(seed, G, hd, bs, nb, pos_pad, half):
    """B = 4 sequences over Hkv = 4 kv heads (2 when the pool is the head
    partition's slice): lengths up to nb·bs, the second 0; pad slots and
    every row past a sequence's cache_len hold NaN."""
    rng = np.random.default_rng(seed)
    B, Hkv = 4, 4
    NB = B * nb + 2
    kp = rng.standard_normal((Hkv, NB, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((Hkv, NB, bs, hd)).astype(np.float32)
    lens = rng.integers(1, nb * bs + 1, size=B).astype(np.int32)
    lens[0], lens[1] = nb * bs, 0
    perm = rng.permutation(np.arange(1, NB))[:B * nb].reshape(B, nb)
    bt = np.zeros((B, nb), np.int32)
    stale = np.zeros((NB, bs), bool)
    stale[0] = True
    for b in range(B):
        live = -(-int(lens[b]) // bs)
        bt[b, :live] = perm[b, :live]
        if live:
            stale[bt[b, live - 1], int(lens[b]) - (live - 1) * bs:] = True
    pos = None
    if pos_pad:             # a block-sharded table; row 3 owns no slot
        pos = np.tile(np.arange(nb, dtype=np.int32) * bs, (B, 1))
        pos[:, 1::2] = pda.POS_PAD
        pos[3] = pda.POS_PAD
        bt[:, 1::2] = 0
    q = rng.standard_normal((B, Hkv // 2 if half else Hkv, G, hd))
    return q, kp, vp, bt, lens, stale, pos


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G,hd,bs,nb,sw,sinks,cap,pos_pad,half", SPLIT_CASES)
def test_cuda_split_decode_matches_plain(cuda, int8, G, hd, bs, nb, sw,
                                         sinks, cap, pos_pad, half):
    q, kp, vp, bt, lens, stale, pos = _split_inputs(
        nb + bs + G, G, hd, bs, nb, pos_pad, half)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap,
              return_partials=True, block_positions=None if pos is None
              else torch.from_numpy(pos).to(cuda))
    if int8:
        kpool, ks = _int8_pool(kp, cuda)
        vpool, vs = _int8_pool(vp, cuda)
        ks[:, torch.from_numpy(stale).to(cuda)] = float("nan")
        vs[:, torch.from_numpy(stale).to(cuda)] = float("nan")
        kw.update(k_scale=ks, v_scale=vs)
    else:
        kp[:, stale] = np.nan
        vp[:, stale] = np.nan
        kpool, vpool = _bf16(kp, cuda), _bf16(vp, cuda)
    if half:    # the head partition's worker: a contiguous Hkv/2 slice
        sl = slice(2, 4)
        kpool, vpool = kpool[sl], vpool[sl]
        if int8:
            kw.update(k_scale=ks[sl], v_scale=vs[sl])
    args = (_bf16(q, cuda), kpool, vpool, torch.from_numpy(bt).to(cuda),
            torch.from_numpy(lens).to(cuda))
    geo = pda.launch_geometry(4, kpool.shape[0], nb, _cuda.sm_count(cuda))
    assert geo["splits"] > 1
    want = pda.paged_decode_attention_plain(*args, **kw)
    for _ in range(2):      # a second call: the merge tickets were reset
        got = pda.paged_decode_attention(*args, **kw)
        for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
            torch.testing.assert_close(a.float(), b.float(), rtol=tol,
                                       atol=1e-3)
    o, l, m = got
    assert (o[1] == 0).all() and (l[1] == 0).all()       # cache_len 0
    assert (m[1] == pda.NEG_INF).all()
    if pos_pad:                                          # all POS_PAD
        assert (l[3] == 0).all() and (m[3] == pda.NEG_INF).all()


# Chunk-prefill cases: the tensor-core kernel packs 64 query rows (G heads
# x 64/G positions) per CTA and walks 64-key tiles, so C = 63/64/65 and
# C = 1 sit on its row-tile edges, nb = 0 has no prefix, G covers every
# packing, hd = 64 and 128 both layouts; windows end inside a key tile
# (with sinks and softcap, and tiles skipped before the window).
PREFILL_CASES = [  # G, hd, C, nb, window, sinks, softcap, block size
    (4, 128, 100, 5, 0, 0, 0.0, 16), (2, 128, 64, 0, 0, 0, 0.0, 16),
    (4, 128, 77, 7, 50, 4, 50.0, 16), (1, 128, 1, 7, 0, 0, 0.0, 16),
    (8, 128, 63, 9, 0, 0, 0.0, 16), (1, 64, 64, 3, 0, 0, 0.0, 16),
    (2, 64, 65, 0, 0, 0, 0.0, 16), (8, 64, 300, 10, 0, 0, 0.0, 16),
    (4, 128, 300, 11, 100, 4, 30.0, 16), (1, 128, 65, 11, 70, 3, 50.0, 16),
    (4, 64, 63, 4, 37, 2, 20.0, 16), (2, 128, 1, 0, 0, 0, 0.0, 16),
    (8, 128, 300, 6, 90, 0, 0.0, 16),
    # block sizes: TMA boxes of 1, 2, 4, 8, 32 and 64 rows, a block that
    # spans two key tiles (128), and 12 (boxes of 4 that are not a block)
    (2, 64, 65, 13, 0, 0, 0.0, 1), (1, 128, 63, 11, 0, 0, 0.0, 1),
    (1, 64, 40, 7, 9, 2, 0.0, 2), (4, 128, 100, 9, 0, 0, 0.0, 4),
    (4, 128, 65, 0, 0, 0, 0.0, 4), (8, 128, 77, 6, 50, 4, 50.0, 8),
    (4, 64, 300, 5, 0, 0, 0.0, 12), (2, 128, 130, 3, 100, 4, 30.0, 32),
    (4, 128, 64, 2, 0, 0, 0.0, 128), (8, 64, 1, 3, 0, 0, 0.0, 128)]


def _prefill_pools(rng, Hkv, hd, bs, nb):
    """Random float pools with 5 blocks past the table, a table of nb
    distinct blocks, and the mask of blocks the table does not name."""
    NB = nb + 5
    kp = rng.standard_normal((Hkv, NB, bs, hd))
    vp = rng.standard_normal((Hkv, NB, bs, hd))
    table = rng.permutation(NB)[:nb].astype(np.int32)
    unref = np.ones(NB, bool)
    unref[table] = False
    return kp, vp, torch.from_numpy(table), torch.from_numpy(unref)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd,C,nb,sw,sinks,cap,bs", PREFILL_CASES)
def test_cuda_prefill_kernel_matches_plain(cuda, G, hd, C, nb, sw, sinks,
                                           cap, bs):
    rng = np.random.default_rng(C + 1000 * G + hd +
                                (0 if bs == 16 else 10000 * bs))
    Hkv = 2
    kp, vp, table, unref = _prefill_pools(rng, Hkv, hd, bs, nb)
    kp[:, unref.numpy()] = np.nan           # the kernel must never load them
    vp[:, unref.numpy()] = np.nan
    args = (_bf16(rng.standard_normal((C, Hkv * G, hd)), cuda),
            _bf16(kp, cuda), _bf16(vp, cuda), table.to(cuda),
            _bf16(rng.standard_normal((C, Hkv, hd)), cuda),
            _bf16(rng.standard_normal((C, Hkv, hd)), cuda))
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    got = ppa.paged_prefill_chunk_attention(*args, **kw)
    want = ppa.paged_prefill_chunk_attention_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-3)


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_and_refuse_what_they_do_not_take(cuda):
    q, kp, vp, bt, lens = _rand_paged(0, 2, 2, 4, 64, 16, 3)   # hd = 64
    args = [_bf16(q, cuda), _bf16(kp, cuda), _bf16(vp, cuda),
            torch.from_numpy(bt).to(cuda), torch.from_numpy(lens).to(cuda)]
    n = pda.paged_decode_attention.launches
    got = pda.paged_decode_attention(*args)
    assert pda.paged_decode_attention.launches == n + 1
    torch.testing.assert_close(
        got.float(), pda.paged_decode_attention_plain(*args).float(),
        rtol=8e-3, atol=1e-3)
    assert pda.paged_decode_attention.launches == n + 1   # plain: no count
    with pytest.raises(TypeError):                        # fp32 on the card
        pda.paged_decode_attention(args[0].float(), *args[1:])
    with pytest.raises(ValueError):                       # G = 3
        pda.paged_decode_attention(
            torch.zeros((2, 2, 3, 64), dtype=torch.bfloat16, device=cuda),
            *args[1:])
    n = ppa.paged_prefill_chunk_attention.launches
    ppa.paged_prefill_chunk_attention(
        torch.zeros((5, 8, 64), dtype=torch.bfloat16, device=cuda), args[1],
        args[2], args[3][0].contiguous(),
        torch.zeros((5, 2, 64), dtype=torch.bfloat16, device=cuda),
        torch.zeros((5, 2, 64), dtype=torch.bfloat16, device=cuda))
    assert ppa.paged_prefill_chunk_attention.launches == n + 1


def _int8_pool(x, dev):
    """Quantize a float pool (Hkv, NB, bs, hd) per token: int8 values and
    fp32 scales (Hkv, NB, bs) on the card."""
    from repro_torch.models.kv_quant import quantize_kv
    q, s = quantize_kv(torch.from_numpy(np.asarray(x, np.float32)))
    return q.to(dev), s.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("G,sw,sinks,cap", [(4, 0, 0, 0.0), (2, 40, 4, 50.0),
                                            (8, 0, 0, 0.0), (1, 9, 0, 0.0)])
def test_cuda_int8_decode_kernel_matches_plain(cuda, G, sw, sinks, cap):
    q, kp, vp, bt, lens = _rand_paged(G + 10, 5, 2, G, 128, 16, 6)
    kq, ks = _int8_pool(kp, cuda)
    vq, vs = _int8_pool(vp, cuda)
    ks[:, 0] = float("nan")                  # padded slots point here
    vs[:, 0] = float("nan")
    args = (_bf16(q, cuda), kq, vq, torch.from_numpy(bt).to(cuda),
            torch.from_numpy(lens).to(cuda))
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=sw,
              attention_sinks=sinks, logit_softcap=cap, return_partials=True)
    got = pda.paged_decode_attention(*args, **kw)
    want = pda.paged_decode_attention_plain(*args, **kw)
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd,C,nb,sw,sinks,cap,bs", PREFILL_CASES)
def test_cuda_int8_prefill_kernel_matches_plain(cuda, G, hd, C, nb, sw,
                                                sinks, cap, bs):
    rng = np.random.default_rng(C + 1000 * G + hd + 1 +
                                (0 if bs == 16 else 10000 * bs))
    Hkv = 2
    kp, vp, table, unref = _prefill_pools(rng, Hkv, hd, bs, nb)
    kq, ks = _int8_pool(kp, cuda)
    vq, vs = _int8_pool(vp, cuda)
    ks[:, unref.to(cuda)] = float("nan")    # the kernel must never load them
    vs[:, unref.to(cuda)] = float("nan")
    args = (_bf16(rng.standard_normal((C, Hkv * G, hd)), cuda), kq, vq,
            table.to(cuda), _bf16(rng.standard_normal((C, Hkv, hd)), cuda),
            _bf16(rng.standard_normal((C, Hkv, hd)), cuda))
    kw = dict(k_scale=ks, v_scale=vs, sliding_window=sw,
              attention_sinks=sinks, logit_softcap=cap)
    got = ppa.paged_prefill_chunk_attention(*args, **kw)
    want = ppa.paged_prefill_chunk_attention_plain(*args, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-3)


@pytest.mark.gpu
def test_cuda_int8_wrappers_count_launches_and_need_fp32_scales(cuda):
    q, kp, vp, bt, lens = _rand_paged(1, 2, 2, 4, 64, 16, 3)   # hd = 64
    kq, ks = _int8_pool(kp, cuda)
    vq, vs = _int8_pool(vp, cuda)
    args = [_bf16(q, cuda), kq, vq, torch.from_numpy(bt).to(cuda),
            torch.from_numpy(lens).to(cuda)]
    n, n16 = (pda.paged_decode_attention_int8.launches,
              pda.paged_decode_attention.launches)
    pda.paged_decode_attention(*args, k_scale=ks, v_scale=vs)
    assert pda.paged_decode_attention_int8.launches == n + 1
    assert pda.paged_decode_attention.launches == n16     # bf16 untouched
    with pytest.raises(TypeError):                        # bf16 scales
        pda.paged_decode_attention(*args, k_scale=ks.bfloat16(),
                                   v_scale=vs.bfloat16())
    with pytest.raises(TypeError):                        # int8, no scales
        pda.paged_decode_attention(*args)
    with pytest.raises(ValueError):                       # one scale pool
        pda.paged_decode_attention(*args, k_scale=ks)
    n = ppa.paged_prefill_chunk_attention_int8.launches
    chunk = torch.zeros((5, 2, 64), dtype=torch.bfloat16, device=cuda)
    ppa.paged_prefill_chunk_attention(
        torch.zeros((5, 8, 64), dtype=torch.bfloat16, device=cuda), kq, vq,
        args[3][0].contiguous(), chunk, chunk, k_scale=ks, v_scale=vs)
    assert ppa.paged_prefill_chunk_attention_int8.launches == n + 1
    with pytest.raises(TypeError):
        ppa.paged_prefill_chunk_attention(
            torch.zeros((5, 8, 64), dtype=torch.bfloat16, device=cuda), kq,
            vq, args[3][0].contiguous(), chunk, chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd,sw,sinks,cap", [(1, 64, 0, 0, 0.0),
                                               (4, 128, 0, 0, 0.0),
                                               (2, 128, 40, 4, 50.0),
                                               (8, 64, 9, 0, 0.0)])
def test_cuda_dense_decode_kernel_matches_plain(cuda, G, hd, sw, sinks, cap):
    rng = np.random.default_rng(G * 7 + hd)
    B, Hkv, S = 5, 3, 300
    kc = rng.standard_normal((B, Hkv, S, hd))
    vc = rng.standard_normal((B, Hkv, S, hd))
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    lens[0] = S
    lens[1] = 1
    for b, n in enumerate(lens):             # stale slots past cache_len
        kc[b, :, n:] = np.nan
        vc[b, :, n:] = np.nan
    args = (_bf16(rng.standard_normal((B, Hkv, G, hd)), cuda),
            _bf16(kc, cuda), _bf16(vc, cuda), torch.from_numpy(lens).to(cuda))
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    n = da.decode_attention.launches
    got = da.decode_attention(*args, return_partials=True, **kw)
    o = da.decode_attention(*args, **kw)
    assert da.decode_attention.launches == n + 2
    want = da.decode_attention_plain(*args, return_partials=True, **kw)
    torch.testing.assert_close(o.float(), want[0].float(), rtol=8e-3,
                               atol=1e-3)
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=1e-3)


@pytest.mark.gpu
def test_cuda_dense_decode_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((2, 2, 4, 64), dtype=torch.bfloat16, device=cuda)
    kc = torch.zeros((2, 2, 16, 64), dtype=torch.bfloat16, device=cuda)
    lens = torch.full((2,), 16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):                        # fp32 on the card
        da.decode_attention(q.float(), kc.float(), kc.float(), lens)
    with pytest.raises(ValueError):                       # G = 3
        da.decode_attention(q[:, :, :3].contiguous(), kc, kc, lens)
    with pytest.raises(ValueError):                       # strided cache
        da.decode_attention(q, kc[:, :, ::2], kc[:, :, ::2], lens)


# The shapes widened for glm4-9b (G = 16) and kimi-k2 (hd = 112): the split
# decode kernel over bf16 and int8 pools (G = 16 at hd 64, 112 and 128; hd =
# 112 at every G), NaN in the pad blocks and past every cache_len.
WIDE_DECODE_CASES = [  # G, hd, bs, nb, window, sinks, softcap, pos_pad, half
    (16, 128, 16, 128, 0, 0, 0.0, False, False),
    (16, 128, 16, 96, 300, 4, 30.0, False, True),
    (16, 64, 16, 64, 0, 0, 0.0, True, False),
    (16, 64, 8, 90, 77, 3, 0.0, False, False),
    (16, 112, 16, 128, 0, 0, 50.0, False, False),
    (8, 112, 16, 96, 0, 0, 0.0, False, True),
    (4, 112, 12, 50, 100, 4, 0.0, True, False),
    (2, 112, 1, 700, 33, 2, 0.0, False, False),
    (1, 112, 32, 20, 0, 0, 0.0, False, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G,hd,bs,nb,sw,sinks,cap,pos_pad,half",
                         WIDE_DECODE_CASES)
def test_cuda_widened_decode_matches_plain(cuda, int8, G, hd, bs, nb, sw,
                                           sinks, cap, pos_pad, half):
    test_cuda_split_decode_matches_plain(cuda, int8, G, hd, bs, nb, sw,
                                         sinks, cap, pos_pad, half)


# The bf16 entry's tensor-core design (G >= pda.TENSOR_CORE_MIN_G: the G
# query heads of a kv head are the M rows of mma.sync) at G = 8 and 16, hd
# 64, 112 and 128: block size 16 (a 16-row chunk is one block) and 1, 12,
# 24, 32 and 1024, the largest (chunks straddle blocks, or a block holds
# several), a window with sinks and a softcap, block positions with
# POS_PAD, the head partition's pool slice; NaN in every row no mask keeps
# (_split_inputs).
TC_DECODE_CASES = [  # G, hd, bs, nb, window, sinks, softcap, pos_pad, half
    (16, 128, 16, 128, 0, 0, 0.0, False, False),
    (8, 128, 16, 96, 0, 0, 0.0, False, True),
    (16, 64, 12, 70, 0, 0, 0.0, False, False),
    (8, 64, 16, 64, 300, 4, 30.0, False, False),
    (16, 112, 16, 96, 500, 4, 50.0, True, False),
    (8, 112, 24, 40, 0, 0, 0.0, True, True),
    (16, 128, 1, 700, 33, 2, 0.0, False, False),
    (16, 128, 12, 50, 77, 3, 30.0, True, False),
    (8, 128, 32, 33, 0, 0, 0.0, False, False),
    (16, 64, 1024, 3, 0, 0, 0.0, False, False),
    (8, 128, 1024, 4, 1500, 4, 0.0, True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd,bs,nb,sw,sinks,cap,pos_pad,half",
                         TC_DECODE_CASES)
def test_cuda_tc_decode_matches_plain(cuda, G, hd, bs, nb, sw, sinks, cap,
                                      pos_pad, half):
    """The tensor-core design against the twin at the lanes' tolerance,
    every call counted as a tensor-core launch."""
    fn = pda.paged_decode_attention
    assert pda.on_tensor_cores(G)
    n, n_tc = fn.launches, fn.tc_launches
    test_cuda_split_decode_matches_plain(cuda, False, G, hd, bs, nb, sw,
                                         sinks, cap, pos_pad, half)
    assert fn.launches - n == 2 and fn.tc_launches - n_tc == 2


def _tc_inputs(cuda, seed, B, Hkv, G, hd, bs, nb):
    """Random bf16 pools and q on the card, a table of distinct blocks a
    sequence, ragged lengths (the first full); every row past a
    sequence's cache_len is NaN."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    NB = B * nb + 1
    kp = torch.randn((Hkv, NB, bs, hd), generator=gen,
                     device=cuda).bfloat16()
    vp = torch.randn(kp.shape, generator=gen, device=cuda).bfloat16()
    lens = torch.randint(1, nb * bs + 1, (B,), generator=gen, device=cuda,
                         dtype=torch.int32)
    lens[0] = nb * bs
    table = (torch.randperm(NB - 1, generator=gen, device=cuda)[:B * nb]
             + 1).reshape(B, nb).int()
    pos = torch.arange(nb * bs, device=cuda).reshape(nb, bs)
    stale = torch.zeros((NB, bs), dtype=torch.bool, device=cuda)
    stale[table.long()] = pos[None] >= lens[:, None, None]
    kp[:, stale] = float("nan")
    vp[:, stale] = float("nan")
    q = torch.randn((B, Hkv, G, hd), generator=gen, device=cuda).bfloat16()
    return q, kp, vp, table, lens


@pytest.mark.gpu
@pytest.mark.parametrize("G,Hkv,nb,plan", [(16, 4, 8, "one"),
                                           (8, 2, 6, "one"),
                                           (16, 1, 600, "cap"),
                                           (8, 1, 600, "cap")])
def test_cuda_tc_decode_one_split_and_the_cap(cuda, G, Hkv, nb, plan):
    """The tensor-core design with one split (enough (sequence, kv head)
    pairs to give every SM its CTAs: the CTA writes o itself) and at the
    split cap (one sequence cut into max_splits(G) splits of 2-3 slots)."""
    sm = _cuda.sm_count(cuda)
    B = -(-pda.CTAS_PER_SM * sm // Hkv) if plan == "one" else 1
    splits = pda.plan_splits(B, Hkv, nb, sm, G)
    assert splits == (1 if plan == "one" else pda.max_splits(G))
    q, kp, vp, table, lens = _tc_inputs(cuda, G + nb, B, Hkv, G, 128, 16, nb)
    fn = pda.paged_decode_attention
    n_tc = fn.tc_launches
    got = fn(q, kp, vp, table, lens, return_partials=True)
    want = pda.paged_decode_attention_plain(q, kp, vp, table, lens,
                                            return_partials=True)
    assert fn.tc_launches == n_tc + 1
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        assert bool(torch.isfinite(a.float()).all())
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd,bs", [(16, 128, 16), (8, 112, 12)])
def test_cuda_tc_decode_graph_replay_equals_eager(cuda, G, hd, bs):
    """A CUDA graph of the tensor-core design, captured with tickets of its
    own, replays bit for bit equal to the eager call, twice in a row, and
    leaves its tickets at 0."""
    B, Hkv, nb = 4, 2, 90
    q, kp, vp, table, lens = _tc_inputs(cuda, G + hd, B, Hkv, G, hd, bs, nb)
    assert pda.plan_splits(B, Hkv, nb, _cuda.sm_count(cuda), G) > 1
    eager = [t.clone() for t in pda.paged_decode_attention(
        q, kp, vp, table, lens, return_partials=True)]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with _cuda.private_tickets(cuda, side.cuda_stream, B * Hkv) as tickets:
        with torch.cuda.graph(graph, stream=side):
            out = pda.paged_decode_attention(q, kp, vp, table, lens,
                                             return_partials=True)
    for _ in range(2):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)
    assert int(tickets.abs().sum()) == 0


@pytest.mark.gpu
def test_cuda_decode_path_counter_names_the_design_that_ran(cuda):
    """bf16 calls at G <= 4 and int8 calls at any G run the lanes and
    count no tensor-core launch; an engine at G = 16 (head partition)
    serving through graphs counts every decode launch as a tensor-core
    one, replays included, and emits the tokens of its eager steps."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                     SamplingParams)

    fn, fn8 = pda.paged_decode_attention, pda.paged_decode_attention_int8
    q, kp, vp, table, lens = _tc_inputs(cuda, 3, 2, 2, 4, 128, 16, 20)
    n, n_tc = fn.launches, fn.tc_launches
    fn(q, kp, vp, table, lens)
    assert (fn.launches - n, fn.tc_launches - n_tc) == (1, 0)
    q, kp, vp, table, lens = _tc_inputs(cuda, 4, 2, 2, 16, 128, 16, 20)
    kpool, ks = _int8_pool(torch.nan_to_num(kp.float()).cpu().numpy(), cuda)
    vpool, vs = _int8_pool(torch.nan_to_num(vp.float()).cpu().numpy(), cuda)
    n8 = fn8.launches
    fn(q, kpool, vpool, table, lens, k_scale=ks, v_scale=vs)
    assert fn8.launches == n8 + 1 and fn.tc_launches == n_tc

    cfg = treg.get_smoke_config("glm4-9b", num_heads=32, num_kv_heads=2,
                                dtype=torch.bfloat16)
    assert cfg.num_heads // cfg.num_kv_heads == 16
    params = ttf.init_params(0, cfg, device=cuda)
    econf = EngineConfig(max_batch=4, block_size=16, num_blocks=64,
                         placement="attention_pool", partition="head",
                         attention_workers=2, prefill_chunk_tokens=32)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=k).tolist()
               for k in (40, 21, 9)]
    outs = {}
    for compiled in (True, False):
        eng = LLMEngine(cfg, params, econf, device=cuda)
        if not compiled:
            eng.compiled = None           # the eager step, as the reference
        reqs = [Request(prompt=list(x), params=SamplingParams(
            max_new_tokens=24)) for x in prompts]
        n, n_tc = fn.launches, fn.tc_launches
        eng.submit(reqs)
        eng.run()
        torch.cuda.synchronize()
        outs[compiled] = [r.output for r in reqs]
        want = cfg.num_layers * 2 * len(eng.stats.batch_sizes)
        assert fn.launches - n == fn.tc_launches - n_tc == want
        if compiled:
            assert eng.compiled.replays > 0
    assert outs[True] == outs[False]


# the chunk kernel at hd = 112 (tiles at 128, TMA zero-fills the last 16
# columns): every packing up to G = 16, boxes of 1, 2, 4, 8 and 64 rows,
# masks, the first chunk of a prompt; and G = 16 at hd 64 and 128
WIDE_PREFILL_CASES = [  # G, hd, C, nb, window, sinks, softcap, block size
    (16, 112, 100, 5, 0, 0, 0.0, 16), (8, 112, 64, 0, 0, 0, 0.0, 16),
    (4, 112, 77, 7, 50, 4, 50.0, 16), (1, 112, 300, 11, 100, 4, 30.0, 16),
    (2, 112, 65, 13, 0, 0, 0.0, 1), (16, 112, 40, 7, 9, 2, 0.0, 2),
    (4, 112, 100, 9, 0, 0, 0.0, 4), (8, 112, 77, 6, 50, 4, 50.0, 8),
    (16, 112, 64, 2, 0, 0, 0.0, 64), (16, 128, 300, 6, 90, 0, 0.0, 16),
    (16, 64, 130, 3, 100, 4, 30.0, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G,hd,C,nb,sw,sinks,cap,bs", WIDE_PREFILL_CASES)
def test_cuda_widened_prefill_matches_plain(cuda, int8, G, hd, C, nb, sw,
                                            sinks, cap, bs):
    test = test_cuda_int8_prefill_kernel_matches_plain if int8 else \
        test_cuda_prefill_kernel_matches_plain
    test(cuda, G, hd, C, nb, sw, sinks, cap, bs)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G,hd,sw,sinks,cap", [(16, 128, 0, 0, 0.0),
                                               (16, 64, 40, 4, 50.0),
                                               (8, 112, 0, 0, 0.0),
                                               (4, 112, 9, 0, 30.0),
                                               (4, 128, 0, 0, 0.0),
                                               (1, 64, 0, 0, 0.0),
                                               (2, 112, 1, 2, 0.0)])
def test_cuda_dense_decode_widened_and_int8_match_plain(cuda, int8, G, hd,
                                                        sw, sinks, cap):
    """The dense kernel's widened shapes and its int8 entry, with NaN
    values (and NaN scales) in every slot past cache_len, also over a head
    slice of a wider cache (the head partition's worker reads in place)."""
    from repro_torch.models.kv_quant import quantize_kv

    rng = np.random.default_rng(G * 7 + hd + int8)
    B, Hkv, S = 5, 4, 300
    kc = torch.from_numpy(rng.standard_normal((B, Hkv, S, hd))).to(cuda)
    vc = torch.from_numpy(rng.standard_normal((B, Hkv, S, hd))).to(cuda)
    lens = rng.integers(1, S + 1, size=B).astype(np.int32)
    lens[0], lens[1] = S, 1
    stale = torch.arange(S, device=cuda)[None] >= \
        torch.from_numpy(lens).to(cuda)[:, None]
    stale = stale[:, None].expand(B, Hkv, S)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    if int8:
        kc, ks = quantize_kv(kc.float())
        vc, vs = quantize_kv(vc.float())
        ks[stale] = float("nan")
        vs[stale] = float("nan")
        kw.update(k_scale=ks, v_scale=vs)
    else:
        kc, vc = kc.bfloat16(), vc.bfloat16()
        kc[stale] = float("nan")
        vc[stale] = float("nan")
    q = _bf16(rng.standard_normal((B, Hkv, G, hd)), cuda)
    cl = torch.from_numpy(lens).to(cuda)
    counter = da.decode_attention_int8 if int8 else da.decode_attention
    n = counter.launches
    got = da.decode_attention(q, kc, vc, cl, return_partials=True, **kw)
    assert counter.launches == n + 1
    want = da.decode_attention_plain(q, kc, vc, cl, return_partials=True,
                                     **kw)
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=1e-3)
    sl = slice(1, 3)                        # a strided head slice
    skw = dict(kw)
    if int8:
        skw.update(k_scale=ks[:, sl], v_scale=vs[:, sl])
    got = da.decode_attention(q[:, sl].contiguous(), kc[:, sl], vc[:, sl],
                              cl, return_partials=True, **skw)
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(a.float(), b[:, sl].float(), rtol=tol,
                                   atol=1e-3)


# The dense kernel's split-KV grid (grid (splits, Hkv, B), the last CTA of
# each (b, h) merging the partials): one split, the most splits (one
# 16-row unit each), the G = 16 cap of 256 splits and G = 8's 512, windows
# that mask whole splits, NaN values and NaN scales past every cache_len.
def _dense_inputs(cuda, seed, B, Hkv, G, hd, S, lens, int8):
    from repro_torch.models.kv_quant import quantize_kv

    rng = np.random.default_rng(seed)
    kc = torch.from_numpy(rng.standard_normal((B, Hkv, S, hd))).to(cuda)
    vc = torch.from_numpy(rng.standard_normal((B, Hkv, S, hd))).to(cuda)
    cl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    stale = torch.arange(S, device=cuda)[None] >= cl[:, None]
    stale = stale[:, None].expand(B, Hkv, S)
    scales = {}
    if int8:
        kc, ks = quantize_kv(kc.float())
        vc, vs = quantize_kv(vc.float())
        ks[stale] = float("nan")
        vs[stale] = float("nan")
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = kc.bfloat16(), vc.bfloat16()
        kc[stale] = float("nan")
        vc[stale] = float("nan")
    q = _bf16(rng.standard_normal((B, Hkv, G, hd)), cuda)
    return q, kc, vc, cl, scales


DENSE_SPLIT_CASES = [  # G, hd, B, Hkv, S, lens, window, sinks, cap, splits
    (16, 128, 2, 1, 300, [300, 137], 0, 0, 0.0, "one"),
    (16, 128, 2, 1, 300, [300, 137], 0, 0, 0.0, "most"),
    (16, 64, 1, 1, 4200, [4111], 0, 0, 0.0, "plan"),      # the G = 16 cap
    (8, 112, 1, 1, 8200, [8200], 0, 0, 30.0, "plan"),     # 2 CTAs a SM
    (4, 128, 3, 2, 1000, [1000, 0, 613], 100, 4, 0.0, "plan"),
    (1, 64, 3, 2, 500, [500, 333, 1], 64, 0, 30.0, "most"),
    (2, 112, 2, 2, 777, [777, 20], 0, 0, 50.0, "one"),
    (16, 112, 2, 2, 2000, [2000, 1500], 300, 3, 0.0, "plan")]


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G,hd,B,Hkv,S,lens,sw,sinks,cap,splits",
                         DENSE_SPLIT_CASES)
def test_cuda_dense_split_decode_matches_plain(cuda, monkeypatch, int8, G, hd,
                                               B, Hkv, S, lens, sw, sinks,
                                               cap, splits):
    q, kc, vc, cl, scales = _dense_inputs(cuda, S + G + hd, B, Hkv, G, hd, S,
                                          lens, int8)
    units = -(-S // da.SPLIT_UNIT)
    if splits != "plan":
        monkeypatch.setattr(da, "plan_splits", lambda *a, **k:
                            1 if splits == "one" else units)
    n_splits = da.plan_splits(B, Hkv, S, _cuda.sm_count(cuda), G)
    if (G, S) == (16, 4200):
        assert n_splits == da.max_splits(16) == 256
    if (G, S) == (8, 8200):
        assert n_splits == da.CTAS_PER_SM * _cuda.sm_count(cuda)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap,
              **scales)
    counter = da.decode_attention_int8 if int8 else da.decode_attention
    other = da.decode_attention if int8 else da.decode_attention_int8
    n, n_other = counter.launches, other.launches
    got = da.decode_attention(q, kc, vc, cl, return_partials=True, **kw)
    o = da.decode_attention(q, kc, vc, cl, **kw)
    assert counter.launches == n + 2 and other.launches == n_other
    want = da.decode_attention_plain(q, kc, vc, cl, return_partials=True,
                                     **kw)
    assert bool(torch.isfinite(got[0]).all())
    torch.testing.assert_close(o.float(), want[0].float(), rtol=8e-3,
                               atol=1e-3)
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hd,G", [(64, 16), (112, 8), (128, 4), (128, 16)])
def test_cuda_dense_split_decode_reads_a_head_slice(cuda, int8, hd, G):
    """attend's head partition hands each worker a strided slice of the
    kv heads (sequences stride(0) apart); the split kernel reads it in
    place and equals the twin on the full cache's heads."""
    B, Hkv, S = 3, 4, 700
    q, kc, vc, cl, scales = _dense_inputs(cuda, hd + G, B, Hkv, G, hd, S,
                                          [700, 401, 0], int8)
    want = da.decode_attention_plain(q, kc, vc, cl, return_partials=True,
                                     **scales)
    sl = slice(2, 4)
    part = {k: v[:, sl] for k, v in scales.items()}
    assert not kc[:, sl].is_contiguous()
    got = da.decode_attention(q[:, sl].contiguous(), kc[:, sl], vc[:, sl],
                              cl, return_partials=True, **part)
    assert da.plan_splits(B, 2, S, _cuda.sm_count(cuda), G) > 1
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        torch.testing.assert_close(a.float(), b[:, sl].float(), rtol=tol,
                                   atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("int8,G,hd", [(False, 16, 128), (True, 16, 128),
                                       (False, 4, 64), (True, 8, 112)])
def test_cuda_dense_decode_graph_replay_equals_eager(cuda, int8, G, hd):
    """A CUDA graph of the split kernel, captured with tickets of its own,
    replays bit for bit equal to the eager call (the last CTA merges the
    splits in split order, whichever CTA it is), twice in a row, and leaves
    its tickets at 0."""
    B, Hkv, S = 4, 2, 3000
    q, kc, vc, cl, scales = _dense_inputs(cuda, 7 + G, B, Hkv, G, hd, S,
                                          [3000, 1234, 5, 0], int8)
    kw = dict(return_partials=True, **scales)
    assert da.plan_splits(B, Hkv, S, _cuda.sm_count(cuda), G) > 1
    eager = [t.clone() for t in da.decode_attention(q, kc, vc, cl, **kw)]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with _cuda.private_tickets(cuda, side.cuda_stream, B * Hkv) as tickets:
        with torch.cuda.graph(graph, stream=side):
            out = da.decode_attention(q, kc, vc, cl, **kw)
    for _ in range(2):
        for t in out:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)
    assert int(tickets.abs().sum()) == 0


def _scan_close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * max(1.0, scale))


def _edge_decays(g, a):
    """Exact 0 (5 %) and exact 1.0 (25 %) decays sprinkled into ``a``, and a
    run of 1.0 over the whole second 16-step tile of the chunked kernels."""
    pick = torch.rand(a.shape, generator=g, device=a.device)
    a = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.75, 1.0, a))
    a[:, 16:32] = 1.0
    return a.contiguous()


# (B, S, H, P, N, edge decays): S across the kernel's 16-step tiles (1,
# 63, 64, 65, 2047), P from 8 to 256 (slices of the state rows), N 16 to 128;
# B·H below the SM count (narrower CTAs), at 192 (two warps a CTA) and at
# 320 (four warps a CTA)
SSM_CASES = [(2, 300, 3, 64, 64, False), (1, 37, 2, 32, 16, False),
             (2, 16, 4, 64, 128, False), (1, 1, 2, 8, 16, False),
             (2, 63, 3, 8, 16, True), (1, 64, 2, 256, 128, True),
             (2, 65, 2, 40, 32, True), (1, 2047, 3, 64, 64, True),
             (5, 40, 64, 64, 128, True), (5, 33, 64, 64, 64, False),
             (3, 40, 64, 64, 64, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,edges", SSM_CASES)
def test_cuda_ssm_scan_matches_plain(cuda, B, S, H, P, N, edges):
    g = torch.Generator(device=cuda).manual_seed(S)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=cuda) - 1.0)
    x = torch.randn((B, S, H, P), generator=g, device=cuda) * dt[..., None]
    Bi = torch.randn((B, S, N), generator=g, device=cuda)
    Ci = torch.randn((B, S, N), generator=g, device=cuda)
    a = torch.exp(-dt)
    if edges:
        a = _edge_decays(g, a)
    n = ssm.ssm_scan.launches
    got = ssm.ssm_scan(x, Bi, Ci, a)
    assert ssm.ssm_scan.launches == n + 1
    _scan_close(got, ssm.ssm_scan_plain(x, Bi, Ci, a))
    with pytest.raises(TypeError):                        # bf16 x
        ssm.ssm_scan(x.bfloat16(), Bi, Ci, a)


# (B, S, H, P, dtype, decays): "randn" exp(-exp(N(0,1) - 2)); "model" the
# RWKV6 layer's exp(-exp(-6 + noise)) in the input dtype (mostly 0.996 or
# 1.0); "edges" exact 0 and 1.0 and a tile of 1.0
RWKV_CASES = [(2, 300, 3, 64, torch.bfloat16, "randn"),
              (1, 37, 2, 32, torch.float32, "randn"),
              (2, 16, 4, 64, torch.float32, "randn"),
              (1, 1, 2, 32, torch.bfloat16, "randn"),
              (2, 63, 2, 64, torch.bfloat16, "edges"),
              (1, 64, 3, 32, torch.float32, "edges"),
              (2, 65, 2, 64, torch.float32, "model"),
              (1, 2047, 2, 64, torch.bfloat16, "model"),
              (1, 2047, 2, 64, torch.float32, "edges"),
              (5, 40, 64, 64, torch.bfloat16, "edges"),
              (5, 33, 64, 32, torch.float32, "model"),
              (3, 40, 64, 64, torch.float32, "edges")]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,dtype,decays", RWKV_CASES)
def test_cuda_rwkv6_scan_matches_plain(cuda, B, S, H, P, dtype, decays):
    g = torch.Generator(device=cuda).manual_seed(S + P)
    shape = (B, S, H, P)
    r, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    noise = torch.randn(shape, generator=g, device=cuda)
    if decays == "model":
        w = torch.exp(-torch.exp(-6.0 + 0.5 * noise))
    else:
        w = torch.exp(-torch.exp(noise - 2.0))
        if decays == "edges":
            w = _edge_decays(g, w)
    w = w.to(dtype)
    u = torch.randn((H, P), generator=g, device=cuda) * 0.5
    n = rw.rwkv6_scan.launches
    got = rw.rwkv6_scan(r, k, v, w, u)
    assert rw.rwkv6_scan.launches == n + 1
    _scan_close(got, rw.rwkv6_scan_plain(r, k, v, w, u))
    with pytest.raises(TypeError):                        # mixed dtypes
        rw.rwkv6_scan(r, k, v, w.half(), u)


# The scans' backward kernels against their plain fp32 backward twins: the
# kernels run the chunked form on the tensor cores (every fp32 product in
# three bf16 passes, ~1e-5 of each product), the twins the fp32 step
# recurrences, so the scan tolerance holds for fp32 outputs; bf16 outputs
# (rwkv6's bf16 entry) add their rounding (8e-3 relative, 1e-3 of the
# largest entry). Two calls agree bit for bit (fixed-order sums, no
# atomics).
SSM_BWD_CASES = [(2, 300, 3, 64, 64, False), (1, 37, 2, 32, 16, True),
                 (1, 1, 2, 8, 16, False), (2, 65, 2, 40, 32, True),
                 (1, 64, 2, 256, 128, True), (1, 2047, 3, 64, 64, True),
                 (3, 40, 64, 64, 64, True), (2, 33, 4, 72, 16, False)]


def _ssm_operands(cuda, B, S, H, P, N, edges, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=cuda) - 1.0)
    x = torch.randn((B, S, H, P), generator=g, device=cuda) * dt[..., None]
    Bi = torch.randn((B, S, N), generator=g, device=cuda)
    Ci = torch.randn((B, S, N), generator=g, device=cuda)
    a = torch.exp(-dt)
    if edges:
        a = _edge_decays(g, a)
    dy = torch.randn((B, S, H, P), generator=g, device=cuda)
    return (x, Bi, Ci, a), dy


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,edges", SSM_BWD_CASES)
def test_cuda_ssm_scan_bwd_matches_plain(cuda, B, S, H, P, N, edges):
    ops, dy = _ssm_operands(cuda, B, S, H, P, N, edges, seed=S + 1)
    n = ssm.ssm_scan_bwd.launches
    got = ssm.ssm_scan_bwd(*ops, dy)
    again = ssm.ssm_scan_bwd(*ops, dy)
    assert ssm.ssm_scan_bwd.launches == n + 2
    want = ssm.ssm_scan_bwd_plain(*ops, dy)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)                     # deterministic
        _scan_close(a, c)
    with pytest.raises(ValueError):                  # non-contiguous dy
        ssm.ssm_scan_bwd(*ops, torch.cat([dy, dy], -1)[..., :P])


@pytest.mark.gpu
def test_cuda_ssm_scan_autograd_runs_the_backward_kernel(cuda):
    ops, dy = _ssm_operands(cuda, 2, 70, 4, 64, 64, True, seed=3)
    leaves = [t.clone().requires_grad_() for t in ops]
    n_f, n_b = ssm.ssm_scan.launches, ssm.ssm_scan_bwd.launches
    y = ssm.ssm_scan(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    assert (ssm.ssm_scan.launches, ssm.ssm_scan_bwd.launches) == \
        (n_f + 1, n_b + 1)
    for a, b in zip(grads, ssm.ssm_scan_bwd(*ops, dy)):
        assert torch.equal(a, b)


RWKV_BWD_CASES = [(2, 300, 3, 64, torch.bfloat16, "randn"),
                  (1, 37, 2, 32, torch.float32, "edges"),
                  (1, 1, 2, 32, torch.bfloat16, "randn"),
                  (2, 65, 2, 64, torch.float32, "model"),
                  (1, 2047, 2, 64, torch.bfloat16, "model"),
                  (1, 2047, 2, 64, torch.float32, "edges"),
                  (3, 40, 64, 64, torch.bfloat16, "edges"),
                  (5, 33, 64, 32, torch.float32, "model")]


def _rwkv_operands(cuda, B, S, H, P, dtype, decays, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    shape = (B, S, H, P)
    r, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    noise = torch.randn(shape, generator=g, device=cuda)
    if decays == "model":
        w = torch.exp(-torch.exp(-6.0 + 0.5 * noise))
    else:
        w = torch.exp(-torch.exp(noise - 2.0))
        if decays == "edges":
            w = _edge_decays(g, w)
    u = torch.randn((H, P), generator=g, device=cuda) * 0.5
    dy = torch.randn(shape, generator=g, device=cuda)
    return (r, k, v, w.to(dtype).contiguous(), u), dy


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,dtype,decays", RWKV_BWD_CASES)
def test_cuda_rwkv6_scan_bwd_matches_plain(cuda, B, S, H, P, dtype, decays):
    ops, dy = _rwkv_operands(cuda, B, S, H, P, dtype, decays, seed=S + P)
    n = rw.rwkv6_scan_bwd.launches
    got = rw.rwkv6_scan_bwd(*ops, dy)
    again = rw.rwkv6_scan_bwd(*ops, dy)
    assert rw.rwkv6_scan_bwd.launches == n + 2
    want = rw.rwkv6_scan_bwd_plain(*ops, dy)
    for i, (a, b, c) in enumerate(zip(got, again, want)):
        assert torch.equal(a, b)                     # deterministic
        assert a.dtype == (torch.float32 if i == 4 else dtype)
        if a.dtype == torch.bfloat16:
            torch.testing.assert_close(
                a.float(), c, rtol=8e-3,
                atol=1e-3 * max(1.0, float(c.abs().max())))
        else:
            _scan_close(a, c)
    with pytest.raises(TypeError):                   # bf16 dy
        rw.rwkv6_scan_bwd(*ops, dy.bfloat16())


@pytest.mark.gpu
def test_cuda_rwkv6_scan_autograd_runs_the_backward_kernel(cuda):
    ops, dy = _rwkv_operands(cuda, 2, 70, 4, 64, torch.bfloat16, "edges",
                             seed=4)
    leaves = [t.clone().requires_grad_() for t in ops]
    n_f, n_b = rw.rwkv6_scan.launches, rw.rwkv6_scan_bwd.launches
    y = rw.rwkv6_scan(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    assert (rw.rwkv6_scan.launches, rw.rwkv6_scan_bwd.launches) == \
        (n_f + 1, n_b + 1)
    for a, b in zip(grads, rw.rwkv6_scan_bwd(*ops, dy)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the compiled decode step (serving/compiled.py): CUDA graph replays
# ---------------------------------------------------------------------------
GRAPH_PLACEMENTS = {
    "homogeneous": dict(),
    "head": dict(placement="attention_pool", partition="head"),
    "request": dict(placement="attention_pool", partition="request"),
    "block": dict(placement="attention_pool", partition="block")}


def _graph_state(dev, name, kv_dtype):
    """A bf16 smoke llama (2 layers, G=2, hd=64) on the card paused where
    3 requests decode, and an eager step + a fresh compiled step of the
    placement ``name`` over its pool."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                     SamplingParams, State, make_placement)
    from repro_torch.serving.compiled import CompiledDecodeStep

    cfg = treg.get_smoke_config("llama3-8b", num_kv_heads=2,
                                dtype=torch.bfloat16)
    params = ttf.init_params(0, cfg, device=dev)
    econf = EngineConfig(max_batch=4, block_size=4, num_blocks=64,
                         attention_workers=2, kv_dtype=kv_dtype,
                         **GRAPH_PLACEMENTS[name])
    eng = LLMEngine(cfg, params, econf, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=n).tolist(),
                    params=SamplingParams(max_new_tokens=32))
            for n in (21, 12, 9)]
    eng.submit(reqs)
    while not all(r.state == State.RUNNING and eng.sched.prefill_done(r.rid)
                  and r.output for r in reqs):
        eng.step()
    pl = make_placement(cfg, econf, dev)
    kv = eng.kv
    comp = CompiledDecodeStep(pl.decode_fn(), params, kv.k_pool, kv.v_pool,
                              kv.k_scale, kv.v_scale, dev,
                              n_shards=kv.n_shards)
    return cfg, params, eng, reqs, pl, comp


def _eager(pl, params, kv, dev, tokens, tables, lens, extra):
    from repro_torch.serving.placement import device_operands
    scales = {} if kv.k_scale is None else dict(k_scale_pool=kv.k_scale,
                                                v_scale_pool=kv.v_scale)
    tok, tb, ln = device_operands(
        [np.asarray(tokens, np.int32), tables, lens], dev)
    return pl.decode_fn()(params, tok, kv.k_pool, kv.v_pool, tb, ln,
                          *device_operands(extra, dev), **scales)


def _snap(out):
    logits, upd = out
    return [logits.clone(), upd["k_new"].clone(), upd["v_new"].clone()]


def _bitwise(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y), float((x.float() - y.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", list(GRAPH_PLACEMENTS))
def test_cuda_graph_replay_equals_eager_step(cuda, name, kv_dtype):
    """Replay = the eager step at the same padded operands, bit for bit:
    two replays in a row, a bucket switch and back, a pool write between
    replays; launch counts after replays = the eager step's."""
    from repro_torch.serving.compiled import pad_operands

    cfg, params, eng, reqs, pl, comp = _graph_state(cuda, name, kv_dtype)
    kv = eng.kv
    fn = pda.paged_decode_attention_int8 if kv_dtype == "int8" else \
        pda.paged_decode_attention
    per_step = cfg.num_layers * (1 if name == "homogeneous" else 2)
    ids = [r.rid for r in reqs]
    tokens = [r.output[-1] for r in reqs]
    tables, lens = kv.block_table_batch(ids)
    extra = pl.decode_extra_args(kv, ids)
    padded, pextra = pad_operands(tables, extra, kv.num_blocks,
                                  kv.blocks_per_shard)
    want = _snap(_eager(pl, params, kv, cuda, tokens, padded, lens, pextra))
    n0 = fn.launches
    first = _snap(comp(tokens, tables, lens, *extra))     # warm-up + capture
    r1 = _snap(comp(tokens, tables, lens, *extra))
    r2 = _snap(comp(tokens, tables, lens, *extra))
    torch.cuda.synchronize()
    assert (comp.captures, comp.replays) == (1, 2)
    assert fn.launches - n0 == 3 * per_step
    for got in (first, r1, r2):
        _bitwise(got, want)
    # a bucket switch (width 9 -> bucket 16) and back
    wide = np.pad(tables, ((0, 0), (0, 9 - tables.shape[1])))
    wpad, _ = pad_operands(wide, (), kv.num_blocks, kv.blocks_per_shard)
    assert wpad.shape[1] == 16
    want16 = _snap(_eager(pl, params, kv, cuda, tokens, wpad, lens, pextra))
    comp(tokens, wide, lens, *extra)
    _bitwise(_snap(comp(tokens, wide, lens, *extra)), want16)
    _bitwise(_snap(comp(tokens, tables, lens, *extra)), want)
    assert (comp.captures, comp.graphs) == (2, 2)
    # a pool write between replays: store this step's K/V, decode the next
    logits, upd = comp(tokens, tables, lens, *extra)
    nxt = logits.float().argmax(-1).tolist()
    for rid in ids:
        kv.append_token(rid)
    kv.write_tokens(ids, upd["k_new"], upd["v_new"], [int(n) for n in lens])
    tables2, lens2 = kv.block_table_batch(ids)
    extra2 = pl.decode_extra_args(kv, ids)
    p2, pe2 = pad_operands(tables2, extra2, kv.num_blocks,
                           kv.blocks_per_shard)
    want2 = _snap(_eager(pl, params, kv, cuda, nxt, p2, lens2, pe2))
    captures = comp.captures
    _bitwise(_snap(comp(nxt, tables2, lens2, *extra2)), want2)
    assert comp.captures == captures              # the same key replayed
    assert not torch.equal(want2[0], want[0])
    torch.cuda.synchronize()
    # 8 compiled calls (2 of them eager warm-ups) and 2 eager references
    assert fn.launches - n0 == 10 * per_step


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["homogeneous", "request"])
def test_cuda_engine_replays_its_decode_step(cuda, name):
    """The engine on the card serves through graphs: its greedy tokens
    equal those of the same engine stepping the placement's step eagerly
    on unpadded operands, and every decode step counts its launches
    once."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                     SamplingParams)

    cfg = treg.get_smoke_config("llama3-8b", num_kv_heads=2,
                                dtype=torch.bfloat16)
    params = ttf.init_params(0, cfg, device=cuda)
    econf = EngineConfig(max_batch=4, block_size=4, num_blocks=64,
                         attention_workers=2, prefill_chunk_tokens=8,
                         **GRAPH_PLACEMENTS[name])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (21, 12, 9)]
    outs = {}
    for compiled in (True, False):
        eng = LLMEngine(cfg, params, econf, device=cuda)
        if not compiled:
            eng.compiled = None           # the eager step, as the reference
        reqs = [Request(prompt=list(x), params=SamplingParams(
            max_new_tokens=24)) for x in prompts]
        n0 = pda.paged_decode_attention.launches
        eng.submit(reqs)
        eng.run()
        torch.cuda.synchronize()
        outs[compiled] = [r.output for r in reqs]
        want = cfg.num_layers * (len(eng.stats.batch_sizes) if name ==
                                 "homogeneous" else
                                 sum(min(2, b) for b in eng.stats.batch_sizes))
        assert pda.paged_decode_attention.launches - n0 == want
        if compiled:
            assert eng.compiled.replays > 0 and eng.compiled.captures > 0
    assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# the compiled prefill programs (serving/compiled.py CompiledPrefill)
# ---------------------------------------------------------------------------
def _prefill_state(dev, kv_dtype, name, prefix=24):
    """A bf16 smoke llama on the card, an engine whose pool holds one
    request's first ``prefix`` tokens (written by chunked prefill), and a
    fresh ``CompiledPrefill`` over that pool."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                     SamplingParams)
    from repro_torch.serving.compiled import CompiledPrefill

    cfg = treg.get_smoke_config("llama3-8b", num_kv_heads=2,
                                dtype=torch.bfloat16)
    params = ttf.init_params(0, cfg, device=dev)
    econf = EngineConfig(max_batch=4, block_size=4, num_blocks=64,
                         attention_workers=2, kv_dtype=kv_dtype,
                         prefill_chunk_tokens=8, **GRAPH_PLACEMENTS[name])
    eng = LLMEngine(cfg, params, econf, device=dev)
    rng = np.random.default_rng(2)
    req = Request(prompt=rng.integers(0, cfg.vocab_size,
                                      size=prefix + 20).tolist(),
                  params=SamplingParams(max_new_tokens=4))
    eng.submit(req)
    for _ in range(prefix // 8):                  # one chunk a step
        eng.step()
    assert eng.sched.prefill_cursor(req.rid) == prefix
    comp = CompiledPrefill(cfg, params, eng.kv, dev, 8)
    return cfg, params, eng, req, comp


def _eager_prefill(kind, cfg, params, kv, dev, tokens, blocks, width):
    """The program ``kind`` eagerly at the same padded operands."""
    from repro_torch.models import transformer as ttf
    from repro_torch.serving.compiled import pad_tokens
    from repro_torch.serving.kvcache import gather_blocks

    tok = torch.from_numpy(pad_tokens(tokens, width)).to(dev)[None]
    n = torch.tensor([len(tokens)], dtype=torch.int32, device=dev)
    tab = torch.as_tensor(blocks, dtype=torch.int32, device=dev)
    scales = {} if kv.k_scale is None else dict(k_scale_pool=kv.k_scale,
                                                v_scale_pool=kv.v_scale)
    if kind == "chunk":
        logits, c = ttf.prefill_chunk(params, cfg, {"tokens": tok},
                                      kv.k_pool, kv.v_pool, tab, device=dev,
                                      length=n, **scales)
    elif kind == "oneshot":
        logits, c = ttf.prefill(params, cfg, {"tokens": tok}, max_seq=width,
                                device=dev, length=n)
    else:
        kp, vp = gather_blocks(kv.k_pool, kv.v_pool, kv.k_scale, kv.v_scale,
                               tab, cfg.dtype)
        logits, c = ttf.prefill_suffix(params, cfg, {"tokens": tok},
                                       kp[:, None], vp[:, None], device=dev,
                                       length=n)
    return [logits.clone(), c["k"][:, 0].clone(), c["v"][:, 0].clone()]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["chunk", "oneshot", "suffix"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["homogeneous", "head"])
def test_cuda_graph_prefill_replay_equals_eager(cuda, name, kv_dtype, kind):
    """Each prefill program's replay = the eager program at the same padded
    operands, bit for bit: the warm-up and two replays, a second key and
    back; the chunk kernel's launch counts through replays = the eager
    program's."""
    from repro_torch.serving.compiled import chunk_bucket, prefill_bucket

    cfg, params, eng, req, comp = _prefill_state(cuda, kv_dtype, name)
    kv = eng.kv
    prefix = kv.tables[req.rid][:24 // kv.block_size]
    fn = ppa.paged_prefill_chunk_attention_int8 if kv_dtype == "int8" \
        else ppa.paged_prefill_chunk_attention
    rng = np.random.default_rng(3)
    # two keys: chunks of 5 and 8 tokens (bucket 8) over 6 and 4 prefix
    # blocks; one-shot and suffix prefills of 5 and 70 tokens (64, 128)
    sizes = (5, 8) if kind == "chunk" else (5, 70)
    toks = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in sizes]
    blocks = {"chunk": (prefix, prefix[:4]), "oneshot": ([], []),
              "suffix": (prefix, prefix)}[kind]
    run = {"chunk": comp.run_chunk, "suffix": comp.run_suffix,
           "oneshot": lambda t, b: comp.run_oneshot(t)}[kind]
    width = (lambda t: chunk_bucket(len(t), 8)) if kind == "chunk" else \
        (lambda t: prefill_bucket(len(t)))
    want = [_eager_prefill(kind, cfg, params, kv, cuda, t, b, width(t))
            for t, b in zip(toks, blocks)]
    n0 = fn.launches
    got = [[x.clone() for x in run(toks[0], blocks[0])] for _ in range(3)]
    torch.cuda.synchronize()
    per = cfg.num_layers if kind == "chunk" else 0
    assert fn.launches - n0 == 3 * per
    prog = comp.programs()[kind]
    assert (prog.captures, prog.replays) == (1, 2)
    for g in got:
        _bitwise(g, want[0])
    run(toks[1], blocks[1])                       # a second key: capture
    _bitwise([x.clone() for x in run(toks[1], blocks[1])], want[1])
    _bitwise([x.clone() for x in run(toks[0], blocks[0])], want[0])
    torch.cuda.synchronize()
    assert (prog.captures, prog.graphs, prog.replays) == (2, 2, 4)
    assert fn.launches - n0 == 6 * per


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cuda_engine_replays_its_prefill_programs(cuda, kv_dtype):
    """The engine on the card prefills through its graphs: its greedy
    tokens equal those of the same engine with eager prefill on unpadded
    operands, chunk launches are L per chunk, and a second pass replays
    every prefill program."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                     SamplingParams)

    cfg = treg.get_smoke_config("llama3-8b", num_kv_heads=2,
                                dtype=torch.bfloat16)
    params = ttf.init_params(0, cfg, device=cuda)
    rng = np.random.default_rng(4)
    common = rng.integers(0, cfg.vocab_size, size=16).tolist()
    prompts = [common + rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (21, 12, 9)]
    fn = ppa.paged_prefill_chunk_attention_int8 if kv_dtype == "int8" \
        else ppa.paged_prefill_chunk_attention
    for chunk in (8, None):
        econf = EngineConfig(max_batch=4, block_size=4, num_blocks=96,
                             kv_dtype=kv_dtype, prefill_chunk_tokens=chunk,
                             prefix_sharing=True)
        outs = {}
        for compiled in (True, False):
            eng = LLMEngine(cfg, params, econf, device=cuda)
            if not compiled:
                eng.compiled_prefill = None     # eager, unpadded prefill
            for rnd in range(2 if compiled else 1):
                reqs = [Request(prompt=list(x), params=SamplingParams(
                    max_new_tokens=12)) for x in prompts]
                n0, c0 = fn.launches, eng.stats.prefill_chunks_run
                eng.submit(reqs)
                eng.run()
                torch.cuda.synchronize()
                assert fn.launches - n0 == cfg.num_layers * (
                    eng.stats.prefill_chunks_run - c0)
                outs.setdefault(compiled, [r.output for r in reqs])
                assert [r.output for r in reqs] == outs[compiled]
            if compiled:
                progs = eng.compiled_prefill.programs()
                used = progs["chunk"] if chunk else progs["oneshot"]
                assert used.replays > 0 and used.captures > 0
                if not chunk:
                    assert progs["suffix"].replays > 0
        assert outs[True] == outs[False]


# ---------------------------------------------------------------------------
# the KV handoff on the card (PagedKVCache.export_seqs / import) and the
# disaggregated cluster (serving/cluster/)
# ---------------------------------------------------------------------------
def _smoke_bf16(dev):
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as ttf
    cfg = treg.get_smoke_config("llama3-8b", num_kv_heads=2,
                                dtype=torch.bfloat16)
    return cfg, ttf.init_params(0, cfg, device=dev)


def _random_pool(kv, seed):
    g = torch.Generator(device=kv.device).manual_seed(seed)
    if kv.k_scale is None:
        for p in (kv.k_pool, kv.v_pool):
            p.copy_(torch.randn(p.shape, generator=g, device=kv.device))
        return
    for p in (kv.k_pool, kv.v_pool):
        p.copy_(torch.randint(-127, 128, p.shape, generator=g,
                              device=kv.device))
    for s in (kv.k_scale, kv.v_scale):
        s.copy_(torch.rand(s.shape, generator=g, device=kv.device))


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("src_shards,dst_shards", [(1, 1), (1, 4), (2, 1),
                                                   (4, 2)])
def test_cuda_export_import_roundtrip_is_bit_exact(cuda, kv_dtype,
                                                   src_shards, dst_shards):
    """Pool → pinned host tiles → another pool on the card: every block
    lands bit for bit, in place, with the reference's table rebuild."""
    from repro_torch.serving import PagedKVCache

    cfg, _ = _smoke_bf16(cuda)
    src = PagedKVCache(cfg, 64, 4, n_shards=src_shards, kv_dtype=kv_dtype,
                       device=cuda)
    src.allocate(0, 37)
    src.share_blocks(0, 1, 20)
    src.allocate(1, 29)
    src.allocate(2, 5)
    _random_pool(src, 3)
    payload = src.export_seqs([0, 1, 2])
    assert payload.k_blocks.device.type == "cpu"
    assert payload.k_blocks.is_pinned()
    assert payload.n_blocks == len({b for s in (0, 1, 2)
                                    for b in src.tables[s]})
    dst = PagedKVCache(cfg, 64, 4, n_shards=dst_shards, kv_dtype=kv_dtype,
                       device=cuda)
    ptrs = [t.data_ptr() for t in (dst.k_pool, dst.v_pool)]
    mapping = dst.prealloc_handoff(payload)
    landed = sum(dst.write_handoff_blocks(payload, mapping, a,
                                          min(a + 3, payload.n_blocks))
                 for a in range(0, payload.n_blocks, 3))
    torch.cuda.synchronize()
    assert landed == payload.nbytes
    assert [t.data_ptr() for t in (dst.k_pool, dst.v_pool)] == ptrs
    for sid in (0, 1, 2):
        assert dst.tables[sid] == [mapping[b] for b in src.tables[sid]]
    for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
        s, d = getattr(src, name), getattr(dst, name)
        if s is None:
            continue
        for sb, db in mapping.items():
            assert torch.equal(d[:, :, db], s[:, :, sb]), (name, sb, db)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cuda_import_between_replays_is_read_by_the_next_replay(cuda,
                                                                kv_dtype):
    """A captured decode graph reads the pool by address: a sequence
    exported, freed and imported back with other bytes between two
    replays of the same graph is read by the second replay, which equals
    the eager step on the imported state bit for bit."""
    from repro_torch.serving import KVHandoffPayload
    from repro_torch.serving.compiled import pad_operands

    cfg, params, eng, reqs, pl, comp = _graph_state(cuda, "head", kv_dtype)
    kv = eng.kv
    ids = [r.rid for r in reqs]
    tokens = [r.output[-1] for r in reqs]
    tables, lens = kv.block_table_batch(ids)
    comp(tokens, tables, lens)                      # warm-up + capture
    before = _snap(comp(tokens, tables, lens))      # a replay
    victim = ids[0]
    payload = kv.export_seqs([victim])
    kv.free_seq(victim)
    half = {name: None if t is None else
            (t * 0.5 if t.is_floating_point() else t).to(t.dtype)
            for name, t in dict(k_blocks=payload.k_blocks,
                                k_scales=payload.k_scales).items()}
    altered = KVHandoffPayload(
        tables=payload.tables, lengths=payload.lengths,
        block_ids=payload.block_ids, k_blocks=half["k_blocks"],
        v_blocks=payload.v_blocks, block_size=payload.block_size,
        k_scales=half["k_scales"], v_scales=payload.v_scales)
    kv.import_seqs(altered)
    tables2, lens2 = kv.block_table_batch(ids)
    assert tables2.shape == tables.shape and (lens2 == lens).all()
    captures = comp.captures
    after = _snap(comp(tokens, tables2, lens2))
    assert comp.captures == captures                # the same graph
    padded, _ = pad_operands(tables2, (), kv.num_blocks, kv.blocks_per_shard)
    want = _snap(_eager(pl, params, kv, cuda, tokens, padded, lens2, ()))
    _bitwise(after, want)
    assert not torch.equal(after[0][0], before[0][0])   # the import is read
    assert torch.equal(after[0][1:], before[0][1:])      # the rest is not


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cuda_cluster_greedy_tokens_equal_the_single_engine(cuda, kv_dtype):
    """At smoke size, a one-replica cluster's greedy tokens equal the
    single engine's (decode batches of one, so both replay the same
    graphs); the prefill engine captures no decode graph and the decode
    engine no prefill graph."""
    from repro_torch.serving import (DisaggConfig, EngineConfig, LLMEngine,
                                     Request, SamplingParams)
    from repro_torch.serving.cluster import DisaggCluster

    cfg, params = _smoke_bf16(cuda)
    econf = EngineConfig(max_batch=1, block_size=4, num_blocks=96,
                         kv_dtype=kv_dtype, prefill_chunk_tokens=8,
                         placement="attention_pool", partition="head",
                         attention_workers=2)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (21, 12, 30)]

    def reqs():
        return [Request(prompt=list(p), params=SamplingParams(
            max_new_tokens=12)) for p in prompts]
    single = LLMEngine(cfg, params, econf, device=cuda)
    want = reqs()
    single.submit(want)
    single.run()
    cluster = DisaggCluster(cfg, params, econf, replicas=1, device=cuda,
                            disagg=DisaggConfig(transfer_blocks_per_step=2))
    got = cluster.submit(reqs())
    cluster.run()
    torch.cuda.synchronize()
    assert [r.output for r in got] == [r.output for r in want]
    rep = cluster.registry[0]
    assert rep.prefill.compiled.captures == 0
    assert all(g.captures == 0
               for g in rep.decode.compiled_prefill.programs().values())
    assert rep.decode.compiled.replays > 0
    assert rep.decode.stats.handoffs_completed == len(prompts)


# ---------------------------------------------------------------------------
# the moe family on the card (models/moe.py, the moe_offload placement)
# ---------------------------------------------------------------------------
def _moe_bf16(dev, **kw):
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as ttf
    cfg = treg.get_smoke_config("qwen3-moe-30b-a3b", dtype=torch.bfloat16,
                                **kw)
    return cfg, ttf.init_params(0, cfg, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,cf", [(1, 5, 1.25), (1, 512, 0.5), (8, 1, 1.25),
                                    (2, 256, 64.0)])
def test_cuda_moe_forward_matches_the_cpu(cuda, B, S, cf):
    """moe_forward on the card against the CPU on the same bf16 inputs and
    weights (drops included: the routing's fp32 sums may round apart, so
    outputs agree within 2 bf16 ulps plus 1e-2 of the output's scale)."""
    from repro_torch.models import moe as tmoe
    cfg, params = _moe_bf16(cuda, capacity_factor=cf)
    moe = {k: v[0] for k, v in params["layers"]["moe"].items()}
    g = torch.Generator(device=cuda).manual_seed(B * S)
    x = torch.randn((B, S, cfg.d_model), generator=g,
                    device=cuda).bfloat16()
    y, aux = tmoe.moe_forward(moe, cfg, x)
    yc, auxc = tmoe.moe_forward({k: v.cpu() for k, v in moe.items()}, cfg,
                                x.cpu())
    scale = float(yc.float().abs().max())
    torch.testing.assert_close(y.cpu().float(), yc.float(), rtol=8e-3,
                               atol=1e-2 * scale)
    torch.testing.assert_close(aux.cpu(), auxc, rtol=1e-4, atol=1e-5)


def _moe_engine_state(dev, econf_kw):
    from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                     SamplingParams, State)
    cfg, params = _moe_bf16(dev)
    econf = EngineConfig(max_batch=4, block_size=4, num_blocks=64,
                         **econf_kw)
    eng = LLMEngine(cfg, params, econf, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, size=n).tolist(),
                    params=SamplingParams(max_new_tokens=16))
            for n in (21, 12, 9)]
    eng.submit(reqs)
    while not all(r.state == State.RUNNING and r.output for r in reqs):
        eng.step()
    return cfg, params, econf, eng, reqs


@pytest.mark.gpu
@pytest.mark.parametrize("econf_kw", [
    dict(), dict(placement="moe_offload", attention_workers=2,
                 expert_workers=2, kv_dtype="int8")],
    ids=["homogeneous", "moe_offload-int8"])
def test_cuda_moe_decode_replay_equals_eager(cuda, econf_kw):
    """A captured MoE decode step (router, sort, dispatch, the expert
    einsums) replays equal to its eager call at the same operands, bit for
    bit, twice in a row."""
    from repro_torch.serving import make_placement
    from repro_torch.serving.compiled import CompiledDecodeStep, pad_operands
    cfg, params, econf, eng, reqs = _moe_engine_state(cuda, econf_kw)
    kv = eng.kv
    pl = make_placement(cfg, econf, cuda)
    comp = CompiledDecodeStep(pl.decode_fn(), params, kv.k_pool, kv.v_pool,
                              kv.k_scale, kv.v_scale, cuda,
                              n_shards=kv.n_shards)
    ids = [r.rid for r in reqs]
    tokens = [r.output[-1] for r in reqs]
    tables, lens = kv.block_table_batch(ids)
    extra = pl.decode_extra_args(kv, ids)
    padded, pextra = pad_operands(tables, extra, kv.num_blocks,
                                  kv.blocks_per_shard)
    want = _snap(_eager(pl, params, kv, cuda, tokens, padded, lens, pextra))
    calls = [_snap(comp(tokens, tables, lens, *extra)) for _ in range(3)]
    torch.cuda.synchronize()
    assert (comp.captures, comp.replays) == (1, 2)
    for got in calls:
        _bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [5, 37, 512])
def test_cuda_moe_oneshot_program_equals_the_unpadded_eager_call(cuda, S):
    """The compiled one-shot program of a moe model runs eagerly at the
    exact length (no pad row joins a routing group) and captures no
    graph: every call equals the eager unpadded prefill bit for bit."""
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import PagedKVCache
    from repro_torch.serving.compiled import CompiledPrefill
    cfg, params = _moe_bf16(cuda)
    kv = PagedKVCache(cfg, 128, 4, device=cuda)
    comp = CompiledPrefill(cfg, params, kv, cuda, None)
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                             size=S).tolist()
    lu, cu = ttf.prefill(params, cfg, {"tokens": [toks]}, max_seq=S,
                         device=cuda)
    want = [lu.clone(), cu["k"][:, 0].clone(), cu["v"][:, 0].clone()]
    for _ in range(3):
        got = [t.clone() for t in comp.run_oneshot(toks)]
        _bitwise(got, want)
    assert (comp.oneshot.captures, comp.oneshot.replays) == (0, 0)
    assert got[1].shape[2] == S


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cuda_moe_offload_engine_launch_accounting(cuda, kv_dtype):
    """The moe_offload engine on the card: no chunk launches (moe prompts
    run one-shot), 2 workers' decode launches a layer a step, through
    graph replays; every request finishes; the expert pool logs
    transfer_bytes_moe a token."""
    from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                     SamplingParams, transfer_bytes_moe)
    cfg, params = _moe_bf16(cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (21, 12, 9)]
    dec = pda.paged_decode_attention_int8 if kv_dtype == "int8" else \
        pda.paged_decode_attention
    chunk = (ppa.paged_prefill_chunk_attention,
             ppa.paged_prefill_chunk_attention_int8)
    for placement in ("homogeneous", "moe_offload"):
        econf = EngineConfig(max_batch=4, block_size=4, num_blocks=64,
                             kv_dtype=kv_dtype, placement=placement,
                             attention_workers=2, expert_workers=2,
                             prefill_chunk_tokens=8)
        eng = LLMEngine(cfg, params, econf, device=cuda)
        reqs = [Request(prompt=list(x), params=SamplingParams(
            max_new_tokens=12)) for x in prompts]
        n0, c0 = dec.launches, [f.launches for f in chunk]
        eng.submit(reqs)
        eng.run()
        torch.cuda.synchronize()
        assert all(len(r.output) == 12 for r in reqs)
        st = eng.stats
        assert st.prefill_chunks_run == 0
        assert [f.launches for f in chunk] == c0
        workers = 2 if placement == "moe_offload" else 1
        assert dec.launches - n0 == cfg.num_layers * st.steps * workers
        assert eng.compiled.replays > 0
        if placement == "moe_offload":
            assert eng.expert_pool.log.total == \
                transfer_bytes_moe(cfg, 1) * st.tokens_generated


# ---------------------------------------------------------------------------
# the audio family and the converter's block on the card
# ---------------------------------------------------------------------------
def _cos(a, b):
    a, b = a.float().flatten(), b.float().flatten()
    return float(a @ b / (a.norm() * b.norm()))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["stacked", "listed"])
def test_cuda_seamless_decode_matches_the_cpu(cuda, layout):
    """seamless's smoke encoder-decoder in bf16 (G = 1, hd = 64): prefill
    then 3 greedy decode steps on the card and on the CPU from the same
    weights; every step launches the dense kernel twice a layer (self and
    cross) and its logits agree with the CPU's at row cosine >= 0.999 (the
    kernel and its twin differ in bf16 rounding). The listed layout's step
    equals the stacked one bit for bit."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as ttf
    cfg = treg.get_smoke_config("seamless-m4t-medium", dtype=torch.bfloat16)
    cpu = ttf.init_params(0, cfg, device="cpu")
    params = tree_map(lambda a: a.to(cuda), cpu)
    rng = np.random.default_rng(3)
    batch = {"frames": rng.standard_normal((2, 300, cfg.d_model)).astype(
                 np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 6))}
    lg, cache = ttf.prefill(params, cfg, batch, 10, device=cuda)
    clg, ccache = ttf.prefill(cpu, cfg, batch, 10, device="cpu")
    assert _cos(lg.cpu(), clg) >= 0.999
    listed = tree_map(lambda a: a, params)
    listed["layers"] = [ttf._layer(params["layers"], i)
                        for i in range(cfg.num_layers)]
    for _ in range(3):
        tok = lg.argmax(-1).int()
        da.decode_attention.launches = 0
        lg, upd = ttf.decode_step(params, cfg, tok, cache, device=cuda)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == 2 * cfg.num_layers
        clg, cupd = ttf.decode_step(cpu, cfg, tok.cpu(), ccache,
                                    device="cpu")
        for i in range(2):
            assert _cos(lg[i].cpu(), clg[i]) >= 0.999
        if layout == "listed":
            lcache = {k: v if k == "len" else list(v)
                      for k, v in cache.items()}
            llg, lupd = ttf.decode_step(listed, cfg, tok, lcache,
                                        device=cuda)
            assert torch.equal(llg, lg)
            assert torch.equal(torch.stack(lupd["k_new"]), upd["k_new"])
        cache = ttf.apply_decode_updates(cache, upd)
        ccache = ttf.apply_decode_updates(ccache, cupd)


@pytest.mark.gpu
def test_cuda_converter_block_with_a_dense_kernel_callback(cuda):
    """A block graph (G = 4, hd = 64) on the card, fp32 ops, its attention
    callback appending the step's k/v to a bf16 dense cache of 99 tokens
    and launching the dense decode kernel: sliced = unsliced bit for bit,
    the callback's output within 2 bf16 ulps of the kernel's plain twin,
    and the rotational run over 3 batches = their direct runs."""
    from repro_torch.configs import registry as treg
    from repro_torch.core import converter, pipeline
    from repro_torch.models import blocks as tblocks
    cfg = treg.get_smoke_config("llama3-8b", num_heads=8, num_kv_heads=2)
    B, S, G, hd = 4, 100, cfg.gqa_group, cfg.resolved_head_dim
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = tblocks.init_dense_block(gen, cfg, cuda)
    g = converter.build_block_graph(cfg, weights=w, batch=B, device=cuda)
    sp = converter.split_at_attention(g)
    kc = torch.randn((B, cfg.num_kv_heads, S, hd), generator=gen,
                     device=cuda).bfloat16()
    vc = torch.randn_like(kc)
    lens = torch.full((B,), S, dtype=torch.int32, device=cuda)
    seen = []

    def attn_fn(name, env, kernel=da.decode_attention):
        kc[:, :, S - 1] = env["k_proj"].bfloat16()
        vc[:, :, S - 1] = env["v_proj"].bfloat16()
        q = env["q_proj"].bfloat16().reshape(B, cfg.num_kv_heads, G, hd)
        o = kernel(q, kc, vc, lens)
        seen.append((q, o))
        return o.float().reshape(B, cfg.num_heads, hd)

    x = {"x": torch.randn((B, cfg.d_model), generator=gen, device=cuda)}
    da.decode_attention.launches = 0
    env = sp.run(x, attn_fn)
    direct = dict(x)
    for name in g.order:
        op = g.ops[name]
        if op.kind == "attention":
            direct[name] = attn_fn(name, direct)
        elif op.kind != "input":
            direct[name] = op.fn(*[direct[i] for i in op.inputs])
    torch.cuda.synchronize()
    assert da.decode_attention.launches == 2
    assert torch.equal(env["residual2"], direct["residual2"])
    q, o = seen[0]
    want = da.decode_attention_plain(q, kc, vc, lens)
    torch.testing.assert_close(o.float(), want.float(), rtol=8e-3, atol=1e-3)
    envs, log = pipeline.run_rotational(
        [sp] * 3, [x] * 3, lambda j, name, env: attn_fn(name, env))
    for e in envs:
        assert torch.equal(e["residual2"], env["residual2"])
    assert all(r == (j + k) % 2 for j, k, r in log)


# ---------------------------------------------------------------------------
# the shape-only faces: a fake tensor's call returns the kernel's metadata
# ---------------------------------------------------------------------------
def _face_cases(dev):
    """(entry, wrapper call, operands) for every CUDA entry at a small
    shape that splits the KV (a workspace) where the kernel can."""
    rng = np.random.default_rng(0)
    q, kp, vp, bt, lens = _rand_paged(7, 2, 2, 4, 128, 16, 40)
    pool = [_bf16(q, dev), _bf16(kp, dev), _bf16(vp, dev),
            torch.from_numpy(bt).to(dev), torch.from_numpy(lens).to(dev)]
    kq, ks = _int8_pool(kp, dev)
    vq, vs = _int8_pool(vp, dev)
    chunk = [_bf16(rng.standard_normal((40, 8, 128)), dev)] + pool[1:3] + \
        [pool[3][0].contiguous()] + \
        [_bf16(rng.standard_normal((40, 2, 128)), dev) for _ in range(2)]
    S = 640
    dq = _bf16(rng.standard_normal((2, 2, 4, 128)), dev)
    dk, dv = (_bf16(rng.standard_normal((2, 2, S, 128)), dev)
              for _ in range(2))
    dl = torch.tensor([S, 100], dtype=torch.int32, device=dev)
    dkq, dks = _int8_pool(dk.float().cpu(), dev)
    dvq, dvs = _int8_pool(dv.float().cpu(), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    x = torch.randn((2, 40, 4, 32), **f32)
    Bi, Ci = (torch.randn((2, 40, 16), **f32) for _ in range(2))
    decay = torch.rand((2, 40, 4), **f32)
    rkvw = [torch.randn((2, 40, 4, 32), **f32) for _ in range(4)]
    rkvw[3] = torch.rand((2, 40, 4, 32), **f32)
    u = torch.randn((4, 32), **f32)
    dy = torch.randn((2, 40, 4, 32), **f32)
    part = dict(return_partials=True)
    return [
        ("paged_decode_attention_bf16", pda.paged_decode_attention, pool,
         part),
        ("paged_decode_attention_int8", pda.paged_decode_attention_int8,
         [pool[0], kq, vq, ks, vs] + pool[3:], part),
        ("paged_prefill_chunk_attention_bf16",
         ppa.paged_prefill_chunk_attention, chunk, {}),
        ("paged_prefill_chunk_attention_int8",
         ppa.paged_prefill_chunk_attention_int8,
         [chunk[0], kq, vq, ks, vs] + chunk[3:], {}),
        ("decode_attention_bf16", da.decode_attention, [dq, dk, dv, dl],
         part),
        ("decode_attention_int8", da.decode_attention_int8,
         [dq, dkq, dvq, dks, dvs, dl], part),
        ("ssm_scan_f32", ssm.ssm_scan, [x, Bi, Ci, decay], {}),
        ("ssm_scan_bwd_f32", ssm.ssm_scan_bwd, [x, Bi, Ci, decay, dy], {}),
        ("rwkv6_scan_bf16", rw.rwkv6_scan,
         [a.bfloat16() for a in rkvw] + [u], {}),
        ("rwkv6_scan_f32", rw.rwkv6_scan, rkvw + [u], {}),
        ("rwkv6_scan_bwd_bf16", rw.rwkv6_scan_bwd,
         [a.bfloat16() for a in rkvw] + [u, dy], {}),
        ("rwkv6_scan_bwd_f32", rw.rwkv6_scan_bwd, rkvw + [u, dy], {}),
    ]


FACE_ENTRIES = ["paged_decode_attention_bf16", "paged_decode_attention_int8",
                "paged_prefill_chunk_attention_bf16",
                "paged_prefill_chunk_attention_int8",
                "decode_attention_bf16", "decode_attention_int8",
                "ssm_scan_f32", "ssm_scan_bwd_f32", "rwkv6_scan_bf16",
                "rwkv6_scan_f32", "rwkv6_scan_bwd_bf16",
                "rwkv6_scan_bwd_f32"]
LAUNCH_COUNTERS = (pda.paged_decode_attention,
                   pda.paged_decode_attention_int8,
                   ppa.paged_prefill_chunk_attention,
                   ppa.paged_prefill_chunk_attention_int8,
                   da.decode_attention, da.decode_attention_int8,
                   ssm.ssm_scan, ssm.ssm_scan_bwd, rw.rwkv6_scan,
                   rw.rwkv6_scan_bwd)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", FACE_ENTRIES)
def test_cuda_face_returns_the_kernels_metadata(cuda, entry):
    """The entry's face on fake copies of the operands: outputs of the
    real launch's shapes, dtypes and strides; the cost it reports equal to
    the real launch's; no launch counted and no fake tensor among the
    stream tickets."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import LocalCounter
    name, fn, args, kw = next(c for c in _face_cases(cuda) if c[0] == entry)
    with LocalCounter(args) as real_count:
        real = fn(*args, **kw)
    torch.cuda.synchronize()
    real = real if isinstance(real, tuple) else (real,)
    before = [f.launches for f in LAUNCH_COUNTERS]
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) for a in args]
        with LocalCounter(fargs) as fake_count:
            fake = fn(*fargs, **kw)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [f.launches for f in LAUNCH_COUNTERS] == before
    assert len(fake) == len(real)
    for f, r in zip(fake, real):
        assert (tuple(f.shape), f.dtype, f.stride(), f.device) == \
            (tuple(r.shape), r.dtype, r.stride(), r.device)
    assert fake_count.kernel_calls == real_count.kernel_calls == {name: 1}
    assert fake_count.kernel_flops == real_count.kernel_flops > 0
    assert fake_count.kernel_bytes == real_count.kernel_bytes > 0
    assert not any(_cuda.is_fake(t) for t in _cuda._TICKETS.values())


# ---------------------------------------------------------------------------
# the long_500k shapes (chip_smoke phase 24): one sequence of 524,288 tokens
# ---------------------------------------------------------------------------
LONG_S = 524_288


def _nan_outside(pos, clen, window, sinks):
    """Slots no mask keeps: at or past cache_len, or outside the window
    and the sinks."""
    out = pos >= clen
    if window:
        out |= (pos < clen - window) & (pos >= sinks)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("Hkv,G,int8,window,sinks", [
    (8, 4, False, 0, 0), (8, 4, True, 0, 0), (8, 4, True, 8191, 0),
    (2, 16, True, 8191, 4)])
def test_cuda_paged_decode_at_524k(cuda, Hkv, G, int8, window, sinks):
    """Rows 1 / 3 over one layer's pool of 32,768 blocks of 16 (llama3-8b,
    glm4-9b-sinks at the 256-split cap), every slot no mask keeps (stale,
    outside the window and sinks, a spare block) NaN (NaN scales for
    int8)."""
    bs, nb = 16, LONG_S // 16
    gen = torch.Generator(device=cuda).manual_seed(Hkv * G + window)
    NB = nb + 4
    kp = torch.randn((Hkv, NB, bs, 128), generator=gen,
                     device=cuda).bfloat16()
    vp = torch.randn_like(kp)
    table = (torch.randperm(NB - 1, generator=gen, device=cuda)[:nb]
             + 1).int()[None]
    clen = torch.tensor([LONG_S - 3], dtype=torch.int32, device=cuda)
    pos = torch.arange(LONG_S, device=cuda).reshape(nb, bs)
    stale = torch.zeros((NB, bs), dtype=torch.bool, device=cuda)
    stale[0] = True
    stale[table[0].long()] = _nan_outside(pos, int(clen), window, sinks)
    q = torch.randn((1, Hkv, G, 128), generator=gen, device=cuda).bfloat16()
    kw = dict(sliding_window=window, attention_sinks=sinks,
              return_partials=True)
    pools = (kp, vp)
    if int8:
        from repro_torch.models.kv_quant import quantize_kv
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        ks[:, stale] = float("nan")
        vs[:, stale] = float("nan")
        pools = (kq, vq)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        kp[:, stale] = float("nan")
        vp[:, stale] = float("nan")
    assert pda.plan_splits(1, Hkv, nb, _cuda.sm_count(cuda), G) == \
        min(pda.max_splits(G), -(-4 * _cuda.sm_count(cuda) // Hkv))
    got = pda.paged_decode_attention(q, *pools, table, clen, **kw)
    want = pda.paged_decode_attention_plain(q, *pools, table, clen, **kw)
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_chunk_prefill_at_524k(cuda, int8):
    """Rows 2 / 4: a 512-token chunk at P = 523,776 with llama3-8b-sw8k's
    window of 8192, over a pool of 32,741 blocks (the kernel's tile skip
    far from P = 0, its TMA maps over the whole pool); NaN in the blocks
    the table skips."""
    bs, C = 16, 512
    P = LONG_S - C
    nb = P // bs
    NB = nb + 5
    gen = torch.Generator(device=cuda).manual_seed(24)
    kp = torch.randn((8, NB, bs, 128), generator=gen, device=cuda).bfloat16()
    vp = torch.randn_like(kp)
    table = torch.randperm(NB, generator=gen, device=cuda)[:nb].int()
    unref = torch.ones(NB, dtype=torch.bool, device=cuda)
    unref[table.long()] = False
    q = torch.randn((C, 32, 128), generator=gen, device=cuda).bfloat16()
    kc = torch.randn((C, 8, 128), generator=gen, device=cuda).bfloat16()
    vc = torch.randn_like(kc)
    kw = dict(sliding_window=8192)
    pools = (kp, vp)
    if int8:
        from repro_torch.models.kv_quant import quantize_kv
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        ks[:, unref] = float("nan")
        vs[:, unref] = float("nan")
        pools = (kq, vq)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        kp[:, unref] = float("nan")
        vp[:, unref] = float("nan")
    got = ppa.paged_prefill_chunk_attention(q, *pools, table, kc, vc, **kw)
    want = ppa.paged_prefill_chunk_attention_plain(q, *pools, table, kc, vc,
                                                   **kw)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("Hkv,G,hd,int8,window,sinks", [
    (32, 1, 64, False, 0, 0), (2, 16, 128, False, 8191, 4),
    (8, 4, 128, True, 8191, 0)], ids=["zamba2", "glm4-9b-sinks",
                                      "llama3-8b-sw8k-int8"])
def test_cuda_dense_decode_at_524k(cuda, Hkv, G, hd, int8, window, sinks):
    """Row 5 (and 5-int8) over a dense cache of 524,288 rows at B = 1:
    zamba2's shared attention (9 splits of ~58K rows), glm4-9b-sinks and
    llama3-8b-sw8k past their windows; NaN in every slot no mask keeps."""
    gen = torch.Generator(device=cuda).manual_seed(Hkv + G)
    k = torch.randn((1, Hkv, LONG_S, hd), generator=gen,
                    device=cuda).bfloat16()
    v = torch.randn_like(k)
    clen = torch.tensor([LONG_S - 8], dtype=torch.int32, device=cuda)
    stale = _nan_outside(torch.arange(LONG_S, device=cuda), int(clen),
                         window, sinks)
    q = torch.randn((1, Hkv, G, hd), generator=gen, device=cuda).bfloat16()
    kw = dict(sliding_window=window, attention_sinks=sinks,
              return_partials=True)
    caches = (k, v)
    if int8:
        from repro_torch.models.kv_quant import quantize_kv
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        ks[:, :, stale] = float("nan")
        vs[:, :, stale] = float("nan")
        caches = (kq, vq)
        kw.update(k_scale=ks, v_scale=vs)
    else:
        k[:, :, stale] = float("nan")
        v[:, :, stale] = float("nan")
    got = da.decode_attention(q, *caches, clen, **kw)
    want = da.decode_attention_plain(q, *caches, clen, **kw)
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=1e-3)


def _call_ms(fn, iters=20):
    """Device milliseconds a call of ``fn`` takes, the mean of ``iters``
    calls after a warm one, by CUDA events, the calls enqueued while the
    card spins (so the host's enqueue time is not counted)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@pytest.mark.gpu
@pytest.mark.parametrize("paged,Hkv,G,sinks", [
    (True, 8, 4, 0), (True, 2, 16, 4), (False, 8, 4, 0)],
    ids=["row 3 llama3-8b-sw8k", "row 3 glm4-9b-sinks G=16",
         "row 5-int8 llama3-8b-sw8k"])
def test_cuda_window_at_524k_spreads_over_the_splits(cuda, paged, Hkv, G,
                                                     sinks):
    """A window of 8192 at the end of an int8 sequence of 524,288 tokens
    takes at most a quarter of the full-context call's device time and
    equals its plain twin: the splits share the window's rows. Cutting
    the whole table (cache) put them in 1-5 splits, and the windowed call
    took 0.33-0.53 of the full-context one on an H100
    (``tools/window_split_ab.py``)."""
    gen = torch.Generator(device=cuda).manual_seed(Hkv * G)
    shape = (Hkv, LONG_S // 16, 16, 128) if paged else (1, Hkv, LONG_S, 128)
    kq, vq = (torch.randint(-127, 128, shape, generator=gen, device=cuda,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(shape[:-1], generator=gen, device=cuda) * 0.025 +
              0.005 for _ in range(2))
    q = torch.randn((1, Hkv, G, 128), generator=gen, device=cuda).bfloat16()
    clen = torch.tensor([LONG_S], dtype=torch.int32, device=cuda)
    if paged:
        table = torch.arange(shape[1], dtype=torch.int32, device=cuda)[None]
        mod, args = pda, (q, kq, vq, table, clen)
        fn = pda.paged_decode_attention
    else:
        mod, args = da, (q, kq, vq, clen)
        fn = da.decode_attention
    kw = dict(k_scale=ks, v_scale=vs, attention_sinks=sinks,
              return_partials=True)
    full = _call_ms(lambda: fn(*args, sliding_window=0, **kw))
    win = _call_ms(lambda: fn(*args, sliding_window=8191, **kw))
    assert win <= 0.25 * full, (win, full)
    plain = mod.paged_decode_attention_plain if paged else \
        mod.decode_attention_plain
    got = fn(*args, sliding_window=8191, **kw)
    want = plain(*args, sliding_window=8191, **kw)
    for a, b, tol in zip(got, want, (8e-3, 1e-3, 1e-3)):
        assert torch.isfinite(a.float()).all()
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=1e-3)


@pytest.mark.gpu
def test_cuda_rwkv6_scan_at_2_31_elements(cuda):
    """Row 7 at rwkv6-7b's B = 1, S = 524,288, H = 64, P = 64: B·S·H·P =
    2^31 elements, the kernel's 64-bit row bases at their edge, against
    the chunked twin in 64-step tiles (the step twin takes minutes)."""
    import functools
    B, S, H, P = 1, LONG_S, 64, 64
    gen = torch.Generator(device=cuda).manual_seed(248)
    r, k, v = (torch.randn((B, S, H, P), generator=gen,
                           device=cuda).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, S, H, P), generator=gen,
                                         device=cuda) - 2.0)).bfloat16()
    u = torch.randn((H, P), generator=gen, device=cuda) * 0.5
    y = rw.rwkv6_scan(r, k, v, w, u)
    assert y.shape == (B, S, H, P) and y.numel() == 2 ** 31
    want = functools.partial(rw.rwkv6_scan_chunked_plain, chunk=64)(
        r, k, v, w, u)
    _scan_close(y, want)


@pytest.mark.gpu
def test_cuda_chunk_program_runs_keys_past_its_graphs_eagerly(cuda,
                                                               monkeypatch):
    """A prompt of more chunk keys than the chunk program keeps graphs:
    the chunks with MAX_GRAPHS or more of the prompt still to run go
    eagerly (the same kernels), the last MAX_GRAPHS are captured, and the
    greedy tokens equal those of an engine that captures every key; the
    chunk kernel counts L a chunk both ways."""
    from repro_torch.configs import registry as treg
    from repro_torch.models import transformer as ttf
    from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                     SamplingParams)
    from repro_torch.serving import compiled as C

    cfg = treg.get_smoke_config("llama3-8b", num_kv_heads=2,
                                dtype=torch.bfloat16)
    params = ttf.init_params(0, cfg, device=cuda)
    econf = EngineConfig(max_batch=1, block_size=4, num_blocks=64,
                         prefill_chunk_tokens=8, kv_dtype="int8")
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, size=75).tolist()             # 10 chunks
    fn = ppa.paged_prefill_chunk_attention_int8
    outs = {}
    for cap in (4, 64):
        monkeypatch.setattr(C, "MAX_GRAPHS", cap)
        eng = LLMEngine(cfg, params, econf, device=cuda)
        req = Request(prompt=list(prompt),
                      params=SamplingParams(max_new_tokens=6))
        n0 = fn.launches
        eng.submit([req])
        eng.run()
        torch.cuda.synchronize()
        outs[cap] = req.output
        ch = eng.compiled_prefill.chunk
        chunks = eng.stats.prefill_chunks_run
        assert chunks == 10
        assert fn.launches - n0 == cfg.num_layers * chunks
        assert ch.captures == min(cap, chunks)
        assert ch.eager_calls == chunks - ch.captures
    assert outs[4] == outs[64]
