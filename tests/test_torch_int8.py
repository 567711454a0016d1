"""The port's int8 KV pool against the JAX reference on the CPU.

* ``quantize_kv`` / ``quantize_token`` give the reference's int8 values and
  scales bit for bit (fp32 math, round half to even on both sides).
* The int8 plain twins of both paged kernels equal the reference's int8
  oracles (``kernels/ref.py``) and its Pallas int8 kernels in interpret
  mode, with POS_PAD block positions, window + sinks and softcap. Inputs
  are fp32 queries over int8 pools with positive fp32 scales; tolerance
  rtol 1e-4, atol 1e-5 (fp32 sums in another order, over at most a few
  hundred keys).
* The pool's scales follow its blocks (copy-on-write copies the scale tile
  and spares the donor's), every write path quantizes as the reference's
  does (one op sequence replayed on both caches gives equal pools and
  scales), and resident / per-token bytes are (hd + 4) / (hd·e) of the
  unquantized pool's.
* ``LLMEngine(kv_dtype="int8")`` greedy tokens equal the reference engine's
  on the same weights, with chunked prefill off and on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as j_paged_decode_kernel
from repro.kernels.paged_prefill_attention import \
    paged_prefill_chunk_attention as j_paged_prefill_kernel
from repro.models import kv_quant as jkq
from repro.models import transformer as jtf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import LLMEngine as JLLMEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.configs import registry as treg
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.kernels import ref as tref
from repro_torch.models import kv_quant as tkq
from repro_torch.models import transformer as ttf
from repro_torch.serving import (EngineConfig, LLMEngine, PagedKVCache,
                                 Request, SamplingParams)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ----------------------------------------------------------------------
# quantization
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,dtype", [((2, 3, 17, 64), "float32"),
                                         ((4, 2, 32), "float32"),
                                         ((3, 5, 9, 16), "bfloat16")])
def test_quantize_equals_reference_exactly(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[..., 0, :] = 0.0                       # all-zero rows: the 1e-8 floor
    x.flat[5] = 127.0 * 0.5                  # exact halves: round to even
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    for jfn, tfn in ((jkq.quantize_kv, tkq.quantize_kv),
                     (jkq.quantize_token, tkq.quantize_token)):
        jq, js = jfn(jx)
        tq, ts = tfn(tx)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tkq.dequantize_kv(tq, ts).numpy(),
        np.asarray(jkq.dequantize_kv(jq, js)))


# ----------------------------------------------------------------------
# int8 paged decode: twin vs reference oracle and Pallas kernel
# ----------------------------------------------------------------------
def _int8_paged(seed, B, Hkv, G, hd, bs, nb, spare=3):
    """Random int8 pools with positive per-token scales, per-sequence
    tables of distinct blocks padded with block 0, ragged lengths."""
    rng = np.random.default_rng(seed)
    NB = B * nb + spare
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    kp = rng.integers(-127, 128, size=(Hkv, NB, bs, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, size=(Hkv, NB, bs, hd)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, size=(Hkv, NB, bs)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, size=(Hkv, NB, bs)).astype(np.float32)
    lens = rng.integers(1, nb * bs + 1, size=B).astype(np.int32)
    lens[0] = nb * bs
    perm = rng.permutation(np.arange(1, NB))[:B * nb].reshape(B, nb)
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        live = -(-int(lens[b]) // bs)
        bt[b, :live] = perm[b, :live]
    return q, kp, vp, ks, vs, bt, lens


DECODE_CASES = {
    "plain": dict(G=4),
    "gqa1": dict(G=1),
    "window-sinks": dict(G=4, sliding_window=19, attention_sinks=3),
    "softcap": dict(G=2, logit_softcap=30.0),
    "window-softcap": dict(G=4, sliding_window=11, attention_sinks=2,
                           logit_softcap=50.0),
    "pos-pad": dict(G=4, pos_pad=True, sliding_window=20, attention_sinks=3),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_int8_decode_plain_matches_reference(case):
    kw = dict(DECODE_CASES[case])
    G, pos_pad = kw.pop("G"), kw.pop("pos_pad", False)
    B, Hkv, hd, bs, nb = 3, 2, 32, 8, 5
    q, kp, vp, ks, vs, bt, lens = _int8_paged(len(case), B, Hkv, G, hd, bs,
                                              nb)
    pos = None
    if pos_pad:          # a block-sharded table: foreign slots are POS_PAD
        lens[:] = nb * bs
        pos = np.tile(np.arange(nb, dtype=np.int32) * bs, (B, 1))
        pos[:, 1::2] = pda.POS_PAD
    o, l, m = pda.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(bt), _t(lens), k_scale=_t(ks),
        v_scale=_t(vs), block_positions=None if pos is None else _t(pos),
        return_partials=True, **kw)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, ks, vs, bt, lens)]
    jpos = None if pos is None else jnp.asarray(pos)
    want = jref.paged_decode_attention_int8_ref(*jargs, block_positions=jpos,
                                                **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **TOL)
    jo, jl, jm = j_paged_decode_kernel(
        jargs[0], jargs[1], jargs[2], jargs[5], jargs[6], k_scale=jargs[3],
        v_scale=jargs[4], block_positions=jpos, interpret=True,
        return_partials=True, **kw)
    for got, ref in ((o, jo), (l, jl), (m, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # ... and the port's own vectorised oracle
    mine = tref.paged_decode_attention_int8_ref(
        _t(q), _t(kp), _t(vp), _t(ks), _t(vs), _t(bt), _t(lens),
        block_positions=None if pos is None else _t(pos), **kw)
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), **TOL)


def test_int8_decode_plain_selects_away_nan_scales():
    """Stale NaN scales of free blocks (block 0, behind padded slots) and
    past cache_len never reach the output: masks select, never multiply."""
    q, kp, vp, ks, vs, bt, lens = _int8_paged(7, 3, 2, 4, 32, 8, 4)
    lens[1] = 5
    args = (_t(q), _t(kp), _t(vp), _t(bt), _t(lens))
    clean = pda.paged_decode_attention(*args, k_scale=_t(ks.copy()),
                                       v_scale=_t(vs.copy()),
                                       return_partials=True)
    ks[:, 0] = np.nan
    vs[:, 0] = np.nan
    ks[:, bt[1, 0], 5:] = np.nan
    vs[:, bt[1, 0], 5:] = np.inf
    dirty = pda.paged_decode_attention(*args, k_scale=_t(ks), v_scale=_t(vs),
                                       return_partials=True)
    for a, b in zip(clean, dirty):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_int8_decode_is_close_to_full_precision():
    """The contract of tests/test_int8_parity.py on the port's twin: int8
    attention over a quantized unit-scale pool against the same attention
    over the unquantized pool, cosine >= 0.999."""
    rng = np.random.default_rng(11)
    B, Hkv, G, hd, bs, nb = 2, 2, 4, 64, 16, 6
    kf = torch.from_numpy(rng.standard_normal((Hkv, 14, bs, hd)).astype(
        np.float32))
    vf = torch.from_numpy(rng.standard_normal((Hkv, 14, bs, hd)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, hd)).astype(
        np.float32))
    bt = torch.from_numpy(rng.permutation(14)[:B * nb].reshape(B, nb).astype(
        np.int32))
    lens = torch.tensor([nb * bs, nb * bs - 7], dtype=torch.int32)
    kq, kscale = tkq.quantize_kv(kf)
    vq, vscale = tkq.quantize_kv(vf)
    got = pda.paged_decode_attention(q, kq, vq, bt, lens, k_scale=kscale,
                                     v_scale=vscale).flatten()
    want = pda.paged_decode_attention(q, kf, vf, bt, lens).flatten()
    assert float(got @ want / (got.norm() * want.norm())) >= 0.999


# ----------------------------------------------------------------------
# int8 chunk prefill: twin vs reference oracle and Pallas kernel
# ----------------------------------------------------------------------
PREFILL_CASES = [(5, 0, 0, 0, 0.0), (11, 3, 0, 0, 0.0), (16, 2, 0, 0, 30.0),
                 (9, 4, 13, 2, 0.0), (7, 5, 20, 3, 50.0)]


@pytest.mark.parametrize("C,nb,sw,sinks,cap", PREFILL_CASES)
def test_int8_prefill_plain_matches_reference(C, nb, sw, sinks, cap):
    rng = np.random.default_rng(C * 7 + nb)
    Hkv, G, hd, bs, NB = 2, 2, 32, 8, 9
    q = rng.standard_normal((C, Hkv * G, hd)).astype(np.float32)
    kp = rng.integers(-127, 128, size=(Hkv, NB, bs, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, size=(Hkv, NB, bs, hd)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, size=(Hkv, NB, bs)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, size=(Hkv, NB, bs)).astype(np.float32)
    table = rng.permutation(NB)[:nb].astype(np.int32)
    kc = rng.standard_normal((C, Hkv, hd)).astype(np.float32)
    vc = rng.standard_normal((C, Hkv, hd)).astype(np.float32)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    got = ppa.paged_prefill_chunk_attention(
        _t(q), _t(kp), _t(vp), _t(table), _t(kc), _t(vc), k_scale=_t(ks),
        v_scale=_t(vs), **kw)
    j = [jnp.asarray(a) for a in (q, kp, vp, ks, vs, table, kc, vc)]
    want = jref.paged_prefill_chunk_attention_int8_ref(*j, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pallas = j_paged_prefill_kernel(j[0], j[1], j[2], j[5], j[6], j[7],
                                    k_scale=j[3], v_scale=j[4],
                                    interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    mine = tref.paged_prefill_chunk_attention_int8_ref(
        *[_t(a) for a in (q, kp, vp, ks, vs, table, kc, vc)], **kw)
    np.testing.assert_allclose(mine.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------------
# the int8 pool: scales follow blocks, write paths, bytes
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke():
    return (jreg.get_smoke_config("llama3-8b", num_kv_heads=2),
            treg.get_smoke_config("llama3-8b", num_kv_heads=2))


def test_int8_pool_cow_copies_scale_tile_and_spares_donor(smoke):
    _, tcfg = smoke
    kv = PagedKVCache(tcfg, 16, 4, kv_dtype="int8", device="cpu")
    L, Hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    g = torch.Generator().manual_seed(0)
    k, v = torch.randn(L, Hkv, 6, hd, generator=g), \
        torch.randn(L, Hkv, 6, hd, generator=g)
    kv.allocate(1, 6)                         # 2 blocks, partial tail
    kv.write_prefill(1, k, v)
    kv.share_blocks(1, 2, 6)
    tail = kv.tables[1][1]
    before = [t[:, :, tail].clone() for t in (kv.k_pool, kv.k_scale,
                                              kv.v_scale)]
    kv.allocate(2, 7)
    kv.append_token(2)                        # forks the shared tail
    fork = kv.tables[2][1]
    assert fork != tail and kv.cow_forks == 1
    for pool in (kv.k_pool, kv.v_pool, kv.k_scale, kv.v_scale):
        torch.testing.assert_close(pool[:, :, fork], pool[:, :, tail],
                                   rtol=0, atol=0)
    tok = torch.randn(L, 1, Hkv, hd, generator=g) * 9
    kv.write_tokens([2], tok, tok, [6])       # writes only the fork
    for t, b in zip((kv.k_pool, kv.k_scale, kv.v_scale), before):
        torch.testing.assert_close(t[:, :, tail], b, rtol=0, atol=0)
    assert not torch.equal(kv.k_scale[:, :, fork], kv.k_scale[:, :, tail])


@pytest.mark.parametrize("n_shards", [1, 2])
def test_int8_pool_write_paths_quantize_as_reference(smoke, n_shards):
    """One op sequence on both caches (prefill, chunk, share + CoW, batched
    token writes): equal tables, int8 pools and scale pools, bit for
    bit."""
    jcfg, tcfg = smoke
    jkv = JPagedKVCache(jcfg, 12, 4, n_shards=n_shards, kv_dtype="int8")
    tkv = PagedKVCache(tcfg, 12, 4, n_shards=n_shards, kv_dtype="int8",
                       device="cpu")
    rng = np.random.default_rng(n_shards)
    L, Hkv, hd = jcfg.num_layers, jcfg.num_kv_heads, jcfg.resolved_head_dim

    def both(fn):
        fn(jkv, jnp.asarray)
        fn(tkv, torch.from_numpy)

    a = rng.standard_normal((L, Hkv, 10, hd)).astype(np.float32) * 2
    both(lambda c, conv: c.allocate(0, 10))
    both(lambda c, conv: c.write_prefill(0, conv(a), conv(a * 0.5)))
    b = rng.standard_normal((L, Hkv, 8, hd)).astype(np.float32)
    both(lambda c, conv: c.write_prefill_chunk(1, conv(b), conv(b), 0))
    c8 = rng.standard_normal((L, Hkv, 3, hd)).astype(np.float32)
    both(lambda c, conv: c.write_prefill_chunk(1, conv(c8), conv(-c8), 8))
    both(lambda c, conv: c.share_blocks(0, 2, 10))
    both(lambda c, conv: c.allocate(2, 10))
    both(lambda c, conv: c.append_token(2))  # CoW of the shared tail
    both(lambda c, conv: c.append_token(0))
    t = rng.standard_normal((L, 2, Hkv, hd)).astype(np.float32) * 4
    both(lambda c, conv: c.write_tokens([0, 2], conv(t), conv(t[::-1].copy()),
                                        [10, 10]))
    assert tkv.tables == jkv.tables and tkv.refcounts == jkv.refcounts
    assert tkv.free == jkv.free and tkv.cow_forks == jkv.cow_forks == 1
    for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tkv, name).numpy(),
                                      np.asarray(getattr(jkv, name)))


def test_int8_pool_bytes_are_a_fraction_of_the_unquantized_pool(smoke):
    _, tcfg = smoke
    L, Hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    i8 = PagedKVCache(tcfg, 16, 4, kv_dtype="int8", device="cpu")
    full = PagedKVCache(tcfg, 16, 4, device="cpu")
    e = full.k_pool.element_size()
    ratio = (hd + 4) / (hd * e)
    assert i8.pool_bytes_resident == 2 * L * Hkv * 64 * (hd + 4)
    assert i8.pool_bytes_resident == ratio * full.pool_bytes_resident
    assert i8.bytes_per_live_token() == 2 * L * Hkv * (hd + 4)
    assert i8.bytes_per_live_token() == ratio * full.bytes_per_live_token()


# ----------------------------------------------------------------------
# the engine on an int8 pool
# ----------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_int8_greedy_tokens_match_reference(smoke, chunk):
    jcfg, tcfg = smoke
    p = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    kw = dict(max_batch=4, block_size=8, num_blocks=64, kv_dtype="int8",
              prefill_chunk_tokens=chunk)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).tolist()
               for n in (21, 12, 9)]
    jreqs = [JRequest(prompt=list(x), params=JSamplingParams(
        max_new_tokens=5)) for x in prompts]
    jeng = JLLMEngine(jcfg, p, JEngineConfig(**kw))
    jeng.submit(jreqs)
    jeng.run()
    treqs = [Request(prompt=list(x), params=SamplingParams(max_new_tokens=5))
             for x in prompts]
    teng = LLMEngine(tcfg, tp, EngineConfig(**kw), device="cpu")
    teng.submit(treqs)
    teng.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert teng.stats.prefill_chunks_run == jeng.stats.prefill_chunks_run
    assert teng.stats.kv_pool_bytes_resident == \
        jeng.stats.kv_pool_bytes_resident
    assert teng.stats.kv_bytes_read_per_step == \
        jeng.stats.kv_bytes_read_per_step
