"""The port's block-granular KV handoff (``PagedKVCache.export_seqs`` /
``prealloc_handoff`` / ``write_handoff_blocks`` / ``import_seqs`` and
``write_token``) against the JAX package's, after
``tests/test_kv_handoff.py`` and the handoff tests of
``tests/test_int8_kvpool.py``.

* The same op sequence (allocate, share a prefix, extend, append with a
  copy-on-write fork, ``write_token``) on a JAX pool and a port pool gives
  equal payloads: tables, lengths, ``block_ids``, the K/V tiles bit for
  bit (compared through integer views: bf16 has no numpy dtype), the
  scales, ``nbytes`` and ``bytes_of_blocks``; bf16, fp32 and int8 pools.
* ``import_seqs`` across source × destination shard counts {1, 2, 4}²
  gives the reference's mapping, tables and refcounts, and every block
  reads back exactly; an incremental ``write_handoff_blocks`` lands the
  same pool as the one-shot import, in place.
* Every error path raises as the reference's does: unknown sequence,
  block size, an existing rid, kv_dtype mismatch both ways (before any
  write), all-or-nothing prealloc.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.serving import PoolExhausted as JPoolExhausted
from repro.serving.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.configs import registry as treg
from repro_torch.serving import KVHandoffPayload, PagedKVCache, PoolExhausted
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

INT_OF = {1: (np.int8, torch.int8), 2: (np.int16, torch.int16),
          4: (np.int32, torch.int32)}
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16, "bf16"),
          "fp32": (jnp.float32, torch.float32, "bf16"),
          "int8": (jnp.bfloat16, torch.bfloat16, "int8")}


def _cfgs(dtype):
    jd, td, _ = DTYPES[dtype]
    return (jreg.get_smoke_config("llama3-8b", dtype=jd),
            treg.get_smoke_config("llama3-8b", dtype=td))


def _pools(dtype, num_blocks=64, block_size=4, src_shards=1):
    jcfg, tcfg = _cfgs(dtype)
    kvd = DTYPES[dtype][2]
    return (JPagedKVCache(jcfg, num_blocks, block_size, n_shards=src_shards,
                          kv_dtype=kvd),
            PagedKVCache(tcfg, num_blocks, block_size, n_shards=src_shards,
                         kv_dtype=kvd, device="cpu"))


def jbits(a):
    """A JAX / numpy array's raw bits as a numpy integer array."""
    a = np.asarray(a)
    return a.view(INT_OF[a.dtype.itemsize][0])


def tbits(t):
    """A torch tensor's raw bits as a numpy integer array."""
    return t.view(INT_OF[t.element_size()][1]).numpy()


def _to_jax(x, like):
    return jnp.asarray(x, like.dtype)


def _to_torch(x, like):
    """numpy float32 -> the torch pool's dtype, through the JAX rounding
    (bf16 crosses as bits)."""
    a = np.asarray(jnp.asarray(x, {torch.bfloat16: jnp.bfloat16,
                                   torch.float32: jnp.float32}[like]))
    return torch.from_numpy(jbits(a).copy()).view(like)


def _fill(jkv, tkv, seed):
    """Recognisable, identical content in both pools (values, and scales
    of an int8 pool)."""
    rng = np.random.default_rng(seed)
    if jkv.kv_dtype == "int8":
        for name in ("k_pool", "v_pool"):
            x = rng.integers(-127, 128, getattr(jkv, name).shape,
                             dtype=np.int8)
            setattr(jkv, name, jnp.asarray(x))
            getattr(tkv, name).copy_(torch.from_numpy(x))
        for name in ("k_scale", "v_scale"):
            x = rng.random(getattr(jkv, name).shape, dtype=np.float32)
            setattr(jkv, name, jnp.asarray(x))
            getattr(tkv, name).copy_(torch.from_numpy(x))
        return
    for name in ("k_pool", "v_pool"):
        x = rng.standard_normal(getattr(jkv, name).shape, dtype=np.float32)
        setattr(jkv, name, _to_jax(x, getattr(jkv, name)))
        getattr(tkv, name).copy_(_to_torch(x, getattr(tkv, name).dtype))


def _ops(seed):
    """A seeded op sequence after the reference's round-trip property:
    1-4 sequences of 1-40 tokens, later ones sharing a prefix of the
    first (then extended), some growing one token (a copy-on-write fork
    of a shared tail) whose K/V lands by ``write_token``."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 5))
    lens = rng.integers(1, 41, size=n).tolist()
    ops = [("allocate", 0, lens[0])]
    for i in range(1, n):
        shared = int(rng.integers(0, min(lens[0], lens[i]) + 1))
        if shared:
            ops.append(("share", i, shared))
            if lens[i] > shared:
                ops.append(("allocate", i, lens[i]))
        else:
            ops.append(("allocate", i, lens[i]))
    grow = [i for i in range(1, n) if rng.random() < 0.5]
    return ops, grow, list(range(n))


def _apply(jkv, tkv, ops, grow, seed):
    for op, sid, n in ops:
        for kv in (jkv, tkv):
            if op == "share":
                kv.share_blocks(0, sid, n)
            else:
                kv.allocate(sid, n)
    _fill(jkv, tkv, seed)
    rng = np.random.default_rng(seed + 1)
    L, Hkv, hd = jkv.k_pool.shape[0], jkv.k_pool.shape[1], \
        jkv.k_pool.shape[4]
    for sid in grow:
        pos = jkv.lengths[sid]
        k = rng.standard_normal((L, Hkv, hd), dtype=np.float32)
        v = rng.standard_normal((L, Hkv, hd), dtype=np.float32)
        jkv.append_token(sid)
        tkv.append_token(sid)
        jkv.write_token(sid, jnp.asarray(k, jkv.cfg.dtype),
                        jnp.asarray(v, jkv.cfg.dtype), pos)
        tkv.write_token(sid, _to_torch(k, tkv.cfg.dtype),
                        _to_torch(v, tkv.cfg.dtype), pos)


def _payload_equal(jp, tp):
    assert isinstance(tp, KVHandoffPayload)
    assert tp.tables == jp.tables
    assert tp.lengths == jp.lengths
    assert tp.block_ids == jp.block_ids
    assert tp.block_size == jp.block_size
    assert tp.k_blocks.device.type == "cpu"
    for name in ("k_blocks", "v_blocks", "k_scales", "v_scales"):
        j, t = getattr(jp, name), getattr(tp, name)
        assert (j is None) == (t is None), name
        if j is not None:
            assert tuple(t.shape) == np.asarray(j).shape, name
            np.testing.assert_array_equal(tbits(t), jbits(j), err_msg=name)
    assert tp.n_blocks == jp.n_blocks
    assert tp.nbytes == jp.nbytes
    for n in range(tp.n_blocks + 1):
        assert tp.bytes_of_blocks(n) == jp.bytes_of_blocks(n)


def _pools_equal(jkv, tkv):
    assert tkv.tables == jkv.tables
    assert tkv.lengths == jkv.lengths
    assert tkv.refcounts == jkv.refcounts
    assert tkv._borrowed == jkv._borrowed
    assert tkv._free_shard == jkv._free_shard
    for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
        j, t = getattr(jkv, name), getattr(tkv, name)
        if j is not None:
            np.testing.assert_array_equal(tbits(t), jbits(j), err_msg=name)


# ======================================================================
# export: the same op sequence gives the same payload
# ======================================================================
@pytest.mark.parametrize("dtype", ["bf16", "fp32", "int8"])
@pytest.mark.parametrize("seed", range(6))
def test_export_payload_equals_the_reference(dtype, seed):
    src_shards = (1, 2, 4)[seed % 3]
    jkv, tkv = _pools(dtype, src_shards=src_shards)
    ops, grow, sids = _ops(seed)
    _apply(jkv, tkv, ops, grow, seed)
    _pools_equal(jkv, tkv)             # write_token (and its CoW) agree
    jp, tp = jkv.export_seqs(sids), tkv.export_seqs(sids)
    _payload_equal(jp, tp)
    # every referenced physical block crosses exactly once
    unique = {b for sid in sids for b in tkv.tables[sid]}
    assert set(tp.block_ids) == unique and tp.n_blocks == len(unique)
    # the payload does not alias the pool: later pool writes leave it
    before = tbits(tp.k_blocks).copy()
    tkv.k_pool.zero_()
    np.testing.assert_array_equal(tbits(tp.k_blocks), before)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_write_token_equals_the_reference(dtype):
    """write_token into a private, then a shared (copy-on-write) block."""
    jkv, tkv = _pools(dtype, num_blocks=16)
    for kv in (jkv, tkv):
        kv.allocate(1, 6)
        kv.share_blocks(1, 2, 6)
    _fill(jkv, tkv, 3)
    rng = np.random.default_rng(4)
    L, Hkv, hd = jkv.k_pool.shape[0], jkv.k_pool.shape[1], \
        jkv.k_pool.shape[4]
    for sid, pos in ((1, 2), (2, 5), (1, 5)):
        k = rng.standard_normal((L, Hkv, hd), dtype=np.float32) * 3
        v = rng.standard_normal((L, Hkv, hd), dtype=np.float32)
        jkv.write_token(sid, jnp.asarray(k, jkv.cfg.dtype),
                        jnp.asarray(v, jkv.cfg.dtype), pos)
        tkv.write_token(sid, _to_torch(k, tkv.cfg.dtype),
                        _to_torch(v, tkv.cfg.dtype), pos)
        _pools_equal(jkv, tkv)
    assert tkv.cow_forks == jkv.cow_forks == 2


# ======================================================================
# import: mapping, tables, refcounts, data — across shard geometries
# ======================================================================
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("src_shards", [1, 2, 4])
@pytest.mark.parametrize("dst_shards", [1, 2, 4])
def test_import_equals_the_reference(dtype, src_shards, dst_shards):
    jkv, tkv = _pools(dtype, src_shards=src_shards)
    ops, grow, sids = _ops(10 + src_shards * 3 + dst_shards)
    _apply(jkv, tkv, ops, grow, 7)
    jp, tp = jkv.export_seqs(sids), tkv.export_seqs(sids)
    jdst, tdst = _pools(dtype, src_shards=dst_shards)
    jdst.allocate(99, 9)             # a resident sequence first
    tdst.allocate(99, 9)
    tk_pool = tdst.k_pool
    jmap, tmap = jdst.import_seqs(jp), tdst.import_seqs(tp)
    assert tmap == jmap
    assert tdst.k_pool is tk_pool     # written in place, never rebound
    _pools_equal(jdst, tdst)
    # the data reads back exactly, block by block
    for sb, db in tmap.items():
        for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
            s, d = getattr(tkv, name), getattr(tdst, name)
            if s is not None:
                np.testing.assert_array_equal(tbits(d[:, :, db]),
                                              tbits(s[:, :, sb]))
    # refcounts = referencing table entries; sharing survives the wire
    refs = {}
    for sid in sids:
        for b in tdst.tables[sid]:
            refs[b] = refs.get(b, 0) + 1
    assert {b: tdst.refcounts[b] for b in refs} == refs
    assert tdst.used_blocks == tp.n_blocks + 3


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("budget", [1, 2, 3])
def test_incremental_transfer_equals_one_shot_import(dtype, budget):
    jkv, tkv = _pools(dtype, src_shards=2)
    ops, grow, sids = _ops(21)
    _apply(jkv, tkv, ops, grow, 21)
    tp = tkv.export_seqs(sids)
    _, one = _pools(dtype, src_shards=2)
    _, inc = _pools(dtype, src_shards=2)
    one.import_seqs(tp)
    mapping = inc.prealloc_handoff(tp)
    landed = 0
    for start in range(0, tp.n_blocks, budget):
        stop = min(start + budget, tp.n_blocks)
        landed += inc.write_handoff_blocks(tp, mapping, start, stop)
    assert landed == tp.nbytes
    assert inc.write_handoff_blocks(tp, mapping, tp.n_blocks,
                                    tp.n_blocks) == 0
    assert inc.tables == one.tables and inc.refcounts == one.refcounts
    for name in ("k_pool", "v_pool", "k_scale", "v_scale"):
        if getattr(one, name) is not None:
            assert torch.equal(getattr(inc, name), getattr(one, name))


def test_payload_bytes_int8_vs_bf16():
    """The int8 payload ships (hd + 4) / (2·hd) of the bf16 bytes, scales
    counted per block, as in the reference."""
    i8 = _pools("int8", num_blocks=16)[1]
    bf = _pools("bf16", num_blocks=16)[1]
    for kv in (i8, bf):
        kv.allocate(1, 10)
    p8, pbf = i8.export_seqs([1]), bf.export_seqs([1])
    hd = i8.k_pool.shape[4]
    assert p8.nbytes * 2 * hd == pbf.nbytes * (hd + 4)
    assert p8.bytes_of_blocks(1) * p8.n_blocks == p8.nbytes


# ======================================================================
# error paths: raised as the reference raises them
# ======================================================================
def _raises_alike(jcall, tcall, exc, jexc=None, match=None):
    with pytest.raises(jexc or exc, match=match) as je:
        jcall()
    with pytest.raises(exc, match=match) as te:
        tcall()
    return je.value, te.value


def test_export_unknown_seq_rejected():
    jkv, tkv = _pools("bf16", num_blocks=16)
    _raises_alike(lambda: jkv.export_seqs([7]), lambda: tkv.export_seqs([7]),
                  ValueError, match="no table")


def test_import_rejects_block_size_mismatch():
    jkv, tkv = _pools("bf16", num_blocks=16)
    jkv.allocate(0, 10)
    tkv.allocate(0, 10)
    jdst, tdst = _pools("bf16", num_blocks=16, block_size=8)
    _raises_alike(lambda: jdst.prealloc_handoff(jkv.export_seqs([0])),
                  lambda: tdst.prealloc_handoff(tkv.export_seqs([0])),
                  ValueError, match="block_size")


def test_import_rejects_existing_rid():
    jkv, tkv = _pools("bf16", num_blocks=16)
    jdst, tdst = _pools("bf16", num_blocks=16)
    for kv in (jkv, tkv):
        kv.allocate(0, 10)
    for kv in (jdst, tdst):
        kv.allocate(0, 4)
    _raises_alike(lambda: jdst.prealloc_handoff(jkv.export_seqs([0])),
                  lambda: tdst.prealloc_handoff(tkv.export_seqs([0])),
                  ValueError, match="already has a table")


@pytest.mark.parametrize("n_shards,quarantine", [(1, None), (2, 1)])
def test_prealloc_is_all_or_nothing(n_shards, quarantine):
    """A destination that cannot cover the payload raises PoolExhausted
    (degraded context included) and allocates nothing."""
    jkv, tkv = _pools("bf16", num_blocks=32)
    for kv in (jkv, tkv):
        kv.allocate(0, 40)                 # 10 blocks
    jdst, tdst = _pools("bf16", num_blocks=8, src_shards=n_shards)
    if quarantine is not None:
        jdst.quarantine_shard(quarantine)
        tdst.quarantine_shard(quarantine)
    free = tdst.num_free
    je, te = _raises_alike(
        lambda: jdst.prealloc_handoff(jkv.export_seqs([0])),
        lambda: tdst.prealloc_handoff(tkv.export_seqs([0])),
        PoolExhausted, jexc=JPoolExhausted)
    assert str(te) == str(je)
    assert (te.rid, te.free_blocks, te.live_tokens, te.quarantined_shards,
            te.live_shards) == (je.rid, je.free_blocks, je.live_tokens,
                                je.quarantined_shards, je.live_shards)
    assert te.rid == 0 and te.free_blocks == free
    assert tdst.num_free == free and tdst.tables == {}
    assert tdst.refcounts == {}


@pytest.mark.parametrize("direction", ["int8_into_bf16", "bf16_into_int8"])
def test_kv_dtype_mismatch_raises_before_any_write(direction):
    src_dtype, dst_dtype = direction.split("_into_")
    jsrc, tsrc = _pools(src_dtype, num_blocks=16)
    for kv in (jsrc, tsrc):
        kv.allocate(1, 6)
    _fill(jsrc, tsrc, 5)
    jdst, tdst = _pools(dst_dtype, num_blocks=16)
    pools = [t.clone() for t in (tdst.k_pool, tdst.v_pool)]
    _raises_alike(lambda: jdst.import_seqs(jsrc.export_seqs([1])),
                  lambda: tdst.import_seqs(tsrc.export_seqs([1])),
                  ValueError, match="kv_dtype")
    assert torch.equal(tdst.k_pool, pools[0])
    assert torch.equal(tdst.v_pool, pools[1])


def test_write_handoff_rejects_another_value_dtype():
    """A bf16 payload into an fp32 pool: the port refuses (index_copy_
    does not cast) before any write."""
    _, src = _pools("bf16", num_blocks=16)
    src.allocate(1, 6)
    _, dst = _pools("fp32", num_blocks=16)
    with pytest.raises(ValueError, match="payload tiles"):
        dst.import_seqs(src.export_seqs([1]))
    assert not bool(dst.k_pool.any())

