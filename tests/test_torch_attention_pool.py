"""The port's attention-pool placement (Lamina's model-attention
disaggregation) against the JAX reference on the CPU, after
``tests/test_llm_engine.py``.

For every partition (head | request | block) over a bf16 and an int8 pool:
greedy tokens equal the reference ``LLMEngine`` under the same placement
and weights, and the port's own homogeneous engine; the ``TransferLog``
fields and ``per_worker_kv_bytes`` equal the reference's after the same
run; per-token wire bytes equal the paper's §3.1 formula
(``expected_transfer_bytes``). One allocate / share / append / free
sequence replayed on both block-sharded pools gives equal shard tables and
per-shard live tokens. gemma2 (local/global windows, sinks, softcaps)
drives the sliced decode step through the block partition with chunked
prefill on an int8 pool.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import LLMEngine as JLLMEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.serving import (AttentionWorkerPool, EngineConfig,
                                 LLMEngine, PagedKVCache, Request,
                                 SamplingParams, TransferLog,
                                 expected_transfer_bytes)
from repro_torch.serving.worker_pool import owner_masked_tables
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def llama():
    cfg = jreg.get_smoke_config("llama3-8b", num_kv_heads=2)
    tcfg = treg.get_smoke_config("llama3-8b", num_kv_heads=2)
    p = jtf.init_params(jax.random.PRNGKey(0), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    return cfg, tcfg, p, tp


def _serve(cfg, tcfg, p, tp, prompts, new_tokens, **kw):
    """The same requests through the reference and the port engine."""
    jreqs = [JRequest(prompt=list(x), params=JSamplingParams(
        max_new_tokens=new_tokens)) for x in prompts]
    jeng = JLLMEngine(cfg, p, JEngineConfig(**kw))
    jeng.submit(jreqs)
    jeng.run()
    treqs = [Request(prompt=list(x), params=SamplingParams(
        max_new_tokens=new_tokens)) for x in prompts]
    teng = LLMEngine(tcfg, tp, EngineConfig(**kw), device="cpu")
    teng.submit(treqs)
    teng.run()
    return jeng, [r.output for r in jreqs], teng, [r.output for r in treqs]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("partition", ["head", "request", "block"])
def test_attention_pool_matches_reference_and_homogeneous(llama, partition,
                                                          kv_dtype):
    cfg, tcfg, p, tp = llama
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (21, 12, 9)]
    kw = dict(placement="attention_pool", partition=partition,
              attention_workers=2, max_batch=4, block_size=8, num_blocks=64,
              kv_dtype=kv_dtype)
    jeng, jout, teng, tout = _serve(cfg, tcfg, p, tp, prompts, 5, **kw)
    assert tout == jout
    homo = LLMEngine(tcfg, tp, EngineConfig(max_batch=4, block_size=8,
                                            num_blocks=64, kv_dtype=kv_dtype),
                     device="cpu")
    hreqs = [Request(prompt=list(x), params=SamplingParams(max_new_tokens=5))
             for x in prompts]
    homo.submit(hreqs)
    homo.run()
    assert tout == [r.output for r in hreqs]
    assert isinstance(teng.pool, AttentionWorkerPool)
    assert isinstance(teng.transfer_log, TransferLog)
    assert dataclasses.asdict(teng.pool.log) == \
        dataclasses.asdict(jeng.pool.log)
    assert teng.pool.per_worker_kv_bytes == jeng.pool.per_worker_kv_bytes
    assert min(teng.pool.per_worker_kv_bytes) > 0
    per_token = teng.pool.log.total / teng.stats.tokens_generated
    assert per_token == pytest.approx(expected_transfer_bytes(tcfg, 1))
    assert teng.kv.n_shards == (2 if partition == "block" else 1)
    assert teng.stats.kv_bytes_read_per_step == \
        jeng.stats.kv_bytes_read_per_step


def test_block_shard_tables_replay_identically(llama):
    cfg, tcfg, _, _ = llama
    jkv = JPagedKVCache(cfg, 16, 4, n_shards=2)
    tkv = PagedKVCache(tcfg, 16, 4, n_shards=2, device="cpu")
    for kv in (jkv, tkv):
        kv.allocate(0, 13)             # 4 blocks round-robin over 2 shards
        kv.share_blocks(0, 1, 10)      # shares a partial third block
        kv.allocate(1, 12)
        kv.append_token(1)             # CoW of the shared tail, slot rule
        kv.allocate(2, 6)
        for _ in range(3):
            kv.append_token(2)         # grows a third block
        kv.free_seq(0)
        kv.allocate(3, 9)
    assert tkv.tables == jkv.tables and tkv.free == jkv.free
    assert tkv.refcounts == jkv.refcounts
    for ids in ([1, 2, 3], [3, 1], None):
        if ids is not None:
            for got, want in zip(tkv.block_table_shards(ids),
                                 jkv.block_table_shards(ids)):
                np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tkv.shard_live_tokens(ids),
                                      jkv.shard_live_tokens(ids))
    assert [tkv.shard_of(b) for b in tkv.tables[1]] == [0, 1, 0, 1]


def test_block_partition_without_shard_tables_masks_foreign_slots(llama):
    """A direct caller without the cache's compacted tables gets the
    owner-masked global table: the same output as the compacted path."""
    _, tcfg, _, _ = llama
    kv = PagedKVCache(tcfg, 16, 4, n_shards=2, device="cpu")
    g = torch.Generator().manual_seed(3)
    L, Hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    for sid, n in ((0, 13), (1, 7)):
        kv.allocate(sid, n)
        kv.write_prefill(sid, torch.randn(L, Hkv, n, hd, generator=g),
                         torch.randn(L, Hkv, n, hd, generator=g))
    tables, lens = kv.block_table_batch([0, 1])
    lt, lp, _ = kv.block_table_shards([0, 1])
    gt = lt + (np.arange(2, dtype=np.int32) * 8)[:, None, None]
    q = torch.randn(2, tcfg.num_heads, hd, generator=g)
    k_new = torch.randn(2, Hkv, hd, generator=g)
    pool = AttentionWorkerPool(tcfg, 2, "block")
    args = (q, kv.k_pool[0], kv.v_pool[0], torch.from_numpy(tables),
            torch.from_numpy(lens), k_new, k_new)
    compact = pool.attend_paged(*args, shard_tables=torch.from_numpy(gt),
                                shard_positions=torch.from_numpy(lp))
    masked = pool.attend_paged(*args)
    torch.testing.assert_close(compact, masked, rtol=1e-5, atol=1e-6)
    homo = AttentionWorkerPool(tcfg, 1, "request").attend_paged(*args)
    torch.testing.assert_close(compact, homo, rtol=1e-5, atol=1e-6)
    mt, mp = owner_masked_tables(torch.from_numpy(tables), 8, 2, 4)
    assert all(torch.equal(t, torch.from_numpy(tables)) for t in mt)
    assert int((mp[0] < 1 << 30).sum() + (mp[1] < 1 << 30).sum()) == \
        tables.size


def test_attention_pool_gemma2_block_int8_chunked_matches_reference():
    """gemma2 drives every exotic branch of the sliced decode step —
    alternating local/global windows (a prompt longer than the 64-token
    window), sinks, attention and final softcaps, post-norms, tied
    embeddings — through the block partition, over an int8 pool with
    chunked prefill."""
    cfg = jreg.get_smoke_config("gemma2-27b")
    tcfg = treg.get_smoke_config("gemma2-27b")
    p = jtf.init_params(jax.random.PRNGKey(1), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (70, 9)]
    kw = dict(placement="attention_pool", partition="block",
              attention_workers=2, max_batch=2, block_size=8, num_blocks=64,
              kv_dtype="int8", prefill_chunk_tokens=16)
    jeng, jout, teng, tout = _serve(cfg, tcfg, p, tp, prompts, 6, **kw)
    assert tout == jout
    assert dataclasses.asdict(teng.pool.log) == \
        dataclasses.asdict(jeng.pool.log)
    assert teng.pool.per_worker_kv_bytes == jeng.pool.per_worker_kv_bytes
    assert teng.stats.prefill_chunks_run == jeng.stats.prefill_chunks_run > 2
