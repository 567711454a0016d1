"""The compiled decode step's CPU-testable parts (``serving/compiled.py``)
and the host side of the decode step, against the JAX reference.

* ``width_bucket`` covers every table width up to the pool's, never
  shrinks a table and never exceeds the pool.
* The eager decode step on width-padded operands (block 0 in pad slots;
  for the block partition also padded shard tables with POS_PAD
  positions) equals it on the unpadded ones, within 1e-5 at fp32, for
  every placement x partition x pool dtype: the padding a graph key
  implies changes nothing but the table's width.
* ``decode_extra_args`` — the host accounting that runs every step beside
  a replay, and the host operands the static buffers take — equals the
  reference's after the same op sequence: ``TransferLog`` /
  ``per_worker_kv_bytes`` and the shard tables and positions.
* A replay's launch accounting: the counts recorded while a step is
  captured are taken back out of the counters and every replay adds what
  an eager step adds.
* ``CompiledDecodeStep`` refuses a CPU device, and the engine never builds
  one there.

Capture and replay themselves need the card: ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving.kvcache import PagedKVCache as JPagedKVCache
from repro.serving.placement import make_placement as jmake_placement
from repro_torch.configs import registry as treg
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.models import transformer as ttf
from repro_torch.serving import (EngineConfig, LLMEngine, PagedKVCache,
                                 Request, SamplingParams, State,
                                 make_placement)
from repro_torch.serving.compiled import (COUNTED, COUNTERS,
                                          CompiledDecodeStep,
                                          LaunchDeltas, pad_operands,
                                          width_bucket)
from repro_torch.serving.placement import device_operands
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)     # fp32 smoke logits and K/V


@pytest.fixture(scope="module")
def llama():
    cfg = jreg.get_smoke_config("llama3-8b", num_kv_heads=2)
    tcfg = treg.get_smoke_config("llama3-8b", num_kv_heads=2)
    p = jtf.init_params(jax.random.PRNGKey(0), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    return cfg, tcfg, p, tp


@pytest.mark.parametrize("cap", [1, 5, 8, 100, 2048, 2049])
def test_width_bucket_covers_every_width_and_never_shrinks(cap):
    widths = [width_bucket(nb, cap) for nb in range(1, cap + 1)]
    for nb, w in enumerate(widths, start=1):
        assert nb <= w <= max(nb, cap)
        assert w == cap or (w >= 8 and w & (w - 1) == 0)
    assert widths == sorted(widths)               # monotone in the width
    assert len(set(widths)) <= max(cap, 8).bit_length() - 1


PLACEMENTS = {"homogeneous": dict(),
              "head": dict(placement="attention_pool", partition="head"),
              "request": dict(placement="attention_pool",
                              partition="request"),
              "block": dict(placement="attention_pool", partition="block")}


def _decoding_engine(tcfg, tp, **kw):
    """An engine paused where three requests of 21/12/9 prompt tokens are
    all decoding (block size 4: tables of 3-7 slots)."""
    eng = LLMEngine(tcfg, tp, EngineConfig(
        max_batch=4, block_size=4, num_blocks=96, attention_workers=2, **kw),
        device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, tcfg.vocab_size, size=n).tolist(),
                    params=SamplingParams(max_new_tokens=8))
            for n in (21, 12, 9)]
    eng.submit(reqs)
    while not all(r.state == State.RUNNING and eng.sched.prefill_done(r.rid)
                  and r.output for r in reqs):
        eng.step()
    eng.step()
    return eng, reqs


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", list(PLACEMENTS))
def test_eager_step_on_padded_operands_equals_unpadded(llama, name,
                                                       kv_dtype):
    _, tcfg, _, tp = llama
    eng, reqs = _decoding_engine(tcfg, tp, kv_dtype=kv_dtype,
                                 **PLACEMENTS[name])
    ids = [r.rid for r in reqs]
    tokens = [r.output[-1] for r in reqs]
    tables, lens = eng.kv.block_table_batch(ids)
    extra = eng.placement.decode_extra_args(eng.kv, ids)
    padded, pextra = pad_operands(tables, extra, eng.kv.num_blocks,
                                  eng.kv.blocks_per_shard)
    assert padded.shape[1] == 8 > tables.shape[1]
    assert (padded[:, tables.shape[1]:] == 0).all()
    if name == "block":
        assert pextra[0].shape[-1] == 8 > extra[0].shape[-1]
        assert (pextra[1][..., extra[1].shape[-1]:] == pda.POS_PAD).all()
    step = eng.placement.decode_fn()
    scales = eng._scale_kwargs("k_scale_pool", "v_scale_pool")
    outs = [step(tp, tokens, eng.kv.k_pool, eng.kv.v_pool,
                 torch.from_numpy(t), torch.from_numpy(lens),
                 *device_operands(e, "cpu"), **scales)
            for t, e in ((tables, extra), (padded, pextra))]
    (l0, u0), (l1, u1) = outs
    torch.testing.assert_close(l1, l0, **TOL)
    for key in ("k_new", "v_new", "len"):
        torch.testing.assert_close(u1[key], u0[key], **TOL)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("partition", ["head", "request", "block"])
def test_decode_extra_args_host_side_matches_reference(llama, partition,
                                                       kv_dtype):
    """The same allocate / share / append sequence on both pools, then
    the step's host side for several batches: equal accounting and equal
    operands (the port's shard tables hold global ids)."""
    cfg, tcfg, _, _ = llama
    kw = dict(placement="attention_pool", partition=partition,
              attention_workers=2, kv_dtype=kv_dtype, block_size=4,
              num_blocks=16)
    n = 2 if partition == "block" else 1
    jkv = JPagedKVCache(cfg, 16, 4, n_shards=n, kv_dtype=kv_dtype)
    tkv = PagedKVCache(tcfg, 16, 4, n_shards=n, kv_dtype=kv_dtype,
                       device="cpu")
    for kv in (jkv, tkv):
        kv.allocate(0, 13)
        kv.share_blocks(0, 1, 10)
        kv.allocate(1, 12)
        kv.append_token(1)
        kv.allocate(2, 6)
    jpl = jmake_placement(cfg, JEngineConfig(**kw))
    tpl = make_placement(tcfg, EngineConfig(**kw), torch.device("cpu"))
    for ids in ([0, 1, 2], [2, 0], [1]):
        jx = jpl.decode_extra_args(jkv, ids)
        tx = tpl.decode_extra_args(tkv, ids)
        assert len(tx) == len(jx)
        if tx:
            offsets = np.arange(n)[:, None, None] * tkv.blocks_per_shard
            np.testing.assert_array_equal(tx[0] - offsets, np.asarray(jx[0]))
            np.testing.assert_array_equal(tx[1], np.asarray(jx[1]))
            assert all(isinstance(a, np.ndarray) for a in tx)
        tpl.log_step(len(ids))
        jpl.log_step(len(ids))
    assert dataclasses.asdict(tpl.pool.log) == dataclasses.asdict(jpl.pool.log)
    assert tpl.pool.per_worker_kv_bytes == jpl.pool.per_worker_kv_bytes


def test_replay_launch_accounting_adds_what_an_eager_step_adds():
    fn, fn8 = pda.paged_decode_attention, pda.paged_decode_attention_int8
    assert fn in COUNTED and fn8 in COUNTED and len(set(COUNTED)) == 8
    assert (fn, "tc_launches") in COUNTERS

    def step():        # stands in for a 3-layer step, 2 workers a layer
        fn8.launches += 3 * 2
        fn.launches += 3            # ... and 3 bf16 launches at G = 16
        fn.tc_launches += 3

    def counts():
        return {key: getattr(*key) for key in COUNTERS}

    start = counts()
    step()                                      # the eager first call
    eager = {k: n - start[k] for k, n in counts().items()}
    deltas = LaunchDeltas()
    with deltas.record():
        step()                                  # the capture
    assert {k: n - start[k] for k, n in counts().items()} == eager
    for _ in range(2):
        deltas.replay()
    assert {k: n - start[k] for k, n in counts().items()} == \
        {k: 3 * n for k, n in eager.items()}
    assert fn.tc_launches - start[(fn, "tc_launches")] == 9
    with pytest.raises(RuntimeError):           # a failed capture counts 0
        with LaunchDeltas().record():
            step()
            raise RuntimeError("capture failed")
    assert fn8.launches - start[(fn8, "launches")] == 18
    assert fn.launches - start[(fn, "launches")] == 9
    assert fn.tc_launches - start[(fn, "tc_launches")] == 9


def test_compiled_step_is_never_built_on_the_cpu(llama):
    _, tcfg, _, tp = llama
    kv = PagedKVCache(tcfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="eagerly"):
        CompiledDecodeStep(lambda *a, **k: None, tp, kv.k_pool, kv.v_pool,
                           None, None, "cpu")
    eng = LLMEngine(tcfg, tp, EngineConfig(num_blocks=8, block_size=4),
                    device="cpu")
    assert eng.compiled is None
