"""The port's fault tolerance (``serving/faults.py``, the shard quarantine
of ``PagedKVCache`` and the engine's fault hooks) against the JAX engine,
under the same ``FaultScenario`` spec, after
``tests/test_fault_tolerance.py``.

* The parity matrix: ``attention_pool`` × ``head | request | block`` ×
  {bf16, int8} pools, prefix sharing and chunked prefill on, a mid-decode
  shard death with a later rejoin: greedy outputs equal the port's own
  fault-free run and the JAX faulted run; the fault counters and the
  sequence of event kinds equal the JAX engine's.
* Transient, corrupt (within and past the retry budget), straggler and
  multi-fault scenarios, held the same way.
* The health tracker and the injector: the state machine, ``parse`` of
  the inline and the JSON form with its validation errors, probe and
  corruption budgets (``filter_decode`` on torch tensors).
* The shard-masked allocator: random op sequences over bf16 and int8
  pools (a hypothesis property, and the same checks over seeded
  sequences) replayed on the JAX pool too: the same tables, free lists and
  refcounts; a quarantined shard's free list never shrinks; every
  sequence's K/V and scales read back through its table as written
  (scale tiles follow their blocks through copy-on-write); the live-token
  accounting counts a shared block once.
* ``PoolExhausted`` and ``SchedulingStalled`` carry the degraded note.
"""
import json

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import FaultScenario as JFaultScenario
from repro.serving import LLMEngine as JLLMEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.kvcache import OutOfBlocks as JOutOfBlocks
from repro.serving.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.configs import registry as treg
from repro_torch.models import kv_quant
from repro_torch.models import transformer as ttf
from repro_torch.serving import (CorruptedLogitsError, EngineConfig,
                                 FaultEvent, FaultInjector, FaultScenario,
                                 LLMEngine, OutOfBlocks, PagedKVCache,
                                 PoolExhausted, Request, SamplingParams,
                                 SchedulingStalled, ShardHealthTracker)
from repro_torch.serving.faults import DEAD, HEALTHY, SUSPECT
from repro_torch.serving.kvcache import gather_blocks
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

COUNTERS = ("shard_failures", "shard_rejoins", "requests_recovered",
            "fault_retries", "preemptions", "transient_faults_recovered",
            "straggle_steps")


@pytest.fixture(scope="module")
def llama():
    cfg = jreg.get_smoke_config("llama3-8b")
    tcfg = treg.get_smoke_config("llama3-8b")
    p = jtf.init_params(jax.random.PRNGKey(0), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    return cfg, tcfg, p, tp


def _prompts(vocab, lens=(9, 14, 6), prefix=6, seed=0):
    """Prompts sharing a prefix (prefix sharing through recovery)."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, size=prefix).tolist()
    return [common + rng.integers(0, vocab, size=n).tolist() for n in lens]


def _econf(partition, **kw):
    base = dict(placement="attention_pool", partition=partition,
                attention_workers=2, num_blocks=64, block_size=4,
                max_batch=4, scheduler="preempt", prefix_sharing=True,
                prefill_chunk_tokens=8)
    if partition != "block":       # shard the pool: a boundary to kill
        base["kv_shards"] = 2
    base.update(kw)
    return base


def _port(llama, kw, scenario=None, new=10):
    _, tcfg, _, tp = llama
    inj = FaultInjector(FaultScenario.parse(scenario)) if scenario else None
    eng = LLMEngine(tcfg, tp, EngineConfig(**kw), inj, device="cpu")
    reqs = [Request(prompt=x, params=SamplingParams(max_new_tokens=new))
            for x in _prompts(tcfg.vocab_size)]
    eng.submit(reqs)
    eng.run()
    return eng, [r.output for r in reqs]


def _jax(llama, kw, scenario, new=10):
    cfg, _, p, _ = llama
    eng = JLLMEngine(cfg, p, JEngineConfig(**kw),
                     fault_injector=JFaultInjector(
                         JFaultScenario.parse(scenario)))
    reqs = [JRequest(prompt=x, params=JSamplingParams(max_new_tokens=new))
            for x in _prompts(cfg.vocab_size)]
    eng.submit(reqs)
    eng.run()
    return eng, [r.output for r in reqs]


def _held_to_reference(llama, kw, scenario):
    """The port faulted against its own fault-free run and the JAX faulted
    run: outputs, counters, event kinds. Returns the faulted engine."""
    _, free = _port(llama, kw)
    teng, tout = _port(llama, kw, scenario)
    jeng, jout = _jax(llama, kw, scenario)
    assert tout == free == jout
    for key in COUNTERS:
        assert getattr(teng.stats, key) == getattr(jeng.stats, key), key
    assert [e.kind for e in teng.event_log] == \
        [e.kind for e in jeng.event_log]
    assert len(teng.stats.recovery_latencies) == \
        teng.stats.requests_recovered
    return teng


# ======================================================================
# the parity matrix
# ======================================================================
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("partition", ["head", "request", "block"])
def test_shard_death_parity_matrix_matches_reference(llama, partition,
                                                     kv_dtype):
    kw = _econf(partition, kv_dtype=kv_dtype)
    eng = _held_to_reference(llama, kw,
                             "shard_death:shard=1,step=5,rejoin=14")
    s = eng.stats
    assert s.shard_failures == s.shard_rejoins == 1
    assert s.requests_recovered >= 1
    down = next(e for e in eng.event_log if e.kind == "shard_down")
    assert down.rid == -1 and down.info["shard"] == 1 and down.info["victims"]
    assert eng.kv.quarantined_shards == ()          # whole again
    assert eng.kv.capacity_blocks == kw["num_blocks"]
    assert eng.kv.tables == {} and eng.kv.num_free == kw["num_blocks"]


SCENARIOS = {
    "transient": ("transient:shard=0,step=3,failures=2", {}),
    "corrupt": ("corrupt:shard=1,step=6", {}),
    "corrupt_past_budget": ("corrupt:shard=1,step=5,failures=5",
                            dict(fault_retry_limit=2)),
    "straggler": ("straggle:shard=0,step=4,delay_ms=1", {}),
    "multi": ("transient:shard=0,step=2;straggle:shard=1,step=3,delay_ms=1;"
              "corrupt:shard=0,step=4;shard_death:shard=1,step=6,rejoin=15",
              {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_fault_scenario_matches_reference(llama, name):
    spec, extra = SCENARIOS[name]
    eng = _held_to_reference(llama, _econf("block", **extra), spec)
    s = eng.stats
    kinds = [e.kind for e in eng.event_log]
    if name == "transient":
        assert (s.transient_faults_recovered, s.fault_retries,
                s.shard_failures) == (1, 2, 0)
        assert eng.kv.quarantined_shards == ()
    elif name == "corrupt":
        assert (s.transient_faults_recovered, s.shard_failures) == (1, 0)
        assert "shard_suspect" in kinds and "recover" in kinds
    elif name == "corrupt_past_budget":
        assert s.shard_failures == 1 and eng.kv.quarantined_shards == (1,)
        assert eng.kv.capacity_blocks == 32
    elif name == "straggler":
        assert s.straggle_steps == 1 and s.shard_failures == 0
        assert s.preemptions == 0
        sus = [e for e in eng.event_log if e.kind == "shard_suspect"]
        assert sus[0].info["cause"] == "straggler"
    else:
        assert s.shard_failures == 1 and s.transient_faults_recovered == 2


def test_corrupt_retry_is_the_same_step_bit_for_bit(llama):
    """Every attempt of the corrupted step computes the same logits (the
    retry reruns the step on the same operands; nothing was committed)."""
    seen = []

    class Recording(FaultInjector):
        def filter_decode(self, step, logits):
            if step == 5:
                seen.append(logits.clone())
            return super().filter_decode(step, logits)

    _, tcfg, _, tp = llama
    eng = LLMEngine(tcfg, tp, EngineConfig(**_econf("block")),
                    Recording(FaultScenario.parse(
                        "corrupt:shard=0,step=5,failures=2")), device="cpu")
    eng.submit([Request(prompt=x, params=SamplingParams(max_new_tokens=10))
                for x in _prompts(tcfg.vocab_size)])
    eng.run()
    assert len(seen) == 3 and eng.stats.fault_retries == 2
    assert all(torch.equal(x, seen[0]) for x in seen[1:])


def test_unattributed_non_finite_logits_raise(llama):
    _, tcfg, _, tp = llama
    eng = LLMEngine(tcfg, tp, EngineConfig(num_blocks=32, block_size=4),
                    device="cpu")
    req = Request(prompt=[1, 2, 3], params=SamplingParams(max_new_tokens=4))
    eng._step_no = 7
    with pytest.raises(CorruptedLogitsError) as ei:
        eng._sample([req], torch.full((1, tcfg.vocab_size), float("nan")))
    assert ei.value.rids == (req.rid,) and ei.value.step == 7
    assert "no injected fault" in str(ei.value)


def test_stall_after_unrecoverable_death_names_degradation(llama):
    _, tcfg, _, tp = llama
    kw = _econf("block", num_blocks=16, prefix_sharing=False,
                prefill_chunk_tokens=None)
    eng = LLMEngine(tcfg, tp, EngineConfig(**kw), FaultInjector(
        FaultScenario.parse("shard_death:shard=0,step=2")), device="cpu")
    eng.submit([Request(prompt=list(range(1, 31)),
                        params=SamplingParams(max_new_tokens=4))])
    with pytest.raises(SchedulingStalled, match="DEGRADED"):
        eng.run()


# ======================================================================
# health tracker and injector
# ======================================================================
def test_health_tracker_state_machine():
    h = ShardHealthTracker(2, retry_limit=3)
    assert h.state(0) == HEALTHY
    assert h.strike(0) == SUSPECT and h.strike(0) == SUSPECT
    h.clear(0)
    assert h.state(0) == HEALTHY and h.strikes(0) == 0
    for _ in range(3):
        state = h.strike(0)
    assert state == DEAD and h.is_dead(0) and h.dead_shards == [0]
    h.clear(0)                      # clear never resurrects the dead
    assert h.is_dead(0) and h.strike(0) == DEAD
    h.mark_up(0)
    assert h.state(0) == HEALTHY and h.strikes(0) == 0 and not h.dead_shards
    with pytest.raises(ValueError):
        ShardHealthTracker(2, retry_limit=0)


def test_scenario_parse_inline_and_json_forms(tmp_path):
    spec = ("shard_death:shard=1,step=6,rejoin=20;"
            "corrupt:shard=0,step=9,failures=2;"
            "straggle:shard=1,step=3,delay_ms=5")
    sc = FaultScenario.parse(spec)
    assert [e.kind for e in sc] == ["straggle", "shard_death", "corrupt"]
    assert sc.events[1].rejoin_step == 20
    assert sc.events[0].delay_s == pytest.approx(5e-3)
    assert [(e.kind, e.shard, e.step, e.failures, e.rejoin_step, e.delay_s)
            for e in sc] == \
        [(e.kind, e.shard, e.step, e.failures, e.rejoin_step, e.delay_s)
         for e in JFaultScenario.parse(spec)]
    path = tmp_path / "scenario.json"
    path.write_text(json.dumps([
        {"kind": "shard_death", "shard": 0, "step": 4, "rejoin_step": 9},
        {"kind": "transient", "shard": 1, "step": 2}]))
    sc2 = FaultScenario.parse(str(path))
    assert len(sc2) == 2 and sc2.events[1].kind == "shard_death"
    path.write_text(json.dumps({"kind": "transient"}))
    with pytest.raises(ValueError, match="JSON list"):
        FaultScenario.parse(str(path))


@pytest.mark.parametrize("bad", [
    lambda: FaultEvent("meteor_strike", 0, 1),
    lambda: FaultEvent("shard_death", 0, 5, rejoin_step=5),
    lambda: FaultEvent("shard_death", 0, 0),
    lambda: FaultEvent("transient", -1, 2),
    lambda: FaultEvent("corrupt", 0, 2, failures=0),
    lambda: FaultEvent("straggle", 0, 2, delay_s=-1.0),
    lambda: FaultScenario.parse(""),
    lambda: FaultScenario.parse("corrupt:shard=0,step=2,zorp=1"),
    lambda: FaultScenario.parse("corrupt:shard=0,step"),
    lambda: FaultInjector(FaultScenario.parse(
        "shard_death:shard=0,step=2;shard_death:shard=0,step=9")),
])
def test_scenario_validation_errors(bad):
    with pytest.raises(ValueError):
        bad()


def test_injector_probe_budget_and_filter_decode():
    inj = FaultInjector(FaultScenario.parse(
        "shard_death:shard=1,step=3,rejoin=7;"
        "transient:shard=0,step=2,failures=2;corrupt:shard=1,step=4"))
    assert inj.probe(1, 2) and not inj.probe(1, 3) and not inj.probe(1, 6)
    assert inj.probe(1, 7) and inj.rejoins(7) == [1]
    assert inj.pending_rejoins(5) and not inj.pending_rejoins(7)
    assert [inj.probe(0, 2) for _ in range(3)] == [False, False, True]
    clean = torch.zeros((2, 8))
    out, shard = inj.filter_decode(4, clean)
    assert shard == 1 and torch.isnan(out).all() and not clean.isnan().any()
    out, shard = inj.filter_decode(4, clean)      # budget spent
    assert shard is None and out is clean
    assert inj.straggles(4) == []


def test_random_scenario_matches_reference():
    a = FaultScenario.random(7, n_shards=2, horizon=20)
    assert a.events == FaultScenario.random(7, n_shards=2, horizon=20).events
    assert FaultScenario.random(8, 2, 20).events != a.events
    ref = JFaultScenario.random(7, n_shards=2, horizon=20)
    assert [(e.kind, e.shard, e.step, e.failures, e.rejoin_step, e.delay_s)
            for e in a] == \
        [(e.kind, e.shard, e.step, e.failures, e.rejoin_step, e.delay_s)
         for e in ref]


# ======================================================================
# the shard-masked allocator
# ======================================================================
OPS = ("alloc", "share", "append", "free", "quarantine", "rejoin")


def _check_ops(ops, kv_dtype):
    """Replay ``ops`` on a port pool (with K/V data) and a JAX pool; check
    the invariants after every op."""
    jcfg = jreg.get_smoke_config("llama3-8b")
    tcfg = treg.get_smoke_config("llama3-8b")
    kv = PagedKVCache(tcfg, 32, 4, n_shards=4, kv_dtype=kv_dtype,
                      device="cpu")
    jkv = JPagedKVCache(jcfg, 32, 4, n_shards=4, kv_dtype=kv_dtype)
    L, Hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    rng = np.random.default_rng(len(ops))
    want = {}          # sid -> (k, v) (L, Hkv, n, hd) as the pool holds them

    def data(n):
        k = torch.from_numpy(rng.standard_normal((L, Hkv, n, hd),
                                                 np.float32))
        v = torch.from_numpy(rng.standard_normal((L, Hkv, n, hd),
                                                 np.float32))
        return k, v

    def stored(x):
        if kv_dtype != "int8":
            return x
        return kv_quant.dequantize_kv(*kv_quant.quantize_kv(x))

    for kind, sid, n in ops:
        shard = sid % kv.n_shards
        res = []
        for pool in (kv, jkv):
            try:
                if kind == "alloc" and sid not in pool.tables:
                    pool.allocate(sid, n)
                elif kind == "share" and sid in pool.tables \
                        and sid + 100 not in pool.tables:
                    pool.share_blocks(sid, sid + 100,
                                      max(1, min(n, pool.lengths[sid])))
                elif kind == "append" and sid in pool.tables:
                    pool.append_token(sid)
                elif kind == "free" and sid in pool.tables:
                    pool.free_seq(sid)
                elif kind == "quarantine":
                    pre = len(pool._free_shard[shard])
                    pool.quarantine_shard(shard)
                    assert len(pool._free_shard[shard]) == pre
                elif kind == "rejoin":
                    pool.rejoin_shard(shard)
                res.append("ok")
            except (OutOfBlocks, JOutOfBlocks):
                res.append("out")
        assert res[0] == res[1], (kind, sid, n)
        if res[0] == "ok":            # the port's data follows its blocks
            if kind == "alloc" and sid not in want:
                k, v = data(n)
                kv.write_prefill(sid, k, v)
                want[sid] = (stored(k), stored(v))
            elif kind == "share" and sid in want and sid + 100 not in want:
                m = kv.lengths[sid + 100]
                want[sid + 100] = tuple(x[:, :, :m] for x in want[sid])
            elif kind == "append" and sid in want:
                pos = kv.lengths[sid] - 1
                k, v = data(1)
                kv.write_tokens([sid], k[:, :, 0][:, None],
                                v[:, :, 0][:, None], [pos])
                want[sid] = tuple(torch.cat([w, stored(x)], dim=2)
                                  for w, x in zip(want[sid], (k, v)))
            elif kind == "free":
                want.pop(sid, None)
        # ---- invariants after every op ----
        assert kv.tables == jkv.tables and kv.free == jkv.free
        assert kv.refcounts == jkv.refcounts
        assert kv.quarantined_shards == jkv.quarantined_shards
        assert kv.capacity_blocks == jkv.capacity_blocks == \
            kv.blocks_per_shard * len(kv.live_shards)
        referenced = {b for t in kv.tables.values() for b in t}
        all_free = [b for s in kv._free_shard for b in s]
        assert len(all_free) == len(set(all_free))
        assert set(all_free).isdisjoint(referenced)
        assert len(all_free) + len(referenced) == kv.num_blocks
        for q in kv.quarantined_shards:
            assert all(kv.shard_of(b) != q for b in kv.free)
        assert kv.num_free == len(kv.free)
        # a shared block counts once
        assert kv.unique_live_tokens() == int(kv.shard_live_tokens().sum())
        assert kv.unique_live_tokens() <= sum(kv.lengths.values())
        assert np.array_equal(kv.shard_live_tokens(),
                              np.asarray(jkv.shard_live_tokens()))
        for s, (wk, wv) in want.items():
            n = kv.lengths[s]
            k, v = gather_blocks(kv.k_pool, kv.v_pool, kv.k_scale,
                                 kv.v_scale, torch.as_tensor(kv.tables[s]),
                                 tcfg.dtype)
            assert torch.equal(k[:, :, :n], wk[:, :, :n].to(tcfg.dtype))
            assert torch.equal(v[:, :, :n], wv[:, :, :n].to(tcfg.dtype))


@settings(deadline=None, max_examples=25)
@given(ops=st.lists(st.tuples(st.sampled_from(OPS), st.integers(0, 5),
                              st.integers(1, 24)), min_size=1, max_size=40),
       kv_dtype=st.sampled_from(["bf16", "int8"]))
def test_shard_masked_allocator_property(ops, kv_dtype):
    _check_ops(ops, kv_dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_shard_masked_allocator_seeded_sequences(kv_dtype, seed):
    rng = np.random.default_rng(seed)
    ops = [(OPS[int(rng.integers(len(OPS)))], int(rng.integers(0, 6)),
            int(rng.integers(1, 25))) for _ in range(40)]
    _check_ops(ops, kv_dtype)


def test_quarantined_shard_never_allocated_and_balance_holds(llama):
    _, tcfg, _, _ = llama
    kv = PagedKVCache(tcfg, 32, 4, n_shards=4, device="cpu")
    kv.quarantine_shard(2)
    kv.allocate(1, 24)                     # 6 blocks over 3 live shards
    placed = [kv.shard_of(b) for b in kv.tables[1]]
    assert 2 not in placed
    counts = [placed.count(s) for s in kv.live_shards]
    assert max(counts) - min(counts) <= 1
    kv.rejoin_shard(2)
    kv.allocate(2, 16)
    assert 2 in {kv.shard_of(b) for b in kv.tables[2]}
    kv.quarantine_shard(0)
    assert kv.seqs_on_shard(0) == [1, 2]
    for s in (1, 2, 3):
        kv.quarantine_shard(s)
    with pytest.raises(OutOfBlocks, match="quarantined"):
        kv.allocate(3, 4)
    with pytest.raises(ValueError):
        kv.quarantine_shard(5)


# ======================================================================
# the degraded note
# ======================================================================
def test_pool_exhausted_carries_the_degraded_note(llama):
    _, tcfg, _, _ = llama
    kv = PagedKVCache(tcfg, 16, 4, n_shards=2, device="cpu")
    with pytest.raises(PoolExhausted) as ei:
        kv.allocate(1, 100)
    assert not ei.value.degraded and "DEGRADED" not in str(ei.value)
    assert ei.value.quarantined_shards == ()
    kv.quarantine_shard(1)
    for grow in (lambda: kv.allocate(1, 64),
                 lambda: kv.write_prefill_chunk(
                     2, *[torch.zeros((2, 4, 40, 64))] * 2, 0)):
        with pytest.raises(PoolExhausted) as ei:
            grow()
        e = ei.value
        assert e.degraded and "DEGRADED" in str(e)
        assert e.quarantined_shards == (1,) and e.live_shards == (0,)


def test_engine_pool_exhausted_carries_the_degraded_note(llama):
    """An fcfs engine that outgrows a pool degraded by a shard death with
    no rejoin: the decode-side PoolExhausted names the quarantine."""
    _, tcfg, _, tp = llama
    kw = _econf("block", num_blocks=16, scheduler="fcfs",
                prefix_sharing=False, prefill_chunk_tokens=None,
                decode_headroom=1)
    eng = LLMEngine(tcfg, tp, EngineConfig(**kw), FaultInjector(
        FaultScenario.parse("shard_death:shard=1,step=3")), device="cpu")
    eng.submit([Request(prompt=list(range(1, 21)),
                        params=SamplingParams(max_new_tokens=40))])
    with pytest.raises(PoolExhausted) as ei:
        eng.run()
    assert ei.value.degraded and "DEGRADED" in str(ei.value)
