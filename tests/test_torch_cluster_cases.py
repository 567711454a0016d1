"""The disaggregated cluster's contracts on the port, the cases of
``tests/test_disagg_cluster.py`` and the cluster cases of
``tests/test_kv_handoff.py``: bit parity through the handoff with one
replica, the decode engine never prefills, the lifecycle event order,
retained prefixes, sticky affinity with unhealthy-replica diversion,
seeded random routing, construction checks, the polled outbox, the
summary's shape, a shard death mid-transfer (recovered, and past the
retry budget a contextual ``HandoffError``) and an oversized payload
refused at enqueue."""
import numpy as np
import pytest

from repro_torch.configs import registry
from repro_torch.models import transformer
from repro_torch.serving import (DisaggConfig, EngineConfig, FaultInjector,
                                 FaultScenario, LLMEngine, Request,
                                 SamplingParams, State)
from repro_torch.serving.cluster import (DecodeEngine, DisaggCluster,
                                         HandoffError, PrefillEngine,
                                         prefix_route_key)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_smoke_config("llama3-8b")
    return cfg, transformer.init_params(0, cfg, device="cpu")


def _grouped_reqs(cfg, groups=3, per=3, prefix=8, suffix=6, new=6, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(groups):
        common = rng.integers(0, cfg.vocab_size, size=prefix).tolist()
        for _ in range(per):
            reqs.append(Request(
                prompt=common +
                rng.integers(0, cfg.vocab_size, size=suffix).tolist(),
                params=SamplingParams(max_new_tokens=new)))
    return reqs


def _econf(partition="head", **kw):
    base = dict(placement="attention_pool", partition=partition,
                attention_workers=2, num_blocks=64, block_size=4,
                max_batch=4, prefix_sharing=True, prefill_chunk_tokens=8)
    if partition != "block":
        base["kv_shards"] = 2
    base.update(kw)
    return EngineConfig(**base)


def _cluster(cfg, params, econf, **kw):
    return DisaggCluster(cfg, params, econf, device="cpu", **kw)


@pytest.mark.parametrize("partition", ["head", "block"])
def test_handoff_bit_parity_one_replica(setup, partition):
    cfg, params = setup
    econf = _econf(partition)
    ref = _grouped_reqs(cfg)
    eng = LLMEngine(cfg, params, econf, device="cpu")
    eng.submit(ref)
    eng.run()
    reqs = _grouped_reqs(cfg)
    cluster = _cluster(cfg, params, econf, replicas=1,
                       disagg=DisaggConfig(transfer_blocks_per_step=2))
    cluster.submit(reqs)
    cluster.run()
    assert cluster.finished
    assert [r.output for r in reqs] == [r.output for r in ref]
    s = cluster.summary()
    assert s["handoffs_completed"] == len(reqs)
    assert s["kv_bytes_transferred"] > 0


def test_decode_engine_never_prefills(setup):
    cfg, params = setup
    cluster = _cluster(cfg, params, _econf(), replicas=1,
                       disagg=DisaggConfig(transfer_blocks_per_step=2))
    reqs = cluster.submit(_grouped_reqs(cfg))
    cluster.run()
    dec = cluster.registry[0].decode
    assert dec.stats.max_prefill_slab_tokens == 0
    kinds = {e.kind for e in dec.event_log}
    assert "admit" not in kinds and "chunk" not in kinds
    admits = [e for e in dec.event_log if e.kind == "handoff_admit"]
    assert {e.rid for e in admits} == {r.rid for r in reqs}
    assert dec.stats.tokens_generated > 0
    # and the prefill engine never decodes
    assert cluster.registry[0].prefill.stats.steps == 0


def test_handoff_lifecycle_event_order(setup):
    cfg, params = setup
    cluster = _cluster(cfg, params, _econf(), replicas=1,
                       disagg=DisaggConfig(transfer_blocks_per_step=1))
    reqs = cluster.submit(_grouped_reqs(cfg, groups=2, per=2))
    cluster.run()
    dec = cluster.registry[0].decode
    for r in reqs:
        stages = [e.kind for e in dec.event_log if e.rid == r.rid
                  and e.kind in ("handoff_recv", "prealloc",
                                 "transfer_done", "handoff_admit")]
        assert stages == ["handoff_recv", "prealloc", "transfer_done",
                          "handoff_admit"], (r.rid, stages)
    done = [e for e in dec.event_log if e.kind == "transfer_done"]
    assert any(e.info["steps"] >= e.info["blocks"] - 1 for e in done)


def test_retained_prefixes_skip_follower_prefill(setup):
    cfg, params = setup
    cluster = _cluster(cfg, params, _econf(), replicas=1)
    cluster.submit(_grouped_reqs(cfg, groups=2, per=4))
    cluster.run()
    pre = cluster.registry[0].prefill
    assert pre.stats.prefill_tokens_skipped > 0
    assert pre.stats.blocks_shared > 0
    assert pre.retained_rids
    cold = _cluster(cfg, params, _econf(), replicas=1,
                    disagg=DisaggConfig(retain_prefixes=False))
    cold.submit(_grouped_reqs(cfg, groups=2, per=4))
    cold.run()
    assert cold.registry[0].prefill.retained_rids == []
    assert cold.registry[0].prefill.kv.tables == {}


def test_affinity_routing_concentrates_prefix_groups(setup):
    cfg, params = setup
    groups, per = 3, 4
    cluster = _cluster(cfg, params, _econf(), replicas=2,
                       routing="affinity")
    reqs = cluster.submit(_grouped_reqs(cfg, groups=groups, per=per))
    cluster.run()
    for g in range(groups):
        fam = reqs[g * per:(g + 1) * per]
        homes = {cluster.replica_of(r.rid) for r in fam}
        assert len(homes) == 1, f"group {g} split across {homes}"
    s = cluster.summary()
    assert s["router_affinity_hits"] == groups * (per - 1)
    assert s["prefill_tokens_skipped"] > 0
    assert len(cluster.router.assignments) == groups


def test_router_prefers_least_loaded_for_short_prompts(setup):
    cfg, params = setup
    cluster = _cluster(cfg, params, _econf(), replicas=2)
    short = Request(prompt=[1, 2, 3],
                    params=SamplingParams(max_new_tokens=2))
    assert prefix_route_key(short.prompt, 4, 2) is None
    cluster.submit(short)
    assert cluster.router.assignments == {}
    cluster.run()
    assert short.state == State.FINISHED


def test_unhealthy_replica_diverts_without_losing_affinity(setup):
    cfg, params = setup
    cluster = _cluster(cfg, params, _econf(), replicas=2)
    prompt = list(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=12))
    r1 = cluster.submit(Request(prompt=prompt,
                                params=SamplingParams(max_new_tokens=2)))[0]
    home = cluster.replica_of(r1.rid)
    key = prefix_route_key(prompt, 4, 2)
    assert cluster.router.assignments[key] == home
    cluster.registry[home].decode.kv.quarantine_shard(0)
    assert not cluster.registry[home].healthy
    r2 = cluster.submit(Request(prompt=list(prompt),
                                params=SamplingParams(max_new_tokens=2)))[0]
    assert cluster.replica_of(r2.rid) != home
    assert cluster.router.assignments[key] == home
    hits = cluster.registry[home].prefill.stats.router_affinity_hits
    cluster.registry[home].decode.kv.rejoin_shard(0)
    r3 = cluster.submit(Request(prompt=list(prompt),
                                params=SamplingParams(max_new_tokens=2)))[0]
    assert cluster.replica_of(r3.rid) == home
    assert cluster.registry[home].prefill.stats.router_affinity_hits == \
        hits + 1


def test_random_routing_is_seeded(setup):
    cfg, params = setup

    def routes(seed):
        c = _cluster(cfg, params, _econf(), replicas=2, routing="random",
                     seed=seed)
        rs = c.submit(_grouped_reqs(cfg, groups=2, per=3, new=1))
        return [c.replica_of(r.rid) for r in rs]
    assert routes(3) == routes(3)
    assert set(routes(3) + routes(4)) == {0, 1}


def test_cluster_and_disagg_config_validate(setup):
    cfg, params = setup
    with pytest.raises(ValueError, match="replicas"):
        _cluster(cfg, params, _econf(), replicas=0)
    with pytest.raises(ValueError, match="routing policy"):
        _cluster(cfg, params, _econf(), routing="round_robin")
    with pytest.raises(ValueError, match="affinity_blocks"):
        _cluster(cfg, params, _econf(), affinity_blocks=0)
    for bad in (dict(role="router"), dict(transfer_blocks_per_step=-1),
                dict(max_retained_seqs=-1), dict(max_transfer_attempts=0)):
        with pytest.raises(ValueError):
            DisaggConfig(**bad)
    assert DisaggConfig().replace(role="decode").role == "decode"
    # an engine handed the other role's config plays its own
    eng = PrefillEngine(cfg, params, _econf(),
                        disagg=DisaggConfig(role="decode"), device="cpu")
    assert eng.disagg.role == "prefill"


def test_standalone_engines_with_polled_outbox(setup):
    cfg, params = setup
    econf = _econf()
    prefill = PrefillEngine(cfg, params, econf, device="cpu")
    decode = DecodeEngine(cfg, params, econf, device="cpu")
    reqs = _grouped_reqs(cfg, groups=1, per=2)
    prefill.submit(reqs)
    while prefill.has_work():
        prefill.step()
        for h in prefill.collect_handoffs():
            decode.enqueue_handoff(h.request, h.payload)
    while decode.has_work():
        decode.step()
    assert all(r.state == State.FINISHED for r in reqs)
    assert all(len(r.output) == 6 for r in reqs)
    assert decode.stats.handoffs_completed == 2
    assert decode.stats.kv_bytes_transferred == \
        prefill.stats.kv_bytes_transferred


def test_cluster_summary_shape(setup):
    cfg, params = setup
    cluster = _cluster(cfg, params, _econf(), replicas=2)
    cluster.submit(_grouped_reqs(cfg, groups=2, per=2, new=3))
    cluster.run()
    s = cluster.summary()
    for key in ("replicas", "routing", "requests", "kv_bytes_transferred",
                "handoffs_completed", "handoff_retries",
                "router_affinity_hits", "prefill_tokens_skipped",
                "blocks_shared", "tokens_generated", "per_replica",
                "handoff_p50_s", "handoff_p90_s", "handoff_p99_s"):
        assert key in s, key
    assert s["replicas"] == 2 and s["routing"] == "affinity"
    assert s["handoffs_completed"] == 4
    assert s["tokens_generated"] == 4 * (3 - 1)
    assert len(s["per_replica"]) == 2
    assert sum(p["handoffs_completed"] for p in s["per_replica"]) == 4


# ======================================================================
# transfer interrupted by shard death (after tests/test_kv_handoff.py)
# ======================================================================
def _reqs(cfg, lens=(18, 25), new=8, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=n).tolist(),
                    params=SamplingParams(max_new_tokens=new))
            for n in lens]


def _fault_econf(**kw):
    base = dict(placement="attention_pool", partition="head",
                attention_workers=2, kv_shards=2, num_blocks=64,
                block_size=4, max_batch=4)
    base.update(kw)
    return EngineConfig(**base)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_transfer_interrupted_by_shard_death_recovers(setup, kv_dtype):
    cfg, params = setup
    econf = _fault_econf(kv_dtype=kv_dtype)
    ref = _reqs(cfg)
    eng = LLMEngine(cfg, params, econf, device="cpu")
    eng.submit(ref)
    eng.run()
    reqs = _reqs(cfg)
    injector = FaultInjector(
        FaultScenario.parse("shard_death:shard=1,step=3"))
    cluster = _cluster(cfg, params, econf, replicas=1,
                       disagg=DisaggConfig(transfer_blocks_per_step=1),
                       decode_faults={0: injector})
    cluster.submit(reqs)
    cluster.run()
    assert [r.output for r in reqs] == [r.output for r in ref]
    dec = cluster.registry[0].decode
    assert dec.stats.handoff_retries >= 1
    retries = [e for e in dec.event_log if e.kind == "handoff_retry"]
    assert retries and all(e.info["blocks_lost"] > 0 for e in retries)
    assert dec.kv.quarantined_shards == (1,)
    assert dec.stats.handoffs_completed == len(reqs)
    assert not cluster.registry[0].healthy


def test_transfer_retry_budget_exhaustion_raises_contextual(setup):
    cfg, params = setup
    reqs = _reqs(cfg)
    injector = FaultInjector(
        FaultScenario.parse("shard_death:shard=1,step=3"))
    cluster = _cluster(cfg, params, _fault_econf(), replicas=1,
                       disagg=DisaggConfig(transfer_blocks_per_step=1,
                                           max_transfer_attempts=1),
                       decode_faults={0: injector})
    cluster.submit(reqs)
    with pytest.raises(HandoffError) as ei:
        cluster.run()
    err = ei.value
    assert err.stage == "transfer"
    assert err.replica == 0
    assert err.rid in {r.rid for r in reqs}
    assert err.blocks_in_flight > 0
    assert "shard death" in str(err)


def test_oversized_handoff_fails_fast_at_enqueue(setup):
    cfg, params = setup
    prefill = PrefillEngine(cfg, params, _fault_econf(), device="cpu")
    decode = DecodeEngine(cfg, params, EngineConfig(
        num_blocks=4, block_size=4, max_batch=4), device="cpu")
    prefill.on_handoff = decode.enqueue_handoff
    req = _reqs(cfg, lens=(30,))[0]          # 8 blocks > a 4-block pool
    prefill.submit(req)
    with pytest.raises(HandoffError) as ei:
        prefill.run()
    assert ei.value.stage == "enqueue"
    assert ei.value.rid == req.rid
    assert ei.value.blocks_in_flight == 8
    assert "can never fit" in str(ei.value)


def test_block_size_mismatch_refused_at_enqueue(setup):
    cfg, params = setup
    prefill = PrefillEngine(cfg, params, _fault_econf(), device="cpu")
    decode = DecodeEngine(cfg, params, EngineConfig(
        num_blocks=64, block_size=8, max_batch=4), device="cpu")
    prefill.on_handoff = decode.enqueue_handoff
    prefill.submit(_reqs(cfg, lens=(10,))[0])
    with pytest.raises(HandoffError, match="block_size") as ei:
        prefill.run()
    assert ei.value.stage == "enqueue"
