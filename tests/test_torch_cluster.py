"""The port's disaggregated cluster (``serving/cluster/``) against the JAX
package's, after ``tests/test_disagg_cluster.py``.

* The parity matrix: ``attention_pool`` × ``head | request | block``
  over bf16 pools (int8 pools: ``tests/test_torch_cluster_int8.py``),
  prefix sharing on, chunks of 8 tokens, 2 blocks landed a step, two
  replicas behind the affinity router: greedy outputs equal the JAX
  cluster's and the port's single engine's; ``summary()`` equals the JAX
  cluster's except for the latency keys; every engine's sequence of event
  kinds and every route equal the JAX cluster's.
* The router alone: assignments equal the JAX router's for affinity,
  seeded random and least_loaded; ``fnv1a_tokens`` / ``prefix_route_key``.

The cluster's own contracts (``tests/test_disagg_cluster.py`` and the
cluster cases of ``tests/test_kv_handoff.py``) are held on the port in
``tests/test_torch_cluster_cases.py``, the serve CLI in
``tests/test_torch_serve.py``.
"""
import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import DisaggConfig as JDisaggConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.cluster import DisaggCluster as JDisaggCluster
from repro.serving.cluster import fnv1a_tokens as jfnv1a
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.serving import (DisaggConfig, EngineConfig, LLMEngine,
                                 Request, SamplingParams)
from repro_torch.serving.cluster import (DisaggCluster, fnv1a_tokens,
                                         prefix_route_key)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

LATENCY_KEYS = ("handoff_p50_s", "handoff_p90_s", "handoff_p99_s")


@pytest.fixture(scope="module")
def llama():
    cfg = jreg.get_smoke_config("llama3-8b")
    tcfg = treg.get_smoke_config("llama3-8b")
    p = jtf.init_params(jax.random.PRNGKey(0), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    return cfg, tcfg, p, tp


def grouped_prompts(vocab, groups=3, per=3, prefix=8, suffix=6, seed=0):
    """``groups`` prefix families × ``per`` members: the shared leading
    blocks exercise prefix sharing locally and affinity routing
    globally."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(groups):
        common = rng.integers(0, vocab, size=prefix).tolist()
        for _ in range(per):
            out.append(common + rng.integers(0, vocab, size=suffix).tolist())
    return out


def econf_kw(partition="head", **kw):
    base = dict(placement="attention_pool", partition=partition,
                attention_workers=2, num_blocks=64, block_size=4,
                max_batch=4, prefix_sharing=True, prefill_chunk_tokens=8)
    if partition != "block":
        base["kv_shards"] = 2
    base.update(kw)
    return base


def _requests(cls, sp, prompts, new):
    return [cls(prompt=list(p), params=sp(max_new_tokens=new))
            for p in prompts]


def _run_port(llama, kw, prompts, new, replicas=2, **ckw):
    _, tcfg, _, tp = llama
    cluster = DisaggCluster(tcfg, tp, EngineConfig(**kw), replicas=replicas,
                            device="cpu", **ckw)
    reqs = cluster.submit(_requests(Request, SamplingParams, prompts, new))
    cluster.run()
    return cluster, reqs


def _run_jax(llama, kw, prompts, new, replicas=2, **ckw):
    cfg, _, p, _ = llama
    cluster = JDisaggCluster(cfg, p, JEngineConfig(**kw), replicas=replicas,
                             **ckw)
    reqs = cluster.submit(_requests(JRequest, JSamplingParams, prompts, new))
    cluster.run()
    return cluster, reqs


def _summary(cluster):
    s = dict(cluster.summary())
    for k in LATENCY_KEYS:
        assert k in s, k
        del s[k]
    return s


# ======================================================================
# the parity matrix
# ======================================================================
def held_to_jax_cluster(llama, partition, kv_dtype):
    """The port's cluster against the JAX cluster and its own single
    engine on grouped prompts (see the module docstring)."""
    _, tcfg, _, tp = llama
    kw = econf_kw(partition, kv_dtype=kv_dtype)
    prompts = grouped_prompts(tcfg.vocab_size)
    new = 6
    ckw = dict(disagg=DisaggConfig(transfer_blocks_per_step=2))
    tcl, treqs = _run_port(llama, kw, prompts, new, **ckw)
    jcl, jreqs = _run_jax(llama, kw, prompts, new,
                          disagg=JDisaggConfig(transfer_blocks_per_step=2))
    single = LLMEngine(tcfg, tp, EngineConfig(**kw), device="cpu")
    sreqs = _requests(Request, SamplingParams, prompts, new)
    single.submit(sreqs)
    single.run()

    assert tcl.finished
    out = [r.output for r in treqs]
    assert out == [r.output for r in jreqs] == [r.output for r in sreqs]
    assert all(len(o) == new for o in out)
    assert [tcl.replica_of(r.rid) for r in treqs] == \
        [jcl.replica_of(r.rid) for r in jreqs]
    s = _summary(tcl)
    assert s == _summary(jcl)
    assert s["handoffs_completed"] == len(prompts)
    assert s["router_affinity_hits"] == 6
    assert s["prefill_tokens_skipped"] > 0
    for tr, jr in zip(tcl.registry, jcl.registry):
        for role in ("prefill", "decode"):
            te, je = getattr(tr, role), getattr(jr, role)
            assert [e.kind for e in te.event_log] == \
                [e.kind for e in je.event_log], (tr.idx, role)
            assert te.stats.kv_bytes_transferred == \
                je.stats.kv_bytes_transferred
        assert len(tr.prefill.retained_rids) == \
            len(jr.prefill.retained_rids)
        # each role stays in its lane: no decode on the prefill side, no
        # prefill on the decode side
        assert tr.prefill.stats.steps == 0
        assert tr.decode.stats.prefill_chunks_run == 0
        assert tr.decode.stats.max_prefill_slab_tokens == 0


@pytest.mark.parametrize("partition", ["head", "request", "block"])
def test_cluster_matches_jax_cluster_and_single_engine(llama, partition):
    held_to_jax_cluster(llama, partition, "bf16")


# ======================================================================
# routing
# ======================================================================
@pytest.mark.parametrize("routing", ["affinity", "random", "least_loaded"])
def test_router_assignments_match_jax(llama, routing):
    """Routing happens at submit: the port's routes equal the JAX
    router's for the same prompts, policy and seed (a short prompt with
    no full block included)."""
    cfg, tcfg, p, tp = llama
    prompts = grouped_prompts(tcfg.vocab_size, groups=4, per=3) + \
        [[1, 2, 3]] + grouped_prompts(tcfg.vocab_size, groups=2, per=2,
                                      seed=5)
    kw = econf_kw()
    tcl = DisaggCluster(tcfg, tp, EngineConfig(**kw), replicas=3,
                        routing=routing, seed=11, device="cpu")
    jcl = JDisaggCluster(cfg, p, JEngineConfig(**kw), replicas=3,
                         routing=routing, seed=11)
    treqs = tcl.submit(_requests(Request, SamplingParams, prompts, 2))
    jreqs = jcl.submit(_requests(JRequest, JSamplingParams, prompts, 2))
    routes = [tcl.replica_of(r.rid) for r in treqs]
    assert routes == [jcl.replica_of(r.rid) for r in jreqs]
    assert len(set(routes)) > 1
    assert tcl.router.assignments == jcl.router.assignments
    assert [r.prefill.stats.router_affinity_hits for r in tcl.registry] == \
        [r.prefill.stats.router_affinity_hits for r in jcl.registry]
    assert [r.load for r in tcl.registry] == [r.load for r in jcl.registry]


def test_fnv1a_and_route_key_match_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 64):
        toks = rng.integers(-2**31, 2**31, size=n).tolist()
        assert fnv1a_tokens(toks) == jfnv1a(toks)
    toks = (17, 4096, -1, 0)
    assert fnv1a_tokens(toks) == fnv1a_tokens(list(toks))
    assert fnv1a_tokens(toks) != fnv1a_tokens(toks[:-1])
    assert fnv1a_tokens(()) == 0xcbf29ce484222325   # FNV-1a offset basis
    assert prefix_route_key(list(range(10)), 4, 2) == tuple(range(8))
    assert prefix_route_key(list(range(10)), 4, 1) == tuple(range(4))
    assert prefix_route_key(list(range(5)), 4, 2) == tuple(range(4))
    assert prefix_route_key([1, 2, 3], 4, 2) is None
