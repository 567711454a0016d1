"""The moe family and the ``moe_offload`` placement (paper §7) through the
port's ``LLMEngine``, against the JAX engine on the CPU (qwen3-moe smoke
config: 4 experts, top-2).

* The reference's MoE engine tests, run on the port: ``moe_offload``
  equals homogeneous and the expert pool's bytes per token equal
  ``transfer_bytes_moe`` (``test_llm_engine.py``, ``test_extensions.py``);
  a dense config refuses ``moe_offload``; chunked prefill runs no chunk
  (``test_chunked_prefill.py``); prefix sharing shares memory and
  recomputes (``test_prefix_sharing.py``) — each with the greedy tokens
  equal to the JAX engine's.
* ``moe_offload`` × head / request / block × bf16 / int8 equals
  homogeneous over the same pool dtype.
* At the default capacity factor (1.25), where the prompts' routing groups
  drop tokens (asserted), the port's tokens equal JAX's token for token.
* The compiled one-shot program of a moe model (through the CPU stand-in
  for the graphs) runs at the prompt's exact length: at S = 5 the
  64-token bucket would raise the capacity from 4 to 44. Its logits and
  K/V equal the eager unpadded prefill's and the reference's; padded
  operands are refused.

Greedy argmax over fp32 smoke logits that agree to ~1e-5 is exact unless
two logits tie that closely (none do here).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import LLMEngine as JLLMEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import registry as treg
from repro_torch.models import blocks as tblocks
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                 SamplingParams, transfer_bytes_moe)
from test_torch_compiled_prefill import StandInPrefill
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "qwen3-moe-30b-a3b"
ATOL = 1e-4           # fp32 logits and K/V
OFFLOAD = dict(placement="moe_offload", attention_workers=2,
               expert_workers=2)


@pytest.fixture(scope="module")
def models():
    """{capacity factor: (jcfg, tcfg, jax params, port params)} on the
    same weights: 64 drops nothing, 1.25 (the default) drops."""
    out = {}
    jp = None
    for cf in (64.0, 1.25):
        cfg = jreg.get_smoke_config(ARCH, capacity_factor=cf)
        tcfg = treg.get_smoke_config(ARCH, capacity_factor=cf)
        if jp is None:
            jp = jtf.init_params(jax.random.PRNGKey(0), cfg)
            tp = ttf.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                     "cpu")
        out[cf] = (cfg, tcfg, jp, tp)
    return out


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in lens]


def _family(cfg, n_common, tails, seed):
    rng = np.random.default_rng(seed)
    common = rng.integers(0, cfg.vocab_size, size=n_common).tolist()
    return [common + rng.integers(0, cfg.vocab_size, size=t).tolist()
            for t in tails]


def _jax(cfg, p, prompts, new=6, **kw):
    reqs = [JRequest(prompt=list(x), params=JSamplingParams(
        max_new_tokens=new)) for x in prompts]
    eng = JLLMEngine(cfg, p, JEngineConfig(**kw))
    eng.submit(reqs)
    eng.run(max_steps=500)
    return [r.output for r in reqs], eng


def _port(tcfg, tp, prompts, new=6, **kw):
    reqs = [Request(prompt=list(x), params=SamplingParams(
        max_new_tokens=new)) for x in prompts]
    eng = LLMEngine(tcfg, tp, EngineConfig(**kw), device="cpu")
    eng.submit(reqs)
    eng.run(max_steps=500)
    return [r.output for r in reqs], eng


def test_moe_offload_matches_homogeneous_and_reference(models):
    """``test_llm_engine.py:96`` and ``test_extensions.py:97`` on the
    port: equal tokens, both pools account, the expert boundary's bytes
    per token = ``transfer_bytes_moe(cfg, 1)``."""
    cfg, tcfg, p, tp = models[64.0]
    prompts = _prompts(cfg, (5, 9))
    kw = dict(max_batch=2, num_blocks=64)
    want, jeng = _jax(cfg, p, prompts, placement="moe_offload",
                      attention_workers=2, expert_workers=2, **kw)
    ref, _ = _port(tcfg, tp, prompts, placement="homogeneous", **kw)
    got, eng = _port(tcfg, tp, prompts, **OFFLOAD, **kw)
    assert got == ref == want
    assert eng.pool.log.transfers > 0 and eng.expert_pool.log.transfers > 0
    per_tok = eng.expert_pool.log.total / eng.stats.tokens_generated
    assert per_tok == pytest.approx(transfer_bytes_moe(tcfg, 1))
    assert vars(eng.expert_pool.log) == vars(jeng.expert_pool.log)
    assert vars(eng.pool.log) == vars(jeng.pool.log)


def test_moe_offload_rejects_dense_config():
    """``test_llm_engine.py:157``."""
    cfg = treg.get_smoke_config("llama3-8b")
    params = ttf.init_params(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        LLMEngine(cfg, params, EngineConfig(placement="moe_offload"),
                  device="cpu")


def test_chunked_moe_falls_back_to_oneshot(models):
    """``test_chunked_prefill.py:316``: the chunk knob is accepted, no
    chunk runs, the tokens equal the one-shot engine's and JAX's."""
    cfg, tcfg, p, tp = models[64.0]
    prompts = _prompts(cfg, (20, 23))
    kw = dict(OFFLOAD, max_batch=2, num_blocks=64, block_size=8)
    want, _ = _jax(cfg, p, prompts, new=5, prefill_chunk_tokens=8, **kw)
    off, _ = _port(tcfg, tp, prompts, new=5, **kw)
    on, eng = _port(tcfg, tp, prompts, new=5, prefill_chunk_tokens=8, **kw)
    assert on == off == want
    assert eng.stats.prefill_chunks_run == 0
    assert eng._chunk_tokens is None
    assert not any(e.kind == "chunk" for e in eng.event_log)


def test_moe_offload_shares_memory_but_recomputes(models):
    """``test_prefix_sharing.py:129``: blocks mapped onto the donor's,
    suffix-only write, full-prompt recompute."""
    cfg, tcfg, p, tp = models[64.0]
    prompts = _family(cfg, 20, (3, 4), seed=9)
    kw = dict(OFFLOAD, max_batch=2, num_blocks=64, block_size=8)
    res = {}
    for share in (False, True):
        res[share] = _port(tcfg, tp, prompts, new=5, prefix_sharing=share,
                           **kw)
    want, _ = _jax(cfg, p, prompts, new=5, prefix_sharing=True, **kw)
    assert res[True][0] == res[False][0] == want
    assert res[True][1].stats.blocks_shared == 2
    assert res[True][1].stats.prefill_tokens_skipped == 0


@pytest.fixture(scope="module")
def homogeneous(models):
    """The homogeneous engine's tokens per pool dtype (cf 64)."""
    cfg, tcfg, p, tp = models[64.0]
    prompts = _prompts(cfg, (21, 12, 9), seed=2)
    return prompts, {dt: _port(tcfg, tp, prompts, max_batch=3, block_size=8,
                               num_blocks=64, kv_dtype=dt)[0]
                     for dt in ("bf16", "int8")}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("partition", ["head", "request", "block"])
def test_moe_offload_partitions_match_homogeneous(models, homogeneous,
                                                  partition, kv_dtype):
    _, tcfg, _, tp = models[64.0]
    prompts, want = homogeneous
    got, eng = _port(tcfg, tp, prompts, partition=partition,
                     kv_dtype=kv_dtype, max_batch=3, block_size=8,
                     num_blocks=64, **OFFLOAD)
    assert got == want[kv_dtype]
    assert sum(eng.pool.per_worker_kv_bytes) > 0
    if partition == "block":
        assert eng.kv.n_shards == 2
    assert eng.expert_pool.log.total == \
        transfer_bytes_moe(tcfg, 1) * eng.stats.tokens_generated


def test_default_capacity_drops_and_matches_reference(models, monkeypatch):
    """capacity_factor 1.25: the prompts' routing groups drop choices
    (counted at every MoE call), and the port's tokens still equal JAX's,
    homogeneous and offloaded."""
    cfg, tcfg, p, tp = models[1.25]
    drops = []
    orig = tblocks.moe_forward

    def counted(params, cfg_, x, group_size=256):
        B, S, d = x.shape
        gs = min(group_size, B * S)
        C = tmoe._capacity(gs, cfg_.experts_per_token, cfg_.num_experts,
                           cfg_.capacity_factor)
        _, _, onehot, keep, _ = tmoe.route(params["router"], cfg_,
                                           x.reshape(-1, gs, d), C)
        drops.append(int(onehot.sum() - keep.sum()))
        return orig(params, cfg_, x, group_size)

    monkeypatch.setattr(tblocks, "moe_forward", counted)
    prompts = _prompts(cfg, (48, 33, 17), seed=4)
    kw = dict(max_batch=3, num_blocks=64, block_size=8)
    want, _ = _jax(cfg, p, prompts, new=8, **kw)
    got, _ = _port(tcfg, tp, prompts, new=8, **kw)
    assert got == want
    assert sum(drops) > 0
    off, _ = _port(tcfg, tp, prompts, new=8, **OFFLOAD, **kw)
    assert off == want


def test_compiled_oneshot_runs_moe_at_the_exact_length(models):
    """The one-shot program of a moe model runs eagerly at the exact
    prompt length and reads no pad row: at S = 5, C = 4, where the
    64-token bucket would route one group of 64 with C = 44. It captures
    no graph, so a new length costs no capture."""
    cfg, tcfg, p, tp = models[1.25]
    S = 5
    assert tmoe._capacity(S, 2, 4, 1.25) == 4
    assert tmoe._capacity(64, 2, 4, 1.25) == 44
    toks = _prompts(cfg, (S,), seed=7)[0]
    eng = LLMEngine(tcfg, tp, EngineConfig(num_blocks=16, block_size=8),
                    device="cpu")
    comp = StandInPrefill(tcfg, tp, eng.kv, "cpu", None)
    for _ in range(2):                  # a first call, then a repeat
        logits, k, v = comp.run_oneshot(toks)
    assert comp.oneshot.captures == comp.oneshot.replays == 0
    assert list(comp.oneshot._graphs) == []
    assert k.shape[2] == S
    lu, cu = ttf.prefill(tp, tcfg, {"tokens": [toks]}, max_seq=S,
                         device="cpu")
    assert torch.equal(logits, lu)
    assert torch.equal(k, cu["k"][:, 0]) and torch.equal(v, cu["v"][:, 0])
    lj, cj = jtf.prefill(p, cfg, {"tokens": np.asarray([toks], np.int32)},
                         max_seq=S)
    np.testing.assert_allclose(logits.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(cj["k"][:, 0]),
                               atol=ATOL, rtol=ATOL)
    with pytest.raises(ValueError, match="padded"):
        ttf.prefill(tp, tcfg, {"tokens": [toks + [0] * 59]}, max_seq=64,
                    device="cpu", length=torch.tensor([S]))
