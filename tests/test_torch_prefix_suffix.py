"""The port's one-shot prefix-sharing prefill against the JAX reference on
the CPU, after ``tests/test_prefix_sharing.py``.

* ``transformer.prefill_suffix`` equals the reference's on the same
  weights, suffix tokens and prefix K/V, for llama3-8b and gemma2-27b smoke
  configs (gemma2: a prompt longer than its 64-token window, sinks,
  softcaps, post-norms), at the fp32 tolerance of ``test_torch_model.py``
  (1e-4: the same math in another summation order). It is not held
  against one-shot prefill: that bit-parity fails in the reference itself.
* ``PagedKVCache.gather_prefix`` equals the reference's, bit for bit, on
  bf16 and int8 pools after the same op sequence.
* The engine contracts of ``tests/test_prefix_sharing.py`` with one-shot
  prefill (``prefill_chunk_tokens`` unset): greedy streams equal with
  sharing on and off for every placement x partition x pool dtype, and
  equal the JAX engine's with the same sharing counters; fewer resident
  blocks; admission charges only the suffix; preemption among sharers
  equals the uncontended run; the donor retires while a sharer lives.
"""
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
from repro_torch.serving import (EngineConfig, LLMEngine, PagedKVCache,
                                 Request, RequestScheduler, SamplingParams,
                                 State)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4      # fp32 logits and K/V, reordered sums


@pytest.fixture(scope="module")
def llama():
    cfg = jreg.get_smoke_config("llama3-8b")
    tcfg = treg.get_smoke_config("llama3-8b")
    p = jtf.init_params(jax.random.PRNGKey(0), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    return cfg, tcfg, p, tp


def _common(cfg, n=40, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=n).tolist()


def _prompts(cfg, common, tails=(5, 6, 7, 8), seed=42):
    """Prompts sharing `common` as a prefix, distinct suffixes."""
    r = np.random.default_rng(seed)
    return [list(common) + r.integers(0, cfg.vocab_size, size=t).tolist()
            for t in tails]


def _family(prompts, new=8):
    return [Request(prompt=list(x), params=SamplingParams(max_new_tokens=new))
            for x in prompts]


def _serve(tcfg, tp, reqs, **kw):
    eng = LLMEngine(tcfg, tp, EngineConfig(**kw), device="cpu")
    eng.submit(reqs)
    eng.run(max_steps=2000)
    return eng


# ----------------------------------------------------------------------
# model layer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch,S,P", [("llama3-8b", 37, 16),
                                      ("gemma2-27b", 90, 48)])
def test_prefill_suffix_matches_reference(arch, S, P):
    cfg = jreg.get_smoke_config(arch)
    tcfg = treg.get_smoke_config(arch)
    p = jtf.init_params(jax.random.PRNGKey(1), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(1, S))
    # the prefix K/V: the reference's own prefill of the first P tokens
    _, pre = jtf.prefill(p, cfg, {"tokens": jnp.asarray(toks[:, :P],
                                                        jnp.int32)},
                         max_seq=P)
    kp, vp = np.array(pre["k"]), np.array(pre["v"])
    suffix = toks[:, P:]
    lj, cj = jtf.prefill_suffix(p, cfg, {"tokens": jnp.asarray(suffix,
                                                               jnp.int32)},
                                jnp.asarray(kp), jnp.asarray(vp))
    lt, ct = ttf.prefill_suffix(tp, tcfg, {"tokens": suffix.tolist()},
                                torch.from_numpy(kp), torch.from_numpy(vp),
                                device="cpu")
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                               rtol=ATOL)
    for key in ("k", "v"):
        assert ct[key].shape == tuple(cj[key].shape)
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   atol=ATOL, rtol=ATOL)
    assert int(ct["len"][0]) == int(cj["len"][0]) == S


def test_prefill_suffix_rejects_non_kv_families():
    cfg = treg.get_smoke_config("rwkv6-7b")
    with pytest.raises(ValueError, match="family"):
        ttf.prefill_suffix(None, cfg, {}, None, None, device="cpu")


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_gather_prefix_matches_reference(llama, kv_dtype):
    """One op sequence on both caches (prefill, share + CoW, token
    writes), then the dense prefix of the sharer and of the donor."""
    cfg, tcfg, _, _ = llama
    jkv = JPagedKVCache(cfg, 12, 4, kv_dtype=kv_dtype)
    tkv = PagedKVCache(tcfg, 12, 4, kv_dtype=kv_dtype, device="cpu")
    rng = np.random.default_rng(7)
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim

    def both(fn):
        fn(jkv, jnp.asarray)
        fn(tkv, torch.from_numpy)

    a = rng.standard_normal((L, Hkv, 10, hd)).astype(np.float32) * 2
    both(lambda c, conv: c.allocate(0, 10))
    both(lambda c, conv: c.write_prefill(0, conv(a), conv(a * 0.5)))
    both(lambda c, conv: c.share_blocks(0, 1, 8))
    b = rng.standard_normal((L, Hkv, 3, hd)).astype(np.float32)
    both(lambda c, conv: c.allocate(1, 11))
    both(lambda c, conv: c.write_prefill(1, conv(b), conv(-b), 8))
    both(lambda c, conv: c.append_token(0))
    t = rng.standard_normal((L, 1, Hkv, hd)).astype(np.float32)
    both(lambda c, conv: c.write_tokens([0], conv(t), conv(t), [10]))
    assert tkv.tables == jkv.tables
    for seq, n in ((1, 8), (0, 8), (1, 4)):
        for got, want in zip(tkv.gather_prefix(seq, n),
                             jkv.gather_prefix(seq, n)):
            assert got.dtype == tcfg.dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="block-aligned"):
        tkv.gather_prefix(0, 6)


# ----------------------------------------------------------------------
# engine contracts, one-shot prefill
# ----------------------------------------------------------------------
PLACEMENTS = {"homogeneous": dict(),
              "head": dict(placement="attention_pool", partition="head",
                           attention_workers=2),
              "request": dict(placement="attention_pool",
                              partition="request", attention_workers=4),
              "block": dict(placement="attention_pool", partition="block",
                            attention_workers=4)}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("name", list(PLACEMENTS))
def test_one_shot_sharing_parity_and_reference_counters(llama, name,
                                                        kv_dtype):
    cfg, tcfg, p, tp = llama
    prompts = _prompts(cfg, _common(cfg), tails=(5, 6, 7), seed=42)
    kw = dict(max_batch=4, num_blocks=64, block_size=16, kv_dtype=kv_dtype,
              **PLACEMENTS[name])
    out, stats = {}, {}
    for share in (False, True):
        reqs = _family(prompts, new=5)
        eng = _serve(tcfg, tp, reqs, prefix_sharing=share, **kw)
        assert all(r.state == State.FINISHED for r in reqs)
        assert eng.kv.used_blocks == 0 and eng.kv.refcounts == {}
        out[share], stats[share] = [r.output for r in reqs], eng.stats
    assert out[True] == out[False]
    assert stats[True].prefill_chunks_run == 0
    assert stats[True].blocks_shared == 4       # 2 sharers x 2 full blocks
    assert stats[True].prefill_tokens_skipped == 64
    assert stats[False].blocks_shared == 0
    jreqs = [JRequest(prompt=list(x), params=JSamplingParams(
        max_new_tokens=5)) for x in prompts]
    jeng = JLLMEngine(cfg, p, JEngineConfig(prefix_sharing=True, **kw))
    jeng.submit(jreqs)
    jeng.run()
    assert out[True] == [r.output for r in jreqs]
    assert stats[True].blocks_shared == jeng.stats.blocks_shared
    assert stats[True].prefill_tokens_skipped == \
        jeng.stats.prefill_tokens_skipped
    assert stats[True].max_prefill_slab_tokens == \
        jeng.stats.max_prefill_slab_tokens


def test_one_shot_sharing_gemma2_window_softcap_parity():
    """A shared prefix longer than gemma2's 64-token window, through the
    suffix prefill's local/global layers, sinks, softcaps and
    post-norms."""
    cfg = treg.get_smoke_config("gemma2-27b")
    tp = ttf.init_params(0, cfg, device="cpu")
    prompts = _prompts(cfg, _common(cfg, n=70, seed=2), tails=(4, 9),
                       seed=5)
    out = {}
    for share in (False, True):
        reqs = _family(prompts, new=6)
        eng = _serve(cfg, tp, reqs, placement="attention_pool",
                     max_batch=2, num_blocks=64, block_size=16,
                     prefix_sharing=share)
        out[share] = [r.output for r in reqs]
        if share:
            assert eng.stats.prefill_tokens_skipped == 64
    assert out[True] == out[False]


def test_one_shot_sharing_reduces_resident_pool_blocks(llama):
    _, tcfg, _, tp = llama
    prompts = _prompts(tcfg, _common(tcfg))
    used = {}
    for share in (False, True):
        eng = LLMEngine(tcfg, tp, EngineConfig(
            max_batch=4, num_blocks=64, block_size=16,
            prefix_sharing=share), device="cpu")
        eng.submit(_family(prompts, new=4))
        eng.step()
        used[share] = eng.kv.used_blocks
        eng.run()
    assert used[False] - used[True] == 6       # 3 sharers x 2 blocks saved


def test_admission_charges_only_unshared_suffix(llama):
    _, tcfg, _, _ = llama
    prompts = _prompts(tcfg, _common(tcfg, n=32), tails=(8, 8, 8, 8))
    admitted = {}
    for share in (False, True):
        kv = PagedKVCache(tcfg, num_blocks=8, block_size=16, device="cpu")
        sched = RequestScheduler(kv, max_batch=8, decode_headroom=0,
                                 prefix_sharing=share)
        sched.submit(_family(prompts, new=4))
        admitted[share] = len(sched.admit())
        if share:   # every sharer: 2 shared blocks + 1 private suffix block
            assert kv.used_blocks == 3 + (admitted[True] - 1)
    assert admitted == {False: 2, True: 4}


def test_preempt_with_sharing_matches_uncontended(llama):
    _, tcfg, _, tp = llama
    prompts = _prompts(tcfg, _common(tcfg, n=16, seed=7), tails=(2, 2, 2),
                       seed=11)
    ref = _family(prompts, new=16)
    e_ref = _serve(tcfg, tp, ref, max_batch=4, num_blocks=64, block_size=8,
                   prefix_sharing=True)
    assert e_ref.stats.preemptions == 0 and \
        e_ref.stats.prefill_tokens_skipped > 0
    tight = _family(prompts, new=16)
    eng = _serve(tcfg, tp, tight, max_batch=4, num_blocks=10, block_size=8,
                 scheduler="preempt", decode_headroom=2, prefix_sharing=True)
    assert eng.stats.preemptions > 0
    assert [r.output for r in tight] == [r.output for r in ref]
    assert eng.kv.used_blocks == 0 and eng.kv.refcounts == {}


def test_donor_retires_while_sharer_lives(llama):
    _, tcfg, _, tp = llama
    prompts = _prompts(tcfg, _common(tcfg, n=32, seed=8), tails=(5, 6),
                       seed=17)
    solo = _family(prompts[1:], new=10)[0]
    _serve(tcfg, tp, [solo], max_batch=2, num_blocks=64, block_size=16)
    donor, sharer = _family(prompts, new=10)
    donor.params.max_new_tokens = 2             # the donor retires early
    eng = _serve(tcfg, tp, [donor, sharer], max_batch=2, num_blocks=64,
                 block_size=16, prefix_sharing=True)
    assert eng.stats.prefill_tokens_skipped == 32
    assert donor.state == State.FINISHED and sharer.state == State.FINISHED
    assert sharer.output == solo.output
    assert eng.kv.used_blocks == 0 and eng.kv.refcounts == {}
