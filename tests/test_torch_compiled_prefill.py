"""The compiled prefill programs' CPU-testable parts
(``serving/compiled.py`` ``CompiledPrefill``) against the JAX reference.

* ``chunk_bucket`` and ``prefill_bucket`` cover every length, never shrink
  one, and bound the padding.
* The chunk step, the one-shot prefill and the suffix prefill run eagerly
  on PADDED operands (pad tokens after the real ones, the real length a
  device operand, the prefix gathered by ``kvcache.gather_blocks`` as the
  suffix graph does) give the unpadded eager results and the JAX
  ``prefill_chunk`` / ``prefill`` / ``prefill_suffix``: real-row logits
  and K/V within 1e-4 at fp32, equal greedy tokens; llama3-8b and
  gemma2-27b smoke configs.
* The pool after a padded write (``write_prefill(..., length=)``) equals
  the pool after the unpadded write exactly, bf16 and int8 (scales
  included): no pad row lands in a block.
* The prefill graphs' launch accounting and the engine's wiring, with a
  stand-in for the card (``EagerGraphs``: CPU buffers, a "capture" that
  runs the program under ``LaunchDeltas.record()`` and a "replay" that
  reruns it with the counters held, as a graph replay skips the
  wrappers): the chunk kernel counts one launch per layer per chunk,
  warm-ups and replays alike, and the engine's greedy tokens equal the
  eager engine's, first pass and warmed.

Capture and replay themselves need the card: ``tests/test_torch_gpu.py``.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serving import (EngineConfig, LLMEngine, PagedKVCache,
                                 Request, SamplingParams)
from repro_torch.serving import compiled as C
from repro_torch.serving.kvcache import gather_blocks
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4      # fp32 logits and K/V: padded rows change GEMM shapes


def _params(arch):
    cfg = jreg.get_smoke_config(arch)
    tcfg = treg.get_smoke_config(arch)
    p = jtf.init_params(jax.random.PRNGKey(1), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    return cfg, tcfg, p, tp


@pytest.fixture(scope="module")
def models():
    return {arch: _params(arch) for arch in ("llama3-8b", "gemma2-27b")}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=ATOL)


def _len(n):
    return torch.tensor([n], dtype=torch.int32)


def _padded(tokens, n):
    return torch.from_numpy(C.pad_tokens(tokens, n))[None]


# ----------------------------------------------------------------------
# buckets
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cap", [8, 64, 100, 512, 2048])
def test_chunk_bucket_covers_every_chunk_and_pads_only_partial_ones(cap):
    sizes = [C.chunk_bucket(c, cap) for c in range(1, cap + 1)]
    for c, w in enumerate(sizes, start=1):
        assert c <= w <= max(c, cap)
        assert w == cap or (w >= 64 and w & (w - 1) == 0)
        assert w < 2 * c or w <= 64          # waste < C, or the 64 floor
    assert sizes[-1] == cap                  # a full chunk is never padded
    assert sizes == sorted(sizes)


def test_prefill_bucket_powers_then_multiples_of_512():
    for S in range(1, 5000):
        w = C.prefill_bucket(S)
        assert w >= S
        if S <= 512:
            assert w >= 64 and w & (w - 1) == 0 and (w < 2 * S or w == 64)
        else:
            assert w % 512 == 0 and w - S < 512
    assert [C.prefill_bucket(n) for n in (1, 64, 65, 513, 662, 2000)] == \
        [64, 64, 128, 1024, 1024, 2048]


# ----------------------------------------------------------------------
# padded operands = unpadded = the reference
# ----------------------------------------------------------------------
def _pools(tcfg, cfg, kv_dtype, num_blocks=24, bs=4):
    from repro.serving.kvcache import PagedKVCache as JPagedKVCache
    return (PagedKVCache(tcfg, num_blocks, bs, kv_dtype=kv_dtype,
                         device="cpu"),
            PagedKVCache(tcfg, num_blocks, bs, kv_dtype=kv_dtype,
                         device="cpu"),
            JPagedKVCache(cfg, num_blocks, bs, kv_dtype=kv_dtype))


def _scales(kv, names=("k_scale_pool", "v_scale_pool")):
    return {} if kv.k_scale is None else dict(zip(names, (kv.k_scale,
                                                          kv.v_scale)))


def _assert_pools_equal(a, b):
    assert torch.equal(a.k_pool, b.k_pool) and torch.equal(a.v_pool, b.v_pool)
    if a.k_scale is not None:
        assert torch.equal(a.k_scale, b.k_scale)
        assert torch.equal(a.v_scale, b.v_scale)
    assert a.tables == b.tables and a.lengths == b.lengths


def _assert_untouched(kv):
    """Blocks no table holds and the slots past each sequence's length in
    its last block are still zero: no pad row landed."""
    used = {b for t in kv.tables.values() for b in t}
    free = sorted(set(range(kv.num_blocks)) - used)
    assert not kv.k_pool[:, :, free].any() and not kv.v_pool[:, :, free].any()
    for sid, table in kv.tables.items():
        n = kv.lengths[sid]
        tail = n % kv.block_size
        if tail:
            last = table[-1]
            assert not kv.k_pool[:, :, last, tail:].any()
            if kv.k_scale is not None:
                assert not kv.k_scale[:, :, last, tail:].any()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_padded_chunk_steps_match_unpadded_and_reference(models, arch,
                                                         kv_dtype):
    """A 27-token prompt in chunks of 8 (the last one of 3 tokens, padded
    to the bucket 8): every chunk's real rows, and the pools after."""
    cfg, tcfg, p, tp = models[arch]
    plain, padded, jkv = _pools(tcfg, cfg, kv_dtype)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, size=27)
    cap = 8
    for c0 in range(0, len(prompt), cap):
        chunk = prompt[c0:c0 + cap].tolist()
        n = len(chunk)
        nb = c0 // plain.block_size
        idx = plain.gather_prefix_indices(0, c0) if c0 else \
            torch.zeros((0,), dtype=torch.int32)
        lu, cu = ttf.prefill_chunk(tp, tcfg, {"tokens": [chunk]},
                                   plain.k_pool, plain.v_pool, idx,
                                   device="cpu", **_scales(plain))
        width = C.chunk_bucket(n, cap)
        blocks = torch.as_tensor(padded.tables.get(0, [])[:nb],
                                 dtype=torch.int32)
        lp, cp = ttf.prefill_chunk(tp, tcfg, {"tokens": _padded(chunk, width)},
                                   padded.k_pool, padded.v_pool, blocks,
                                   device="cpu", length=_len(n),
                                   **_scales(padded))
        jidx = jnp.asarray(jkv.tables[0][:nb] if c0 else [], jnp.int32)
        lj, cj = jtf.prefill_chunk(p, cfg, {"tokens": jnp.asarray([chunk],
                                                                  jnp.int32)},
                                   jkv.k_pool, jkv.v_pool, jidx,
                                   k_scale_pool=jkv.k_scale,
                                   v_scale_pool=jkv.v_scale)
        assert cp["k"].shape[3] == width and int(cp["len"][0]) == c0 + n
        for got in (lp, lu):
            _close(got, lj)
        assert int(lp.argmax()) == int(lu.argmax()) == int(jnp.argmax(lj))
        for key in ("k", "v"):
            _close(cp[key][:, :, :, :n], cu[key])
            _close(cu[key], cj[key])
        plain.write_prefill_chunk(0, cu["k"][:, 0], cu["v"][:, 0], c0)
        # the padded write goes through the unpadded write's exact bits
        padded.write_prefill_chunk(0, cu["k"][:, 0].clone(),
                                   cu["v"][:, 0].clone(), c0)
        jkv.write_prefill_chunk(0, cj["k"][:, 0], cj["v"][:, 0], c0)
    _assert_pools_equal(padded, plain)
    _assert_untouched(padded)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_padded_write_leaves_the_pool_of_the_unpadded_write(models, arch,
                                                           kv_dtype):
    """K/V padded past the real rows with garbage, written with
    ``length``: the pool equals the unpadded write bit for bit."""
    _, tcfg, _, _ = models[arch]
    L, Hkv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    rng = np.random.default_rng(3)
    plain = PagedKVCache(tcfg, 16, 4, kv_dtype=kv_dtype, device="cpu")
    padded = PagedKVCache(tcfg, 16, 4, kv_dtype=kv_dtype, device="cpu")
    for kv in (plain, padded):
        kv.allocate(0, 13)
        kv.allocate(1, 6)
    for sid, n, width in ((0, 13, 64), (1, 6, 8)):
        k = torch.from_numpy(rng.standard_normal((L, Hkv, width, hd),
                                                 np.float32)).to(tcfg.dtype)
        v = torch.from_numpy(rng.standard_normal((L, Hkv, width, hd),
                                                 np.float32)).to(tcfg.dtype)
        plain.write_prefill(sid, k[:, :, :n].contiguous(),
                            v[:, :, :n].contiguous())
        padded.write_prefill(sid, k * 1, v * 1, length=n)
    _assert_pools_equal(padded, plain)
    _assert_untouched(padded)
    with pytest.raises(ValueError):
        padded.write_prefill(1, k, v, length=width + 1)


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_padded_oneshot_prefill_matches_unpadded_and_reference(models, arch):
    cfg, tcfg, p, tp = models[arch]
    S = 37
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=S)
    width = C.prefill_bucket(S)
    lu, cu = ttf.prefill(tp, tcfg, {"tokens": [toks.tolist()]}, max_seq=S,
                         device="cpu")
    lp, cp = ttf.prefill(tp, tcfg, {"tokens": _padded(toks.tolist(), width)},
                         max_seq=width, device="cpu", length=_len(S))
    lj, cj = jtf.prefill(p, cfg, {"tokens": jnp.asarray(toks[None],
                                                        jnp.int32)},
                         max_seq=S)
    assert width == 64 and cp["k"].shape[3] == width
    assert int(cp["len"][0]) == int(cu["len"][0]) == S
    for got in (lp, lu):
        _close(got, lj)
    assert int(lp.argmax()) == int(lu.argmax()) == int(jnp.argmax(lj))
    for key in ("k", "v"):
        _close(cp[key][:, :, :, :S], cu[key])
        _close(cu[key], cj[key])
    # unpadded operands: nothing changes when the length is given
    lv, cv = ttf.prefill(tp, tcfg, {"tokens": [toks.tolist()]}, max_seq=S,
                         device="cpu", length=_len(S))
    assert torch.equal(lv, lu) and torch.equal(cv["k"], cu["k"])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_padded_suffix_prefill_matches_unpadded_and_reference(models, arch,
                                                             kv_dtype):
    """The prefix of 16 tokens in the pool, a suffix of 21 tokens padded to
    64: the suffix program (gather inside, padded) against the eager
    suffix prefill over ``gather_prefix`` and the reference over the same
    prefix K/V."""
    cfg, tcfg, p, tp = models[arch]
    P, S = 16, 21
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=P + S)
    kv = PagedKVCache(tcfg, 24, 4, kv_dtype=kv_dtype, device="cpu")
    _, pre = ttf.prefill(tp, tcfg, {"tokens": [toks[:P].tolist()]},
                         max_seq=P, device="cpu")
    kv.allocate(0, P)
    kv.write_prefill(0, pre["k"][:, 0], pre["v"][:, 0])
    suffix = toks[P:].tolist()
    k_pre, v_pre = kv.gather_prefix(0, P)
    lu, cu = ttf.prefill_suffix(tp, tcfg, {"tokens": [suffix]},
                                k_pre[:, None], v_pre[:, None], device="cpu")
    blocks = torch.as_tensor(kv.tables[0], dtype=torch.int32)
    kg, vg = gather_blocks(kv.k_pool, kv.v_pool, kv.k_scale, kv.v_scale,
                           blocks, tcfg.dtype)
    assert torch.equal(kg, k_pre) and torch.equal(vg, v_pre)
    width = C.prefill_bucket(S)
    lp, cp = ttf.prefill_suffix(tp, tcfg, {"tokens": _padded(suffix, width)},
                                kg[:, None], vg[:, None], device="cpu",
                                length=_len(S))
    lj, cj = jtf.prefill_suffix(
        p, cfg, {"tokens": jnp.asarray([suffix], jnp.int32)},
        jnp.asarray(k_pre[:, None].numpy()),
        jnp.asarray(v_pre[:, None].numpy()))
    assert int(cp["len"][0]) == int(cu["len"][0]) == P + S
    for got in (lp, lu):
        _close(got, lj)
    assert int(lp.argmax()) == int(lu.argmax()) == int(jnp.argmax(lj))
    for key in ("k", "v"):
        _close(cp[key][:, :, :, :S], cu[key])
        _close(cu[key], cj[key])


# ----------------------------------------------------------------------
# the programs through a stand-in for the card
# ----------------------------------------------------------------------
class EagerGraphs(C.GraphCache):
    """``GraphCache`` with the card taken out: CPU buffers; a capture runs
    the program under ``LaunchDeltas.record()`` (its launches taken back
    out, as a capture launches nothing); a replay reruns it with the
    counters held, as a graph replay skips the wrappers' counting."""

    def __init__(self, device, pool=None):
        self.device = torch.device(device)
        self._graphs = collections.OrderedDict()
        self._programs = {}
        self.captures = self.replays = self.reserved_bytes = 0
        self.capture_s = 0.0

    def _buffers(self, size):
        return (torch.empty(size, dtype=torch.int32),
                torch.empty(size, dtype=torch.int32))

    def _fill(self, entry, operands):
        entry.dev.copy_(torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int32).reshape(-1) for a in operands])))

    def _capture(self, entry, program, tickets):
        with entry.launches.record():
            entry.out = program(*entry.views)
        self._programs[id(entry)] = program

    def _replay(self, entry):
        held = {fn: fn.launches for fn in C.COUNTED}
        entry.out = self._programs[id(entry)](*entry.views)
        for fn, n in held.items():
            fn.launches = n


class StandInPrefill(C.CompiledPrefill):
    graph_cache = EagerGraphs


@pytest.fixture
def counting(monkeypatch):
    """The chunk kernel's wrappers count on the CPU too (one launch per
    call, as on the card)."""
    orig = ppa.paged_prefill_chunk_attention

    def counted(*a, **kw):
        fn = ppa.paged_prefill_chunk_attention_int8 \
            if kw.get("k_scale") is not None else orig
        fn.launches += 1
        return orig(*a, **kw)
    monkeypatch.setattr(tattn, "paged_prefill_chunk_attention", counted)
    return orig, ppa.paged_prefill_chunk_attention_int8


def _serve(eng, prompts, new=6):
    reqs = [Request(prompt=list(x), params=SamplingParams(max_new_tokens=new))
            for x in prompts]
    eng.submit(reqs)
    eng.run()
    return [r.output for r in reqs]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_graph_launch_accounting_through_the_engine(models, counting,
                                                            kv_dtype):
    """Chunked prefill through the stand-in programs: the chunk kernel
    counts L per chunk (warm-ups and replays alike), the greedy tokens
    equal the eager engine's, and a second pass on the warmed engine
    replays every chunk."""
    cfg, tcfg, _, tp = models["llama3-8b"]
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (21, 16, 13)]
    econf = EngineConfig(max_batch=4, block_size=4, num_blocks=64,
                         prefill_chunk_tokens=8, kv_dtype=kv_dtype)
    fn = counting[1] if kv_dtype == "int8" else counting[0]
    eager = LLMEngine(tcfg, tp, econf, device="cpu")
    assert eager.compiled_prefill is None
    n0 = fn.launches
    want = _serve(eager, prompts)
    assert fn.launches - n0 == tcfg.num_layers * \
        eager.stats.prefill_chunks_run
    eng = LLMEngine(tcfg, tp, econf, device="cpu")
    eng.compiled_prefill = comp = StandInPrefill(tcfg, tp, eng.kv, "cpu", 8)
    for rnd in range(2):
        n0, chunks = fn.launches, eng.stats.prefill_chunks_run
        assert _serve(eng, prompts) == want
        chunks = eng.stats.prefill_chunks_run - chunks
        assert fn.launches - n0 == tcfg.num_layers * chunks
    # keys (C bucket, nb): (8, 0), (8, 2), (8, 4); the partial chunks of
    # 5 tokens pad to the cap, 8, and share the full chunks' keys
    assert comp.chunk.graphs == comp.chunk.captures == 3
    assert comp.chunk.captures + comp.chunk.replays == \
        eng.stats.prefill_chunks_run == 2 * 7
    assert comp.oneshot.graphs == comp.suffix.graphs == 0


def test_oneshot_and_suffix_programs_serve_like_the_eager_engine(models):
    """One-shot prefill with prefix sharing (the suffix program gathers
    the donor's blocks), a warmed second pass replaying: greedy tokens and
    the sharing counters equal the eager engine's."""
    cfg, tcfg, _, tp = models["gemma2-27b"]
    rng = np.random.default_rng(7)
    common = rng.integers(0, cfg.vocab_size, size=16).tolist()
    prompts = [common + rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (5, 9, 3)]
    econf = EngineConfig(max_batch=4, block_size=4, num_blocks=64,
                         prefix_sharing=True, kv_dtype="int8")
    eager = LLMEngine(tcfg, tp, econf, device="cpu")
    want = _serve(eager, prompts)
    eng = LLMEngine(tcfg, tp, econf, device="cpu")
    eng.compiled_prefill = comp = StandInPrefill(tcfg, tp, eng.kv, "cpu",
                                                 None)
    for _ in range(2):
        assert _serve(eng, prompts) == want
    assert eng.stats.prefill_tokens_skipped == \
        2 * eager.stats.prefill_tokens_skipped > 0
    assert comp.oneshot.captures == 1 and comp.oneshot.replays >= 1
    assert comp.suffix.captures >= 1 and comp.suffix.replays >= 1
    assert comp.chunk.graphs == 0


def test_graph_cache_keeps_the_most_recent_keys(monkeypatch):
    monkeypatch.setattr(C, "MAX_GRAPHS", 3)
    cache = EagerGraphs("cpu")
    for i in range(5):
        out = cache.run((i,), (np.asarray([i], np.int32),),
                        lambda x: x.clone())
        assert int(out[0]) == i
    assert cache.graphs == 3 and list(cache._graphs) == [(2,), (3,), (4,)]
    assert int(cache.run((4,), (np.asarray([9], np.int32),),
                         lambda x: None)[0]) == 9       # a replay
    assert (cache.captures, cache.replays) == (5, 1)


def test_compiled_prefill_is_never_built_on_the_cpu(models):
    _, tcfg, _, tp = models["llama3-8b"]
    kv = PagedKVCache(tcfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="eagerly"):
        C.CompiledPrefill(tcfg, tp, kv, "cpu", 8)
    eng = LLMEngine(tcfg, tp, EngineConfig(num_blocks=8, block_size=4),
                    device="cpu")
    assert eng.compiled_prefill is None and eng.compiled is None
