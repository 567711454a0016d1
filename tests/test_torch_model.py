"""The port's configs, helpers and dense model against the JAX reference.

Inputs come from numpy seeds; weights cross over with ``params_from_jax``
(exact). Tolerances are fp32: both sides run the same math in a different
summation order, so logits agree to ~1e-5 absolute on O(1) values; 1e-4
leaves an order of magnitude of margin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.serving.kvcache import PagedKVCache as JPagedKVCache
from repro_torch.configs import registry as treg
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.serving.kvcache import PagedKVCache as TPagedKVCache
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4      # fp32 logits, reordered sums (see module docstring)
ARCHS = [("llama3-8b", {}), ("llama3-8b", {"num_kv_heads": 2}),
         ("gemma2-27b", {})]
ARCH_IDS = ["llama3-8b", "llama3-8b-gqa", "gemma2-27b"]

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _same_config(jcfg, tcfg):
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "dtype":
            assert _DTYPES[a] == b
        else:
            assert a == b, f.name


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference_field_for_field(arch, smoke):
    if smoke:
        _same_config(jreg.get_smoke_config(arch),
                     treg.get_smoke_config(arch))
    else:
        _same_config(jreg.get_config(arch), treg.get_config(arch))


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("helper", ["rms_norm", "softcap", "apply_rope",
                                    "swiglu"])
def test_helpers_match_reference(helper):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    if helper == "rms_norm":
        w = rng.standard_normal(16).astype(np.float32)
        got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
        want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    elif helper == "softcap":
        got = tcommon.softcap(torch.from_numpy(x * 40), 30.0)
        want = jcommon.softcap(jnp.asarray(x * 40), 30.0)
    elif helper == "apply_rope":
        pos = rng.integers(0, 5000, size=(2, 5)).astype(np.int32)
        got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 500000.0)
        want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    else:
        xs = x.reshape(10, 48)
        ws = [rng.standard_normal(s).astype(np.float32) * 0.1
              for s in ((48, 64), (48, 64), (64, 48))]
        got = tcommon.swiglu(torch.from_numpy(xs),
                             *[torch.from_numpy(w) for w in ws])
        want = jcommon.swiglu(jnp.asarray(xs), *[jnp.asarray(w) for w in ws])
    # fp32 elementwise / small matmuls: ~1e-6 relative
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_dense_init_fan_in_and_truncation_match_reference():
    """Same rule as the reference (fan-in = shape[0], truncated at ±3σ);
    the draws differ (torch vs threefry), so compare the statistics."""
    shape = (8, 64, 256)                 # wo-like: fan-in is H = 8
    gen = torch.Generator().manual_seed(0)
    w = tcommon.dense_init(gen, shape, torch.float32, "cpu").numpy()
    ref = _np(jcommon.dense_init(jax.random.PRNGKey(0), shape, jnp.float32))
    sigma = 1.0 / np.sqrt(8)
    assert np.abs(w).max() <= 3 * sigma + 1e-6
    # 131k samples: the std of a ±3σ truncated normal is 0.9866σ; the
    # sampling error is ~0.2%, so 2% separates a wrong fan-in by miles
    np.testing.assert_allclose(w.std(), ref.std(), rtol=0.02)
    np.testing.assert_allclose(w.std(), 0.9866 * sigma, rtol=0.02)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_jax_is_exact(dtype):
    cfg = jreg.get_smoke_config("gemma2-27b", dtype=dtype)
    tcfg = treg.get_smoke_config("gemma2-27b", dtype=_DTYPES[dtype])
    p = jtf.init_params(jax.random.PRNGKey(3), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    assert len(flat) == sum(1 for _ in _leaves(tp))
    for path, leaf in flat:
        t = tp
        for k in path:
            t = t[k.key]
        assert t.dtype == _DTYPES[dtype] and t.shape == leaf.shape
        np.testing.assert_array_equal(
            t.view(torch.int16 if dtype == jnp.bfloat16 else torch.int32)
            .numpy(),
            np.asarray(leaf).view(np.int16 if dtype == jnp.bfloat16
                                  else np.int32))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.fixture(scope="module", params=list(zip(ARCHS, ARCH_IDS)),
                ids=ARCH_IDS)
def model(request):
    (arch, kw), _ = request.param
    cfg = jreg.get_smoke_config(arch, **kw)
    tcfg = treg.get_smoke_config(arch, **kw)
    p = jtf.init_params(jax.random.PRNGKey(0), cfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    return cfg, tcfg, p, tp


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(1, n)).astype(np.int32)


@pytest.fixture(scope="module")
def runs(model):
    """One serving-shaped scenario per model, run on both packages into
    pools with identical block tables: sequence 0 (37 tokens) prefilled in
    chunks of 16 (an empty prefix, a block-aligned prefix, then a partial
    chunk that is not a multiple of the block size), sequence 1 (9 tokens)
    prefilled one-shot, then one paged decode step over both."""
    cfg, tcfg, p, tp = model
    bs = 8
    jkv = JPagedKVCache(cfg, 16, bs)
    tkv = TPagedKVCache(tcfg, 16, bs, device="cpu")
    toks = _prompt(cfg, 37, 1)
    out = {"chunks": []}
    for c0 in range(0, 37, 16):
        c1 = min(c0 + 16, 37)
        jidx = jkv.gather_prefix_indices(0, c0) if c0 else \
            jnp.zeros((0,), jnp.int32)
        lj, cj = jtf.prefill_chunk(p, cfg, {"tokens": jnp.asarray(
            toks[:, c0:c1])}, jkv.k_pool, jkv.v_pool, jidx)
        jkv.write_prefill_chunk(0, cj["k"][:, 0], cj["v"][:, 0], c0)
        tidx = tkv.gather_prefix_indices(0, c0) if c0 else \
            torch.zeros((0,), dtype=torch.int32)
        lt, ct = ttf.prefill_chunk(tp, tcfg, {"tokens": toks[:, c0:c1]},
                                   tkv.k_pool, tkv.v_pool, tidx,
                                   device="cpu")
        tkv.write_prefill_chunk(0, ct["k"][:, 0], ct["v"][:, 0], c0)
        out["chunks"].append((_np(lj), lt.numpy()))
    out["oneshot_port_0"] = ttf.prefill(tp, tcfg, {"tokens": toks},
                                        max_seq=37, device="cpu")
    toks1 = _prompt(cfg, 9, 2)
    lj, cj = jtf.prefill(p, cfg, {"tokens": jnp.asarray(toks1)}, max_seq=9)
    lt, ct = ttf.prefill(tp, tcfg, {"tokens": toks1}, max_seq=9,
                         device="cpu")
    out["oneshot"] = (_np(lj), lt.numpy(), cj, ct)
    jkv.allocate(1, 9)
    tkv.allocate(1, 9)
    jkv.write_prefill(1, cj["k"][:, 0], cj["v"][:, 0])
    tkv.write_prefill(1, ct["k"][:, 0], ct["v"][:, 0])
    tables, lens = tkv.block_table_batch([0, 1])
    jt, jl = jkv.block_table_batch([0, 1])
    new = np.array([3, 7], np.int32)
    lj, uj = jtf.decode_step_paged(p, cfg, jnp.asarray(new), jkv.k_pool,
                                   jkv.v_pool, jnp.asarray(jt),
                                   jnp.asarray(jl))
    lt, ut = ttf.decode_step_paged(tp, tcfg, new, tkv.k_pool, tkv.v_pool,
                                   tables, lens, device="cpu")
    out["decode"] = (_np(lj), lt.numpy(), uj, ut)
    out["tables"] = ((jt, jl), (tables, lens), jkv.tables, tkv.tables)
    out["pools"] = (_np(jkv.k_pool), tkv.k_pool.numpy())
    return out


def test_prefill_matches_reference(runs):
    lj, lt, cj, ct = runs["oneshot"]
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), _np(cj[key]), atol=ATOL,
                                   rtol=ATOL)


def test_prefill_chunk_matches_reference_chunked(runs):
    """Port chunked vs JAX chunked (its jnp gather path), chunk by chunk,
    and the pools both sides wrote."""
    assert len(runs["chunks"]) == 3
    for lj, lt in runs["chunks"]:
        np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=ATOL)
    jpool, tpool = runs["pools"]
    np.testing.assert_allclose(tpool, jpool, atol=ATOL, rtol=ATOL)


def test_decode_step_paged_matches_reference(runs):
    """One paged decode step over two ragged sequences (the reference's jnp
    gather backend vs the port's plain kernel twin)."""
    (jt, jl), (tt, tl), jtables, ttables = runs["tables"]
    assert jtables == ttables
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    lj, lt, uj, ut = runs["decode"]
    np.testing.assert_allclose(lt, lj, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(ut["k_new"].numpy(), _np(uj["k_new"]),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(ut["len"].numpy(), _np(uj["len"]))


def test_chunked_prefill_matches_oneshot_within_port(runs):
    """Within the port, the chunk path (plain kernel twin over the pool)
    reproduces the one-shot prefill's last logits and K/V."""
    lt, ct = runs["oneshot_port_0"]
    np.testing.assert_allclose(runs["chunks"][-1][1], lt.numpy(), atol=ATOL,
                               rtol=ATOL)
    _, tpool = runs["pools"]
    k = ct["k"][:, 0].numpy()                     # (L, Hkv, S, hd)
    for j, blk in enumerate(runs["tables"][3][0]):
        n = min(8, 37 - 8 * j)
        np.testing.assert_allclose(tpool[:, :, blk, :n], k[:, :, 8 * j:8 * j + n],
                                   atol=ATOL, rtol=ATOL)
