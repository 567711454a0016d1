"""The ``long_500k`` decode entry (``configs/base.py``: one new token
against a long cache at B = 1) on the port against the JAX package, on the
CPU, at smoke width.

For every arch whose ``LONG_500K`` note says it runs, the config
``config_for_shape(arch, "long_500k")`` resolves to (llama3-8b ->
``llama3-8b-sw8k``, glm4-9b -> ``glm4-9b-sinks``), reduced to smoke width
with its window cut to 64 where it has one, and llama3-8b-sw8k with an
int8 dense cache (``kv_cache_bits=8``). Both packages start from one
numpy-seeded cache of 1024 positions at len = 1000 (far past the window)
and run 4 steps of ``decode_step`` + ``apply_decode_updates``, in the
stacked layout and (from the same cache as per-layer lists) the listed
one. Logits, new K/V, refreshed states and the cache after each write
agree (tolerance below); an int8 cache's values within one step where
fp32 K/V that agree to ~1e-6 round on either side of a half. The listed
step equals the stacked one bit for bit.

Tolerance: the port and the reference agree within 1e-4 relative to
each tensor's scale (the other port tests' fp32 tolerance), not 1e-5. At
position 1000 the reference's own rotated keys sit up to 1.5e-4 from a
float64 run of the same formula (its values at rows without RoPE, v,
within 5e-7), its logits up to 5.8e-5; the port's sit within 2.2e-6.
So the port is also held within 1e-5 of a float64 run of itself for the
attention families (rwkv6 and zamba2 keep fp32 states in float64 runs).

Then the split plans of the paged decode kernels (rows 1 and 3) and the
dense decode kernel (row 5) at the 524,288-token shapes chip_smoke's
phase 24 launches, on an H100's 132 SMs: pure arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.models import transformer as ttf
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-4          # the port against the reference
TOL_F64 = 1e-5      # the port against a float64 run of itself
MAX_SEQ = 1024
LEN = 1000
WINDOW = 64
N_STEPS = 4
RUNS = [a for a, note in treg.LONG_500K.items() if note.startswith("runs")]
CASES = [(a, {}) for a in RUNS] + [("llama3-8b", {"kv_cache_bits": 8})]


def _ids(case):
    arch, kw = case
    return arch + ("-int8" if kw else "")


def _configs(arch, kw):
    jc = jreg.config_for_shape(arch, "long_500k")
    tc = treg.config_for_shape(arch, "long_500k")
    assert jc.sliding_window == tc.sliding_window
    if jc.sliding_window:
        kw = dict(kw, sliding_window=WINDOW)
    return jbase.reduced(jc, **kw), tbase.reduced(tc, **kw)


def _seeded_cache(jcfg, seed):
    """Numpy values for every leaf of the reference's cache: normal floats,
    int8 values in [-127, 127] with positive scales, len = LEN."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in jtf.init_cache(jcfg, 1, MAX_SEQ).items():
        shape, dtype = leaf.shape, np.dtype(leaf.dtype)
        if key == "len":
            out[key] = np.full(shape, LEN, dtype)
        elif key.endswith("_scale"):
            out[key] = rng.uniform(0.005, 0.03, shape).astype(dtype)
        elif dtype == np.int8:
            out[key] = rng.integers(-127, 128, shape).astype(dtype)
        else:
            out[key] = rng.standard_normal(shape).astype(dtype)
    return out


def _listed_params(params, cfg):
    """The reference pytree's listed layout (zamba2: a list over
    superblocks of lists of mamba layers)."""
    out = dict(params)
    idx = lambda tree, i: jax.tree.map(lambda a: a[i], tree)  # noqa: E731
    if cfg.family == "hybrid":
        n_super, period = jax.tree.leaves(params["layers"])[0].shape[:2]
        out["layers"] = [[idx(idx(params["layers"], s), m)
                          for m in range(period)] for s in range(n_super)]
        if "tail" in params:
            n_tail = jax.tree.leaves(params["tail"])[0].shape[0]
            out["tail"] = [idx(params["tail"], i) for i in range(n_tail)]
    else:
        out["layers"] = [idx(params["layers"], i)
                         for i in range(cfg.num_layers)]
    return out


def _as_listed(stacked):
    """A stacked cache as per-layer lists (zamba2's mamba states: lists
    over superblocks of lists over the period)."""
    return {k: v if k == "len" else
            [list(s) for s in v] if k in ("h", "conv") else list(v)
            for k, v in stacked.items()}


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f64(v) for v in tree]
    return tree.double() if tree.is_floating_point() else tree


def _cache_close(tc, jc):
    for key, want in jc.items():
        got = tc[key].numpy()
        want = np.asarray(want)
        if got.dtype == np.int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 2e-3, key
        elif key == "len":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, f"cache {key}")


@pytest.fixture(scope="module", params=CASES, ids=_ids)
def run(request):
    """4 steps of each package from one seeded cache: per step the stacked
    and listed steps of both, then each package's stacked cache after
    its own ``apply_decode_updates``."""
    arch, kw = request.param
    jcfg, tcfg = _configs(arch, kw)
    jp = jtf.init_params(jax.random.PRNGKey(11), jcfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jlp = _listed_params(jp, jcfg)
    tlp = ttf.params_from_jax(jax.tree.map(np.asarray, jlp), tcfg, "cpu")
    seeded = _seeded_cache(jcfg, 12)
    jc = {k: jnp.asarray(v) for k, v in seeded.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in seeded.items()}
    tok = np.random.default_rng(13).integers(
        0, jcfg.vocab_size, size=(1,)).astype(np.int32)
    steps = []
    for _ in range(N_STEPS):
        tl_cache = _as_listed(tc)
        jl_cache = jax.tree.map(lambda a: jnp.asarray(a.numpy()), tl_cache)
        jl, ju = jtf.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        tl, tu = ttf.decode_step(tp, tcfg, tok, tc, device="cpu")
        ll, lu = ttf.decode_step(tlp, tcfg, tok, tl_cache, device="cpu")
        jll, jlu = jtf.decode_step(jlp, jcfg, jnp.asarray(tok), jl_cache)
        jc = jtf.apply_decode_updates(jc, ju)
        tc = ttf.apply_decode_updates(tc, tu)
        steps.append(dict(jax=(jl, ju), port=(tl, tu), listed=(ll, lu),
                          jax_listed=(jll, jlu),
                          caches=(tc, {k: np.asarray(v)
                                       for k, v in jc.items()})))
        tc = {k: v.clone() for k, v in tc.items()}
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    return dict(cfg=tcfg, steps=steps)


def test_config_is_the_long_500k_variant(run):
    cfg = run["cfg"]
    if cfg.family == "dense" and not cfg.local_global:
        assert cfg.sliding_window == WINDOW         # sw8k / sinks variants
    if cfg.num_kv_heads == 2:                        # glm4-9b-sinks
        assert cfg.attention_sinks == 4


def test_stacked_steps_match_reference(run):
    for i, st in enumerate(run["steps"]):
        (tl, tu), (jl, ju) = st["port"], st["jax"]
        _close(tl, jl, f"step {i} logits")
        assert set(tu) == set(ju)
        for key in ju:
            if key == "len":
                np.testing.assert_array_equal(tu[key].numpy(),
                                              np.asarray(ju[key]))
                continue
            _close(tu[key].numpy(), ju[key], f"step {i} update {key}")


DENSE_CASES = [c for c in CASES if treg.config_for_shape(
    c[0], "long_500k").family == "dense"]


@pytest.mark.parametrize("case", DENSE_CASES, ids=_ids)
def test_dense_step_within_1e5_of_float64(case):
    """The port's fp32 step from the seeded cache against the same step in
    float64 (rwkv6 and zamba2 keep fp32 states in a float64 run)."""
    jcfg, tcfg = _configs(*case)
    tp = ttf.init_params(11, tcfg, device="cpu")
    tc = {k: torch.from_numpy(v.copy())
          for k, v in _seeded_cache(jcfg, 12).items()}
    tok = np.array([3], np.int32)
    tl, tu = ttf.decode_step(tp, tcfg, tok, tc, device="cpu")
    dl, du = ttf.decode_step(_f64(tp), tcfg.replace(dtype=torch.float64),
                             tok, _f64(tc), device="cpu")
    _close(tl, dl, "logits vs float64", TOL_F64)
    for key in ("k_new", "v_new"):
        _close(tu[key], du[key], f"{key} vs float64", TOL_F64)


def test_cache_after_each_write_matches_reference(run):
    for i, st in enumerate(run["steps"]):
        tc, jc = st["caches"]
        assert int(tc["len"][0]) == LEN + i + 1
        _cache_close(tc, jc)


def test_listed_steps_equal_stacked_and_reference(run):
    for i, st in enumerate(run["steps"]):
        (sl, su), (ll, lu) = st["port"], st["listed"]
        jll, jlu = st["jax_listed"]
        assert torch.equal(sl, ll)
        _close(ll, jll, f"step {i} listed logits")
        assert set(lu) == set(su) == set(jlu)
        for key in su:
            if key == "len":
                assert torch.equal(lu[key], su[key])
                continue
            restacked = torch.stack([torch.stack(x) if isinstance(x, list)
                                     else x for x in lu[key]])
            assert torch.equal(restacked, su[key]), key
            t, j = _flat(lu[key]), _flat(jlu[key])
            assert len(t) == len(j), key
            for a, b in zip(t, j):
                _close(a.numpy(), b, f"step {i} listed update {key}")


# ---------------------------------------------------------------------------
# the split plans at phase 24's 524,288-token shapes (H100: 132 SMs)
# ---------------------------------------------------------------------------
SM = 132
BS = 16
NB = 524_288 // BS
# (name, B, Hkv, nb, G, want splits): row 1 / 3 over one layer's pool;
# the head partition's worker (half the kv heads); glm4-9b-sinks at G = 16
PAGED = [("llama3-8b", 1, 8, NB, 4, 66),
         ("llama3-8b head x2 worker", 1, 4, NB, 4, 132),
         ("glm4-9b-sinks", 1, 2, NB, 16, 256),
         ("llama3-8b chunk-prefilled 524,256 + 8", 1, 8, NB - 1, 4, 66)]
# (name, B, Hkv, S, G, want splits): row 5
DENSE = [("zamba2-1.2b", 1, 32, 524_288, 1, 9),
         ("glm4-9b-sinks", 1, 2, 524_288, 16, 132),
         ("llama3-8b-sw8k int8", 1, 8, 524_288, 4, 33)]


@pytest.mark.parametrize("name,B,Hkv,nb,G,want", PAGED,
                         ids=[c[0] for c in PAGED])
def test_paged_plan_at_524k(name, B, Hkv, nb, G, want):
    splits = pda.plan_splits(B, Hkv, nb, SM, G)
    assert splits == want
    assert splits <= pda.max_splits(G)
    ranges = pda.split_ranges(nb, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == nb
    assert all(lo < hi for lo, hi in ranges)                  # none empty
    assert all(b[0] == a[1] for a, b in zip(ranges, ranges[1:]))
    assert max(hi - lo for lo, hi in ranges) <= pda.MAX_SLOTS_PER_SPLIT
    geo = pda.launch_geometry(B, Hkv, nb, SM, G)
    assert geo["grid"] == [splits, Hkv, B]
    assert geo["slots_per_split"] == max(hi - lo for lo, hi in ranges)


def test_paged_plan_numbers_of_phase_24():
    """66 splits of at most 497 slots for llama3-8b's 8 kv heads; G = 16
    reaches the 256-split cap with 128 slots each."""
    assert pda.launch_geometry(1, 8, NB, SM, 4)["slots_per_split"] == 497
    assert pda.launch_geometry(1, 2, NB, SM, 16)["slots_per_split"] == 128
    assert pda.max_splits(16) == 256


@pytest.mark.parametrize("name,B,Hkv,S,G,want", DENSE,
                         ids=[c[0] for c in DENSE])
def test_dense_plan_at_524k(name, B, Hkv, S, G, want):
    splits = da.plan_splits(B, Hkv, S, SM, G)
    assert splits == want
    assert splits <= da.max_splits(G)
    ranges = da.split_ranges(S, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(lo < hi for lo, hi in ranges)                  # none empty
    assert all(b[0] == a[1] for a, b in zip(ranges, ranges[1:]))
    assert all(lo % da.SPLIT_UNIT == 0 for lo, _ in ranges)
    geo = da.launch_geometry(B, Hkv, S, SM, G)
    assert geo["ctas"] == B * Hkv * splits
    assert geo["rows_per_split"] == max(hi - lo for lo, hi in ranges)


# (nb or S, cache_len, window, sinks): the windows of phase 24 and small
# edges (a window inside the sinks, cache_len 0, a ragged last block)
WINDOWS = [(NB, 524_288, 8191, 0), (NB, 524_288, 8191, 4),
           (NB, 524_285, 8191, 4), (NB, 524_288, 0, 0), (64, 1000, 64, 4),
           (64, 1000, 64, 0), (64, 70, 64, 16), (64, 0, 64, 4),
           (64, 17, 0, 0), (64, 1024, 1000, 40), (8, 127, 33, 17)]


def _kept(pos, clen, window, sinks):
    """Whether the masks keep position ``pos`` (the kernels' rule)."""
    return pos < clen and (window <= 0 or pos >= clen - window or
                           pos < sinks)


@pytest.mark.parametrize("nb,clen,window,sinks", WINDOWS)
def test_paged_live_slots_are_the_slots_the_masks_keep(nb, clen, window,
                                                       sinks):
    """The slots the splits share are exactly those holding a kept row,
    each once, in table order; 66 splits share a window of 8192 at 524K
    with 7-8 slots each (the whole table gave 2 splits all of it)."""
    got = pda.live_slots(nb, BS, clen, window, sinks)
    if nb == NB and window:
        want = sorted({p // BS for p in range(clen - window, clen)} |
                      {p // BS for p in range(min(sinks, clen))})
    else:
        want = [i for i in range(nb) if any(
            _kept(i * BS + r, clen, window, sinks) for r in range(BS))]
    assert got == want
    splits = pda.plan_splits(1, 8, nb, SM, 4)
    sizes = [hi - lo for lo, hi in pda.split_ranges(len(got), splits)]
    assert sum(sizes) == len(got)
    assert max(sizes) <= min(-(-len(got) // splits), pda.MAX_SLOTS_PER_SPLIT)
    if (nb, clen, window, sinks) == (NB, 524_288, 8191, 0):
        assert splits == 66 and set(sizes) == {7, 8}


@pytest.mark.parametrize("S,clen,window,sinks", [
    (524_288, 524_280, 8191, 4), (524_288, 524_280, 8191, 0),
    (524_288, 524_280, 0, 0), (256, 200, 64, 4), (256, 200, 64, 0),
    (256, 70, 64, 16), (256, 0, 64, 4), (256, 300, 0, 0),
    (256, 256, 250, 40), (100, 99, 33, 17)])
def test_dense_live_rows_are_the_rows_the_masks_keep(S, clen, window, sinks):
    """The rows the splits share are exactly the kept ones, each once, in
    position order; every split of glm4-9b-sinks' 132 takes 48-64 of its
    8195 kept rows at 524K (cutting the cache's rows gave 3 splits them
    all)."""
    got = da.live_rows(S, clen, window, sinks)
    if S > 4096:
        want = list(range(min(sinks, clen))) * bool(window) + list(
            range(clen - window if window else 0, clen))
    else:
        want = [p for p in range(S) if _kept(p, clen, window, sinks)]
    assert got == want
    splits = da.plan_splits(1, 2, S, SM, 16)
    ranges = da.split_ranges(len(got), splits)
    sizes = [hi - lo for lo, hi in ranges]
    assert len(ranges) == splits and sum(sizes) == len(got)
    assert all(b[0] == a[1] for a, b in zip(ranges, ranges[1:]))
    assert all(lo % da.SPLIT_UNIT == 0 for lo, hi in ranges if hi > lo)
    if (S, clen, window, sinks) == (524_288, 524_280, 8191, 4):
        assert splits == 132 and min(sizes) >= 48 and max(sizes) <= 64


def test_dense_plan_zamba2_waves():
    """zamba2's shared attention: 9 splits of ~58K rows, 288 CTAs at 2 an
    SM on 132 SMs, 1.09 waves."""
    geo = da.launch_geometry(1, 32, 524_288, SM, 1)
    assert geo["ctas"] == 288
    assert 58_000 <= geo["rows_per_split"] <= 58_300
    assert round(geo["ctas"] / (da.CTAS_PER_SM * SM), 2) == 1.09


# ---------------------------------------------------------------------------
# the chunk twin, attended a slice of rows at a time (phase 24 holds row 4
# against it at a 523,776-token prefix)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_chunk_twin_row_slices_equal_one_pass(monkeypatch, int8):
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.models.kv_quant import quantize_kv
    gen = torch.Generator().manual_seed(21)
    Hkv, G, hd, bs, nb, C = 2, 4, 64, 4, 40, 24
    k_pool = torch.randn((Hkv, nb + 3, bs, hd), generator=gen)
    v_pool = torch.randn((Hkv, nb + 3, bs, hd), generator=gen)
    table = torch.randperm(nb + 3, generator=gen)[:nb].int()
    q = torch.randn((C, Hkv * G, hd), generator=gen)
    kc = torch.randn((C, Hkv, hd), generator=gen)
    vc = torch.randn((C, Hkv, hd), generator=gen)
    kw = dict(sliding_window=50, attention_sinks=4, logit_softcap=30.0)
    pools = (k_pool, v_pool)
    if int8:
        (kq, ks), (vq, vs) = quantize_kv(k_pool), quantize_kv(v_pool)
        pools = (kq, vq)
        kw.update(k_scale=ks, v_scale=vs)
    whole = ppa.paged_prefill_chunk_attention_plain(q, *pools, table, kc, vc,
                                                    **kw)
    width = Hkv * G * (nb * bs + C)
    for rows in (1, 5, C - 1):
        monkeypatch.setattr(ppa, "PLAIN_SCORE_ELEMS", rows * width)
        sliced = ppa.paged_prefill_chunk_attention_plain(
            q, *pools, table, kc, vc, **kw)
        torch.testing.assert_close(sliced, whole, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the decode entry at B = 1 on a (1, 1) mesh (phase 24 (d) traces it there)
# ---------------------------------------------------------------------------
def test_size_one_mesh_axes_place_as_replicate():
    """A mesh dim of size 1 holds the whole tensor: Replicate, whatever
    the spec says (DTensor refuses to reshape a size-1 dim sharded over
    it)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.disagg import P, placements
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((1, 1), ("data", "model"))
    assert placements(P("data", None, "model"), mesh) == (Replicate(),) * 2
    mesh = AbstractMesh((1, 4), ("data", "model"))
    assert placements(P("data", "model"), mesh) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="not in mesh order"):
        placements(P(("model", "data")), mesh)


@pytest.mark.parametrize("arch", RUNS)
def test_long_500k_serve_step_traces_on_a_1x1_mesh(monkeypatch, arch):
    """``build_lowering_spec(arch, "long_500k")`` at smoke width on a (1, 1)
    mesh of a fake process group: B = 1 puts the batch on "data" (size 1
    divides it), which failed in DTensor's view rules before size-1 axes
    placed as Replicate. The trace's argument bytes are its parameters',
    token's and cache's; nothing launches."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.entrypoints import build_lowering_spec
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.tree import tree_leaves
    full = treg.config_for_shape

    def smoke(a, shape):
        cfg = full(a, shape)
        kw = {"sliding_window": WINDOW} if cfg.sliding_window else {}
        return tbase.reduced(cfg, **kw)

    monkeypatch.setattr(treg, "config_for_shape", smoke)
    with dryrun.fake_world(1):
        mesh = make_test_mesh((1, 1), device_type="cpu")
        spec = build_lowering_spec(arch, "long_500k", mesh)
        tr = dryrun.trace(spec.fn, spec.args, mesh, spec.in_shardings,
                          spec.out_shardings)
    assert spec.name == f"{arch}:long_500k:serve_step"
    assert spec.args[2]["len"].shape == (1,)
    want = sum(t.numel() * t.element_size()
               for t in tree_leaves(spec.args))
    assert tr["argument_bytes"] == want
    assert tr["flops"] > 0


# ---------------------------------------------------------------------------
# a prefill's recurrent state owns its memory (a view of the last row would
# keep each layer's whole (B, S, d) input alive: at rwkv6-7b's 131,072
# tokens, 32 layers x 2 x 1.07 GB on the card)
# ---------------------------------------------------------------------------
def _listed_torch(params, cfg):
    """The port's stacked parameters as the listed layout."""
    from repro_torch.tree import tree_leaves
    out = dict(params)
    if cfg.family == "hybrid":
        n_super, period = tree_leaves(params["layers"])[0].shape[:2]
        out["layers"] = [[ttf._layer(ttf._layer(params["layers"], s), m)
                          for m in range(period)] for s in range(n_super)]
        if "tail" in params:
            n_tail = tree_leaves(params["tail"])[0].shape[0]
            out["tail"] = [ttf._layer(params["tail"], i)
                           for i in range(n_tail)]
    else:
        out["layers"] = [ttf._layer(params["layers"], i)
                         for i in range(cfg.num_layers)]
    return out


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_prefill_state_does_not_pin_activations(arch):
    """The listed layout keeps each layer's state as prefill made it: every
    recurrent state tensor owns exactly its own bytes."""
    cfg = treg.get_smoke_config(arch)
    params = _listed_torch(ttf.init_params(0, cfg, device="cpu"), cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                             size=(2, 64)).tolist()
    _, cache = ttf.prefill(params, cfg, {"tokens": toks}, max_seq=64,
                           device="cpu")
    checked = 0
    for key, val in cache.items():
        if key in ("len", "k", "v"):
            continue
        for t in _flat(val):
            assert t.untyped_storage().nbytes() == \
                t.numel() * t.element_size(), key
            checked += 1
    assert checked >= 2 * cfg.num_layers


# ---------------------------------------------------------------------------
# the chunk program captures no key its prompt's own later chunks would
# evict unreplayed (a 524,288-token prompt makes 1024 chunk keys)
# ---------------------------------------------------------------------------
def test_full_cache_that_keeps_its_graphs_runs_new_keys_eagerly(monkeypatch):
    """A full cache: a new key with ``capture`` False runs eagerly and
    keeps every graph; a key that has a graph replays either way; a new
    key with ``capture`` True evicts the least recently used."""
    from repro_torch.serving import compiled as C
    from test_torch_compiled_prefill import EagerGraphs
    monkeypatch.setattr(C, "MAX_GRAPHS", 3)
    cache = EagerGraphs("cpu")
    for i in range(3):
        out = cache.run((i,), (np.asarray([i], np.int32),),
                        lambda x: x.clone())
        assert int(out[0]) == i
    for i in (3, 4):
        out = cache.run((i,), (np.asarray([i], np.int32),),
                        lambda x: x.clone(), capture=False)
        assert int(out[0]) == i
    assert list(cache._graphs) == [(0,), (1,), (2,)]
    assert (cache.captures, cache.eager_calls, cache.replays) == (3, 2, 0)
    assert int(cache.run((1,), (np.asarray([7], np.int32),),
                         lambda x: None, capture=False)[0]) == 7  # replay
    assert int(cache.run((4,), (np.asarray([8], np.int32),),
                         lambda x: x + 1)[0]) == 9     # captured now
    assert list(cache._graphs) == [(2,), (1,), (4,)]   # (0,) was LRU
    assert (cache.captures, cache.eager_calls, cache.replays) == (4, 2, 1)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_chunks_past_the_graph_cap_launch_and_serve(monkeypatch,
                                                            kv_dtype):
    """A prompt of more chunk keys than the chunk program keeps, through
    the engine with the CPU stand-in of the graphs, twice: greedy tokens
    equal the eager engine's, the chunks with MAX_GRAPHS or more of the
    prompt still to run go eagerly and the last MAX_GRAPHS are captured,
    the second prompt replays those, and the chunk kernel counts L a
    chunk either way."""
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.models import attention as tattn
    from repro_torch.serving import EngineConfig, LLMEngine, Request, \
        SamplingParams
    from repro_torch.serving import compiled as C
    from test_torch_compiled_prefill import StandInPrefill
    monkeypatch.setattr(C, "MAX_GRAPHS", 4)
    orig = ppa.paged_prefill_chunk_attention

    def counted(*a, **kw):
        fn = ppa.paged_prefill_chunk_attention_int8 \
            if kw.get("k_scale") is not None else orig
        fn.launches += 1
        return orig(*a, **kw)
    monkeypatch.setattr(tattn, "paged_prefill_chunk_attention", counted)
    fn = ppa.paged_prefill_chunk_attention_int8 if kv_dtype == "int8" \
        else orig
    cfg = treg.get_smoke_config("llama3-8b")
    params = ttf.init_params(0, cfg, device="cpu")
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=75).tolist()          # 10 chunks of 8
    econf = EngineConfig(max_batch=1, block_size=4, num_blocks=32,
                         prefill_chunk_tokens=8, kv_dtype=kv_dtype)

    def serve(eng):
        req = Request(prompt=list(prompt),
                      params=SamplingParams(max_new_tokens=4))
        eng.submit([req])
        eng.run()
        return req.output

    want = serve(LLMEngine(cfg, params, econf, device="cpu"))
    eng = LLMEngine(cfg, params, econf, device="cpu")
    eng.compiled_prefill = comp = StandInPrefill(cfg, params, eng.kv, "cpu",
                                                 8)
    n0 = fn.launches
    assert serve(eng) == want
    chunks = eng.stats.prefill_chunks_run
    assert chunks == 10
    assert fn.launches - n0 == cfg.num_layers * chunks
    assert (comp.chunk.captures, comp.chunk.graphs) == (4, 4)
    assert comp.chunk.eager_calls == chunks - 4
    assert serve(eng) == want                  # the same keys again
    assert eng.stats.prefill_chunks_run == 2 * chunks
    assert fn.launches - n0 == 2 * cfg.num_layers * chunks
    assert (comp.chunk.captures, comp.chunk.replays) == (4, 4)
    assert comp.chunk.eager_calls == 2 * (chunks - 4)
