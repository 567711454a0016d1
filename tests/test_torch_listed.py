"""The listed-parameter layout (``params["layers"]`` a list of per-layer
trees, the reference's production-serving layout, ``transformer.py:132``
and ``_decode_step_listed`` ``:881``) on the port, on the CPU: against the
port's own stacked layout (bit for bit: the same operations on the same
values) and against the JAX package's listed ``prefill`` and
``decode_step`` (1e-4: fp32 through a few layers, sums in another order),
for the dense (llama3-8b, and an int8 dense cache), gemma2, rwkv6 and
zamba2 smoke configs. Weights cross over with ``params_from_jax``, which
carries a listed tree across as lists.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
CASES = {"llama3-8b": ("llama3-8b", {"num_kv_heads": 2}),
         "llama3-8b-int8": ("llama3-8b", {"num_kv_heads": 2,
                                          "kv_cache_bits": 8}),
         "gemma2-27b": ("gemma2-27b", {"sliding_window": 8,
                                       "attention_sinks": 2}),
         "rwkv6-7b": ("rwkv6-7b", {}),
         "zamba2-1.2b": ("zamba2-1.2b", {})}
N_STEPS = 3


def _listed(params, cfg):
    """The reference pytree's listed layout: per-layer trees in a list
    (zamba2: a list over superblocks of lists of mamba layers)."""
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


def _flat(tree):
    """Leaves of a (possibly nested list / dict) cache, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=ATOL,
                               rtol=ATOL)


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    arch, kw = CASES[request.param]
    jcfg = jreg.get_smoke_config(arch, **kw)
    tcfg = treg.get_smoke_config(arch, **kw)
    jp = jtf.init_params(jax.random.PRNGKey(5), jcfg)
    jl_p = _listed(jp, jcfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    tl_p = ttf.params_from_jax(jax.tree.map(np.asarray, jl_p), tcfg, "cpu")
    toks = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, size=(2, 15)).astype(np.int32)
    max_seq = 15 + N_STEPS
    out = {"cfg": tcfg}
    out["stacked"] = ttf.prefill(tp, tcfg, {"tokens": toks}, max_seq,
                                 device="cpu")
    out["listed"] = ttf.prefill(tl_p, tcfg, {"tokens": toks}, max_seq,
                                device="cpu")
    out["jax"] = jtf.prefill(jl_p, jcfg, {"tokens": jnp.asarray(toks)},
                             max_seq)
    steps = []
    # copies: apply_decode_updates writes the stacked cache in place
    sc = {k: v.clone() for k, v in out["stacked"][1].items()}
    lc, jc = out["listed"][1], out["jax"][1]
    tok = np.asarray(out["jax"][0]).argmax(-1).astype(np.int32)
    for _ in range(N_STEPS):
        sl, su = ttf.decode_step(tp, tcfg, tok, sc, device="cpu")
        ll, lu = ttf.decode_step(tl_p, tcfg, tok, lc, device="cpu")
        jl, ju = jtf.decode_step(jl_p, jcfg, jnp.asarray(tok), jc)
        steps.append(((sl, su), (ll, lu), (jl, ju)))
        # the next step reads the stacked cache after the stacked step's
        # updates (the listed layout has no apply_decode_updates, as in
        # the reference), as per-layer lists in both packages
        sc = ttf.apply_decode_updates(sc, su)
        lc = _as_listed(sc)
        jc = jax.tree.map(lambda a: jnp.asarray(a.numpy()), lc)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    out["steps"] = steps
    return out


def _as_listed(stacked):
    """A stacked cache as the listed layout's per-layer lists (zamba2's
    mamba states: lists over superblocks of lists over the period)."""
    return {k: v if k == "len" else
            [list(s) for s in v] if k in ("h", "conv") else list(v)
            for k, v in stacked.items()}


def test_listed_prefill_equals_stacked_bit_for_bit(run):
    (sl, sc), (ll, lc) = run["stacked"], run["listed"]
    assert torch.equal(sl, ll)
    assert set(sc) == set(lc)
    for key in sc:
        if key == "len":
            assert torch.equal(sc[key], lc[key])
            continue
        assert isinstance(lc[key], list), key
        restacked = torch.stack([torch.stack(x) if isinstance(x, list)
                                 else x for x in lc[key]])
        assert torch.equal(restacked, sc[key]), key


def test_listed_prefill_matches_reference_listed(run):
    (tl, tc), (jl, jc) = run["listed"], run["jax"]
    _close(tl, jl)
    assert set(tc) == set(jc)
    for key in jc:
        if key in ("k", "v") and run["cfg"].kv_cache_bits == 8:
            continue      # int8 values: see tests/test_torch_dense_int8.py
        t, j = _flat(tc[key]), _flat(jc[key])
        assert len(t) == len(j), key
        for a, b in zip(t, j):
            scale = max(1.0, float(np.abs(np.asarray(b)).max()))
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=ATOL * scale, rtol=ATOL)


def test_listed_decode_steps_equal_stacked_and_reference(run):
    for (sl, su), (ll, lu), (jl, ju) in run["steps"]:
        assert torch.equal(sl, ll)
        _close(ll, jl)
        assert set(lu) == set(su) == set(ju)
        for key in su:
            if key == "len":
                assert torch.equal(lu[key], su[key])
                continue
            assert isinstance(lu[key], list), key
            t, s = _flat(lu[key]), _flat(su[key])
            restacked = torch.stack([torch.stack(x) if isinstance(x, list)
                                     else x for x in lu[key]])
            assert torch.equal(restacked, su[key]), key
            j = _flat(ju[key])
            assert len(t) == len(j), key
            for a, b in zip(t, j):
                scale = max(1.0, float(np.abs(np.asarray(b)).max()))
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=ATOL * scale, rtol=ATOL)


def test_paged_decode_refuses_listed_params():
    cfg = treg.get_smoke_config("llama3-8b")
    params = ttf.init_params(0, cfg, device="cpu")
    params["layers"] = [ttf._layer(params["layers"], i)
                        for i in range(cfg.num_layers)]
    with pytest.raises(ValueError, match="stacked layer params"):
        ttf.decode_step_paged(params, cfg, [1], None, None, [[0]], [1],
                              device="cpu")
