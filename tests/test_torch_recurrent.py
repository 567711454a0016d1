"""The port's recurrent families (rwkv6, zamba2) and its dense-cache decode
path against the JAX reference, on the CPU.

Kernel twins: ``ssm_scan_plain``, ``rwkv6_scan_plain`` and the dense
``decode_attention_plain`` triple against the reference oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode, with
ragged S (not a multiple of the Pallas chunk) and, for decode, window, sinks
and softcap over slots past ``cache_len`` that hold NaN. Modules: Mamba2
and the RWKV6 time and channel mix, and the closed-form final states
against the reference's sequential scans. End to end: ``prefill`` logits
and every cache/state entry, then 6 greedy ``decode_step`` +
``apply_decode_updates`` steps (logits and tokens) for the zamba2-1.2b,
rwkv6-7b, llama3-8b and gemma2-27b smoke configs, with the JAX side on its
jnp path and on its Pallas path (``use_pallas_kernels=True``,
``backend="pallas"``, interpret mode); the port has one path.

Inputs come from numpy seeds; weights cross over with ``params_from_jax``
(exact). Tolerances are fp32: kernels 1e-5 (both sides run fp32 math, sums
in a different order; the scans' outputs are O(1)), logits, activations
and K/V 1e-4 (a few layers of reordered fp32 sums on O(1) values agree to
~1e-5). The recurrent states are sums over the sequence of outer products
of O(10) projections (the reference's fused (4, d, d) rkvg weight has
fan-in 4), so they reach O(100)-O(1000) and cancel to small entries; they
are held to 1e-4 of their largest entry (the closed form rounds the decay
products in another order than the sequential scan).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import decode_attention as jda
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rwkv6_scan as jrw
from repro.kernels import ssm_scan as jssm
from repro.models import blocks as jblocks
from repro.models import ssm as jssm_mod
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as trw
from repro_torch.kernels import ssm_scan as tssm
from repro_torch.models import ssm as tssm_mod
from repro_torch.models import transformer as ttf
from repro_torch.models.common import ModelConfig
from repro_torch.tree import tree_map
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

KTOL = 1e-5      # fp32 kernel twins vs oracles / Pallas (reordered sums)
ATOL = 1e-4      # fp32 logits and states through a few layers
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _close_state(got, want, tol=ATOL):
    """A recurrent state, to ``tol`` of its largest entry (see the module
    docstring)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference_field_for_field(arch, smoke):
    get_j = jreg.get_smoke_config if smoke else jreg.get_config
    get_t = treg.get_smoke_config if smoke else treg.get_config
    jcfg, tcfg = get_j(arch), get_t(arch)
    for f in dataclasses.fields(jcfg):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        assert (_DTYPES[a] == b) if f.name == "dtype" else a == b, f.name


# ---------------------------------------------------------------------------
# scan kernels: plain twins vs the oracles and the Pallas kernels
# ---------------------------------------------------------------------------
def _ssm_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    Bi = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Ci = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, H)))) * 0.5 + 0.45
         ).astype(np.float32)
    return x, Bi, Ci, a


def _rwkv_inputs(seed, B, S, H, P):
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((B, S, H, P)))) * 0.5 + 0.5
         ).astype(np.float32)
    u = (rng.standard_normal((H, P)) * 0.3).astype(np.float32)
    return r, k, v, w, u


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 37, 3, 32, 16, 16),
                                             (1, 50, 2, 64, 64, 32)])
def test_ssm_scan_plain_matches_oracle_and_pallas(B, S, H, P, N, chunk):
    x, Bi, Ci, a = _ssm_inputs(S, B, S, H, P, N)
    got = tssm.ssm_scan_plain(*(_t(z) for z in (x, Bi, Ci, a)))
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    assert tssm.ssm_scan(*(_t(z) for z in (x, Bi, Ci, a))).equal(got)
    _close(got, jref.ssm_scan_ref(x, None, Bi, Ci, a), KTOL)
    _close(got, jssm.ssm_scan(x, Bi, Ci, a, chunk=chunk, interpret=True),
           KTOL)
    # the port's oracle is the reference's oracle
    _close(tref.ssm_scan_ref(*(_t(z) for z in (x, x, Bi, Ci, a))),
           jref.ssm_scan_ref(x, None, Bi, Ci, a), KTOL)


@pytest.mark.parametrize("B,S,H,P,chunk,dtype", [
    (2, 37, 3, 32, 16, jnp.float32), (1, 50, 2, 64, 32, jnp.float32),
    (2, 29, 2, 64, 16, jnp.bfloat16)])
def test_rwkv6_scan_plain_matches_oracle_and_pallas(B, S, H, P, chunk, dtype):
    r, k, v, w, u = _rwkv_inputs(S + P, B, S, H, P)
    jin = [jnp.asarray(z).astype(dtype) for z in (r, k, v, w)]
    tin = [_t(np.asarray(z.astype(jnp.float32))).to(_DTYPES[dtype])
           for z in jin]
    got = trw.rwkv6_scan_plain(*tin, _t(u))
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    assert trw.rwkv6_scan(*tin, _t(u)).equal(got)
    _close(got, jref.rwkv6_scan_ref(*jin, u), KTOL)
    _close(got, jrw.rwkv6_scan(*jin, u, chunk=chunk, interpret=True), KTOL)
    _close(tref.rwkv6_scan_ref(*tin, _t(u)), jref.rwkv6_scan_ref(*jin, u),
           KTOL)


# ---------------------------------------------------------------------------
# dense decode kernel: plain twin triple vs the Pallas kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G,sw,sinks,cap", [(1, 0, 0, 0.0), (4, 0, 0, 30.0),
                                            (2, 9, 3, 0.0), (2, 13, 0, 50.0)])
def test_decode_attention_plain_triple_matches_pallas(G, sw, sinks, cap):
    rng = np.random.default_rng(G * 100 + sw)
    B, Hkv, S, hd = 3, 2, 40, 64
    q = rng.standard_normal((B, Hkv, G, hd)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    lens = np.array([S, 17, 1], np.int32)
    for b, n in enumerate(lens):             # stale slots past cache_len
        kc[b, :, n:] = np.nan
        vc[b, :, n:] = np.nan
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap,
              return_partials=True)
    got = tda.decode_attention(*(_t(z) for z in (q, kc, vc, lens)), **kw)
    want = jda.decode_attention(q, kc, vc, lens, block_k=16, interpret=True,
                                **kw)
    for a, b in zip(got, want):
        assert np.isfinite(a.numpy()).all()
        _close(a, b, KTOL)
    _close(got[0], tref.decode_attention_ref(
        *(_t(z) for z in (q, np.nan_to_num(kc), np.nan_to_num(vc), lens)),
        sliding_window=sw, attention_sinks=sinks, logit_softcap=cap), KTOL)


@pytest.mark.parametrize("sw", [0, 1, 2, 9])
def test_decode_partial_matches_reference_backend(sw):
    """The model-layer contract (window anchored to cache_len + 1, the
    sliding_window == 1 clamp to the sinks) of the port's dense partial vs
    the reference's Pallas backend."""
    rng = np.random.default_rng(sw)
    B, H, Hkv, S, hd = 2, 4, 2, 24, 64
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    lens = np.array([20, 5], np.int32)
    kw = dict(sliding_window=sw, attention_sinks=2, logit_softcap=0.0)
    got = tops.decode_partial(*(_t(z) for z in (q, kc, vc, lens)), **kw)
    want = jops._pallas_decode_partial_backend(q, kc, vc, lens, **kw)
    for a, b in zip(got, want):
        _close(a, b, KTOL)


# ---------------------------------------------------------------------------
# modules: Mamba2, RWKV6 time/channel mix, closed-form final states
# ---------------------------------------------------------------------------
def _module_params(jp):
    return tree_map(lambda a: _t(np.asarray(a)),
                    jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("pallas", [False, True])
def test_mamba_forward_and_final_state_match_reference(pallas):
    jcfg = jreg.get_smoke_config("zamba2-1.2b", use_pallas_kernels=pallas)
    tcfg = treg.get_smoke_config("zamba2-1.2b", use_pallas_kernels=pallas)
    jp = jssm_mod.init_mamba(jax.random.PRNGKey(2), jcfg)
    jp["a_log"] = jnp.linspace(-1.0, 0.5, jp["a_log"].shape[0])
    jp["dt_bias"] = jnp.linspace(-0.5, 0.5, jp["dt_bias"].shape[0])
    tp = _module_params(jp)
    h = (np.random.default_rng(3).standard_normal((2, 19, jcfg.d_model))
         ).astype(np.float32)
    y, st = tssm_mod.mamba_forward(tp, tcfg, _t(h), final_state=True)
    _close(y, jssm_mod.mamba_forward(jp, jcfg, jnp.asarray(h)), ATOL)
    jst = jblocks._mamba_final_state(jp, jcfg, jnp.asarray(h))
    _close_state(st["h"], jst["h"])
    _close(st["conv"], jst["conv"], ATOL)    # the reference re-projects
    # one decode step from that state
    x1 = (np.random.default_rng(4).standard_normal((2, 1, jcfg.d_model))
          ).astype(np.float32)
    yd, sd = tssm_mod.mamba_decode_step(tp, tcfg, _t(x1), st)
    jyd, jsd = jssm_mod.mamba_decode_step(jp, jcfg, jnp.asarray(x1), jst)
    _close(yd, jyd, ATOL)
    _close_state(sd["h"], jsd["h"])
    _close(sd["conv"], jsd["conv"], ATOL)


@pytest.mark.parametrize("pallas", [False, True])
def test_rwkv_time_mix_and_final_state_match_reference(pallas):
    jcfg = jreg.get_smoke_config("rwkv6-7b", use_pallas_kernels=pallas)
    tcfg = treg.get_smoke_config("rwkv6-7b", use_pallas_kernels=pallas)
    jp = jssm_mod.init_rwkv_time_mix(jax.random.PRNGKey(5), jcfg)
    # a decay spread that makes the suffix products span many magnitudes
    jp["decay_base"] = jnp.linspace(-3.0, 1.5, jcfg.d_model)
    tp = _module_params(jp)
    h = (np.random.default_rng(6).standard_normal((2, 23, jcfg.d_model))
         ).astype(np.float32)
    y, st = tssm_mod.rwkv_time_mix_forward(tp, tcfg, _t(h), final_state=True)
    _close(y, jssm_mod.rwkv_time_mix_forward(jp, jcfg, jnp.asarray(h)), ATOL)
    jst = jblocks._rwkv_final_state(jp, jcfg, jnp.asarray(h))
    _close_state(st["S"], jst["S"])
    np.testing.assert_array_equal(st["x_tm"].numpy(), _np(jst["x_tm"]))
    x1 = (np.random.default_rng(7).standard_normal((2, 1, jcfg.d_model))
          ).astype(np.float32)
    yd, sd = tssm_mod.rwkv_time_mix_decode(tp, tcfg, _t(x1), st)
    jyd, jsd = jssm_mod.rwkv_time_mix_decode(jp, jcfg, jnp.asarray(x1), jst)
    _close(yd, jyd, ATOL)
    _close_state(sd["S"], jsd["S"])


def test_rwkv_channel_mix_matches_reference():
    jcfg = jreg.get_smoke_config("rwkv6-7b")
    tcfg = treg.get_smoke_config("rwkv6-7b")
    jp = jssm_mod.init_rwkv_channel_mix(jax.random.PRNGKey(8), jcfg)
    jp["mu_k"] = jnp.full_like(jp["mu_k"], 0.3)
    jp["mu_r"] = jnp.full_like(jp["mu_r"], -0.2)
    tp = _module_params(jp)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    last = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    y, new_last = tssm_mod.rwkv_channel_mix_forward(tp, tcfg, _t(x), _t(last))
    jy, jlast = jssm_mod.rwkv_channel_mix_forward(jp, jcfg, jnp.asarray(x),
                                                  jnp.asarray(last))
    _close(y, jy, ATOL)
    np.testing.assert_array_equal(new_last.numpy(), _np(jlast))


def test_closed_form_states_survive_decays_that_round_to_zero():
    """A bf16 decay can round to exactly 0: the closed form multiplies
    suffix products (no exp of log differences), so it stays finite and
    equals the sequential recurrence."""
    rng = np.random.default_rng(10)
    B, S, H, P = 2, 17, 2, 8
    k, v = (_t(rng.standard_normal((B, S, H, P)).astype(np.float32))
            for _ in range(2))
    w = _t(rng.uniform(0.2, 1.0, (B, S, H, P)).astype(np.float32))
    w[:, 5, 0] = 0.0
    w[0, 11, 1, :3] = 0.0
    state = torch.zeros((B, H, P, P))
    for t in range(S):
        state = w[:, t, :, :, None] * state + k[:, t, :, :, None] * \
            v[:, t, :, None, :]
    got = tssm_mod.rwkv_final_state(k, v, w)
    assert torch.isfinite(got).all()
    _close(got, state, KTOL)
    xdt = _t(rng.standard_normal((B, S, H, P)).astype(np.float32))
    Bm = _t(rng.standard_normal((B, S, 5)).astype(np.float32))
    a = w[..., 0]
    h = torch.zeros((B, H, P, 5))
    for t in range(S):
        h = h * a[:, t, :, None, None] + xdt[:, t, ..., None] * \
            Bm[:, t, None, None, :]
    got = tssm_mod.mamba_final_state(xdt, Bm, a)
    assert torch.isfinite(got).all()
    _close(got, h, KTOL)


# ---------------------------------------------------------------------------
# end to end: prefill -> 6 greedy decode steps, port vs JAX
# ---------------------------------------------------------------------------
E2E = {"zamba2-1.2b": {}, "rwkv6-7b": {},
       "llama3-8b": {"num_kv_heads": 2},
       # a window shorter than the prompt, with sinks, so the masks bite
       "gemma2-27b": {"sliding_window": 8, "attention_sinks": 2}}
N_STEPS = 6


def _jax_decode(cfg, backend):
    return jax.jit(lambda p, t, c: jtf.decode_step(p, cfg, t, c,
                                                   backend=backend))


@pytest.fixture(scope="module", params=[(a, path) for a in E2E
                                        for path in ("jnp", "pallas")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def e2e(request):
    arch, path = request.param
    kw = dict(E2E[arch], use_pallas_kernels=path == "pallas")
    jcfg = jreg.get_smoke_config(arch, **kw)
    tcfg = treg.get_smoke_config(arch, **kw)
    jp = jtf.init_params(jax.random.PRNGKey(11), jcfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, size=(2, 21)).astype(np.int32)
    max_seq = 21 + N_STEPS
    jl, jc = jtf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_seq)
    tl, tc = ttf.prefill(tp, tcfg, {"tokens": toks}, max_seq, device="cpu")
    # copies: apply_decode_updates writes the port's K/V in place
    out = {"prefill": (_np(jl), tl.numpy(), jax.tree.map(np.asarray, jc),
                       {k: v.numpy().copy() for k, v in tc.items()}),
           "steps": []}
    step = _jax_decode(jcfg, path)
    jt = tt = np.argmax(_np(jl), -1).astype(np.int32)
    for _ in range(N_STEPS):
        jl, ju = step(jp, jnp.asarray(jt), jc)
        jc = jtf.apply_decode_updates(jc, ju)
        tl, tu = ttf.decode_step(tp, tcfg, tt, tc, device="cpu")
        tc = ttf.apply_decode_updates(tc, tu)
        out["steps"].append((jt, tt, _np(jl), tl.numpy()))
        jt = np.argmax(_np(jl), -1).astype(np.int32)
        tt = tl.argmax(-1).numpy().astype(np.int32)
    out["final"] = (jax.tree.map(np.asarray, jc),
                    {k: v.numpy() for k, v in tc.items()})
    return out


def _same_cache(jc, tc):
    assert set(jc) == set(tc)
    for key in jc:
        assert tc[key].shape == jc[key].shape, key
        if key in ("S", "h", "tail_h"):
            _close_state(tc[key], jc[key])
        else:
            _close(tc[key], jc[key], ATOL)


def test_prefill_logits_and_state_match_reference(e2e):
    jl, tl, jc, tc = e2e["prefill"]
    _close(tl, jl, ATOL)
    _same_cache(jc, tc)


def test_greedy_decode_steps_match_reference(e2e):
    for jt, tt, jl, tl in e2e["steps"]:
        np.testing.assert_array_equal(tt, jt)
        _close(tl, jl, ATOL)
    _same_cache(*e2e["final"])


@pytest.mark.parametrize("arch", list(E2E))
def test_prefill_then_decode_matches_forward_within_port(arch):
    cfg = treg.get_smoke_config(arch, **E2E[arch])
    params = ttf.init_params(1, cfg, device="cpu")
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size,
                                              size=(2, 14))
    full, _ = ttf.forward(params, cfg, {"tokens": toks}, device="cpu")
    assert full.shape == (2, 14, cfg.vocab_size)
    logits, cache = ttf.prefill(params, cfg, {"tokens": toks[:, :10]},
                                max_seq=32, device="cpu")
    _close(logits, full[:, 9], ATOL)
    for t in range(10, 14):
        logits, upd = ttf.decode_step(params, cfg, toks[:, t], cache,
                                      device="cpu")
        cache = ttf.apply_decode_updates(cache, upd)
        _close(logits, full[:, t], ATOL)
    assert cache["len"].tolist() == [14, 14]


# ---------------------------------------------------------------------------
# structure, refusals, the use_pallas_kernels flag
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_init_params_and_cache_have_the_reference_structure(arch):
    jcfg, tcfg = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    jp = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0), jcfg))
    tp = ttf.init_params(0, tcfg, device="cpu")
    jflat = {jax.tree_util.keystr(p): leaf for p, leaf in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {jax.tree_util.keystr(p): leaf for p, leaf in
             jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert set(jflat) == set(tflat)
    for k, leaf in jflat.items():
        assert tuple(tflat[k].shape) == leaf.shape, k
        assert tflat[k].dtype == _DTYPES[leaf.dtype.type], k
    # exact crossing of the reference's weights
    jreal = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    tx = ttf.params_from_jax(jax.tree.map(np.asarray, jreal), tcfg, "cpu")
    for p, leaf in jax.tree_util.tree_flatten_with_path(jreal)[0]:
        t = tx
        for k in p:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    jcache = jtf.init_cache(jcfg, 3, 10)
    tcache = ttf.init_cache(tcfg, 3, 10, device="cpu")
    assert set(jcache) == set(tcache)
    for k, leaf in jcache.items():
        assert tuple(tcache[k].shape) == leaf.shape, k
        assert not tcache[k].any(), k


def test_entry_points_refuse_what_is_not_ported():
    # int8 dense caches are served since the dense decode kernel's int8
    # entry (tests/test_torch_dense_int8.py); as in the reference, only
    # the KV-cache dense stacks quantize (zamba2's shared attention keeps
    # the model dtype)
    cfg = treg.get_smoke_config("llama3-8b", kv_cache_bits=8)
    cache = ttf.init_cache(cfg, 2, 8, device="cpu")
    assert cache["k"].dtype == torch.int8 and "k_scale" in cache
    params = ttf.init_params(0, cfg.replace(kv_cache_bits=16), device="cpu")
    _, cache = ttf.prefill(params, cfg, {"tokens": [[1, 2]]}, 4,
                           device="cpu")
    assert cache["v"].dtype == torch.int8 and "v_scale" in cache
    zcache = ttf.init_cache(treg.get_smoke_config("zamba2-1.2b",
                                                  kv_cache_bits=8), 1, 4,
                            device="cpu")
    assert zcache["k"].dtype == torch.float32 and "k_scale" not in zcache
    # the audio family is served since its slice (tests/test_torch_audio.py)
    other = ModelConfig(family="audio", encoder_layers=1, num_layers=1,
                        d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
                        vocab_size=16, dtype=torch.float32)
    ap = ttf.init_params(0, other, device="cpu")
    assert ap["enc_layers"]["attn"]["wq"].shape[0] == 1 and \
        "cross" in ap["layers"]
    acache = ttf.init_cache(other, 1, 4, device="cpu")
    assert acache["ck"].shape == (1, 1, 2, 0, 16)
    assert ttf.forward(ap, other, {"tokens": [[1]], "frames": np.zeros(
        (1, 3, 32), np.float32)}, device="cpu")[0].shape == (1, 1, 16)
    # the moe family is served since its slice (tests/test_torch_moe.py)
    mcfg = treg.get_smoke_config("qwen3-moe-30b-a3b")
    mp = ttf.init_params(0, mcfg, device="cpu")
    assert "moe" in mp["layers"] and "ffn" not in mp["layers"]
    assert ttf.init_cache(mcfg, 1, 4, device="cpu")["k"].shape[0] == \
        mcfg.num_layers
    assert ttf.forward(mp, mcfg, {"tokens": [[1, 2]]},
                       device="cpu")[0].shape == (1, 2, mcfg.vocab_size)
    # LLMEngine and the paged entry points keep serving KV stacks only
    from repro_torch.serving import LLMEngine
    zcfg = treg.get_smoke_config("zamba2-1.2b")
    zp = ttf.init_params(0, zcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        LLMEngine(zcfg, zp, device="cpu")
    with pytest.raises(NotImplementedError):
        ttf.decode_step_paged(zp, zcfg, [1], None, None, [[0]], [1],
                              device="cpu")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_use_pallas_kernels_changes_nothing_in_the_port(arch):
    cfg = treg.get_smoke_config(arch)
    params = ttf.init_params(2, cfg, device="cpu")
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (1, 9))
    a, _ = ttf.forward(params, cfg, {"tokens": toks}, device="cpu")
    b, _ = ttf.forward(params, cfg.replace(use_pallas_kernels=True),
                       {"tokens": toks}, device="cpu")
    assert torch.equal(a, b)


def test_new_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = treg.get_smoke_config("rwkv6-7b")
    params = ttf.init_params(0, cfg, device="cpu")
    cache = ttf.init_cache(cfg, 1, 4, device="cpu")
    for fn in (lambda: ttf.init_cache(cfg, 1, 4),
               lambda: ttf.forward(params, cfg, {"tokens": [[1, 2]]}),
               lambda: ttf.decode_step(params, cfg, [1], cache)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
