"""int8 dense KV caches (``kv_cache_bits == 8``, paper §7) on the port
against the JAX package, on the CPU: ``init_cache``, ``prefill``,
``decode_step`` and ``apply_decode_updates``, and the int8 dense decode
twin (the plain form of ``decode_attention_int8``) against the
reference's jnp partial with ``k_scale`` (``repro/models/attention.py``
:175), which is where the reference runs int8 dense caches (its Pallas
dense kernel takes no scales).

Configs: the llama3-8b smoke config (2 kv heads), gemma2 (window 8, 2
sinks, softcaps) and glm4-9b's group size G = 16 (32 heads over 2 kv
heads). Weights cross over with ``params_from_jax`` (exact). Tolerances:
logits and new K/V 1e-4 (fp32 through a few layers, sums in another
order); the twin 2e-5. Cache contents: given the same inputs (JAX's
cache and updates crossed over) the port writes the reference's bytes
exactly; after each package's own prefill the int8 values may differ by
one step where fp32 K/V that agree to ~1e-6 round on either side of a
half (at most 1 in 500 entries), and the scales agree to 1e-5 relative,
as the fp32 K/V they are the max of (a few ulps through two layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.models import kv_quant
from repro_torch.models import transformer as ttf
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
KTOL = dict(rtol=2e-5, atol=2e-5)
CONFIGS = {
    "llama3-8b": ("llama3-8b", {"num_kv_heads": 2}),
    "gemma2-27b": ("gemma2-27b", {"sliding_window": 8,
                                  "attention_sinks": 2}),
    "glm4-g16": ("glm4-9b", {"num_heads": 32, "num_kv_heads": 2}),
}
N_STEPS = 4


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _to_torch_cache(jc):
    return {k: _t(v) for k, v in jc.items()}


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    arch, kw = CONFIGS[request.param]
    jcfg = jreg.get_smoke_config(arch, kv_cache_bits=8, **kw)
    tcfg = treg.get_smoke_config(arch, kv_cache_bits=8, **kw)
    jp = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, size=(2, 19)).astype(np.int32)
    return jcfg, tcfg, jp, tp, toks


def test_init_cache_matches_reference(model):
    jcfg, tcfg, *_ = model
    jc = jtf.init_cache(jcfg, 3, 10)
    tc = ttf.init_cache(tcfg, 3, 10, device="cpu")
    assert set(tc) == set(jc) == {"k", "v", "k_scale", "v_scale", "len"}
    for k, leaf in jc.items():
        assert tuple(tc[k].shape) == leaf.shape, k
        assert str(tc[k].dtype).split(".")[1] == str(leaf.dtype), k
        assert not tc[k].any(), k


def test_prefill_logits_and_int8_cache_match_reference(model):
    jcfg, tcfg, jp, tp, toks = model
    max_seq = 19 + N_STEPS
    jl, jc = jtf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_seq)
    tl, tc = ttf.prefill(tp, tcfg, {"tokens": toks}, max_seq, device="cpu")
    _close(tl, jl)
    assert set(tc) == set(jc)
    for key in ("k", "v"):
        assert tc[key].dtype == torch.int8
        diff = np.abs(tc[key].numpy().astype(np.int32) -
                      _np(jc[key]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() <= 2e-3, key
        np.testing.assert_allclose(tc[f"{key}_scale"].numpy(),
                                   _np(jc[f"{key}_scale"]), rtol=1e-5,
                                   atol=1e-12)
    np.testing.assert_array_equal(tc["len"].numpy(), _np(jc["len"]))


def test_decode_steps_and_cache_writes_match_reference(model):
    """Each step from the same cache (the reference's, crossed over):
    logits and new K/V at 1e-4; the reference's own updates applied by
    the port's ``apply_decode_updates`` give the reference's cache bit for
    bit (int8 values and scales), written in place."""
    jcfg, tcfg, jp, tp, toks = model
    _, jc = jtf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 19 + N_STEPS)
    tok = toks[:, -1]
    for _ in range(N_STEPS):
        tc = _to_torch_cache(jc)
        jl, ju = jtf.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        tl, tu = ttf.decode_step(tp, tcfg, tok, tc, device="cpu")
        _close(tl, jl)
        assert set(tu) == set(ju) == {"k_new", "v_new", "len"}
        _close(tu["k_new"], ju["k_new"])
        _close(tu["v_new"], ju["v_new"])
        jc = jtf.apply_decode_updates(jc, ju)
        k_before = tc["k"]
        tc = ttf.apply_decode_updates(tc, _to_torch_cache(ju))
        assert tc["k"] is k_before                     # in place
        for key in jc:
            np.testing.assert_array_equal(tc[key].numpy(), _np(jc[key]))
        tok = _np(jl).argmax(-1).astype(np.int32)


def test_greedy_chain_matches_reference(model):
    """Each package on its own cache: the same greedy tokens."""
    jcfg, tcfg, jp, tp, toks = model
    max_seq = 19 + N_STEPS
    jl, jc = jtf.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_seq)
    tl, tc = ttf.prefill(tp, tcfg, {"tokens": toks}, max_seq, device="cpu")
    for _ in range(N_STEPS):
        jt = _np(jl).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jt)
        jl, ju = jtf.decode_step(jp, jcfg, jnp.asarray(jt), jc)
        jc = jtf.apply_decode_updates(jc, ju)
        tl, tu = ttf.decode_step(tp, tcfg, jt, tc, device="cpu")
        tc = ttf.apply_decode_updates(tc, tu)


def test_int8_kv_decode_close_to_fp():
    """The reference's ``test_int8_kv_decode_close_to_fp`` on the port:
    two int8-cache decode steps against the fp forward at cosine > 0.999
    and the same argmax."""
    cfg16 = treg.get_smoke_config("llama3-8b")
    cfg8 = cfg16.replace(kv_cache_bits=8)
    params = ttf.init_params(0, cfg16, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg16.vocab_size, (2, 20))
    full, _ = ttf.forward(params, cfg16, {"tokens": toks}, device="cpu")
    _, c8 = ttf.prefill(params, cfg8, {"tokens": toks[:, :-2]}, max_seq=32,
                        device="cpu")
    assert c8["k"].dtype == torch.int8 and "k_scale" in c8
    lg1, upd = ttf.decode_step(params, cfg8, toks[:, -2], c8, device="cpu")
    c8 = ttf.apply_decode_updates(c8, upd)
    lg2, _ = ttf.decode_step(params, cfg8, toks[:, -1], c8, device="cpu")

    def cos(a, b):
        a, b = a.double().flatten(), b.double().flatten()
        return float(a @ b / (a.norm() * b.norm()))

    assert cos(full[:, -2], lg1) > 0.999
    assert cos(full[:, -1], lg2) > 0.999
    assert bool((full[:, -1].argmax(-1) == lg2.argmax(-1)).all())


# ---------------------------------------------------------------------------
# the int8 dense decode twin against the reference's jnp int8 partial
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("G,hd,sw,sinks,cap", [
    (4, 64, 0, 0, 0.0), (16, 64, 0, 0, 30.0), (16, 128, 9, 2, 0.0),
    (8, 112, 13, 3, 50.0), (2, 112, 1, 2, 0.0), (1, 64, 2, 0, 0.0)])
def test_int8_dense_twin_matches_reference_jnp_partial(G, hd, sw, sinks,
                                                       cap):
    rng = np.random.default_rng(G * 10 + hd + sw)
    B, Hkv, S = 3, 2, 37
    q = rng.standard_normal((B, Hkv * G, hd)).astype(np.float32)
    kc = rng.integers(-127, 128, size=(B, Hkv, S, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, size=(B, Hkv, S, hd)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, size=(B, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, size=(B, Hkv, S)).astype(np.float32)
    lens = np.array([S, 20, 0], np.int32)
    kw = dict(sliding_window=sw, attention_sinks=sinks, logit_softcap=cap)
    want = jattn.decode_attention_partial_jnp(
        *map(jnp.asarray, (q, kc, vc, lens)), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), **kw)
    got = tops.decode_partial(*map(_t, (q, kc, vc, lens)), k_scale=_t(ks),
                              v_scale=_t(vs), **kw)
    live = lens > 0       # an empty row: the reference's m is -inf, ours
    for name in ("a", "s", "m"):   # the finite sentinel; both give l = 0
        np.testing.assert_allclose(getattr(got, name).numpy()[live],
                                   _np(getattr(want, name))[live], **KTOL)
    assert (got.s.numpy()[~live] == 0).all()
    assert (_np(want.s)[~live] == 0).all()


def test_int8_dense_twin_selects_away_nan_past_cache_len():
    """Stale NaN values and scales past cache_len never reach the twin's
    output (masks select, never multiply), as on the card."""
    rng = np.random.default_rng(5)
    B, Hkv, G, S, hd = 2, 2, 16, 24, 64
    q = _t(rng.standard_normal((B, Hkv, G, hd)).astype(np.float32))
    kc, vc = (_t(rng.integers(-127, 128, size=(B, Hkv, S, hd)).astype(
        np.int8)) for _ in range(2))
    ks, vs = (_t(rng.uniform(0.002, 0.03, size=(B, Hkv, S)).astype(
        np.float32)) for _ in range(2))
    lens = _t(np.array([S, 9], np.int32))
    clean = tda.decode_attention_int8(q, kc, vc, ks, vs, lens,
                                      return_partials=True)
    ks[1, :, 9:] = float("nan")
    vs[1, :, 9:] = float("inf")
    dirty = tda.decode_attention(q, kc, vc, lens, k_scale=ks, v_scale=vs,
                                 return_partials=True)
    for a, b in zip(clean, dirty):
        assert torch.equal(a, b)
    assert tda.decode_attention.launches == 0
    assert tda.decode_attention_int8.launches == 0


def test_quantize_token_is_quantize_kv_per_token():
    x = torch.randn(3, 4, 2, 64)
    q1, s1 = kv_quant.quantize_token(x)
    q2, s2 = kv_quant.quantize_kv(x)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
