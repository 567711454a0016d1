"""The port's audio family (seamless-m4t-medium's encoder-decoder) against
the JAX reference, on the CPU, at the smoke config (2 encoder and 2
decoder layers, d 256, 4 / 4 heads of 64, fp32).

Weights cross over with ``params_from_jax`` (exact); frames and tokens come
from numpy seeds. Tolerances: fp32 logits through ``forward`` and through
4 decode steps 1e-4 (a few layers of reordered fp32 sums on O(1) values);
``prefill``'s logits and its k / v / ck / cv caches 1e-5 (one pass, no
decode step); bf16 weights and activations 2e-2 (a few bf16 roundings of
O(1) values, 2^-8 each, over the layers); the cross-attention's plain twin
against the reference's jnp partial + ``finalize`` 2e-5 (fp32 softmax over
up to 40 rows, sums in another order). The listed layout equals the
stacked one bit for bit (the same operations on the same values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import combine as jcomb
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs import registry as treg
from repro_torch.kernels import decode_attention as tda
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "seamless-m4t-medium"
B, S_ENC, S_DEC, N_STEPS = 2, 40, 7, 4
ATOL = 1e-4        # fp32 logits through a few layers and decode steps
PTOL = 1e-5        # fp32 prefill: logits and caches
BTOL = 2e-2        # bf16
XTOL = 2e-5        # the cross-attention twin vs the jnp partial


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=tol,
                               rtol=tol)


def _listed(params, n):
    idx = lambda tree, i: jax.tree.map(lambda a: a[i], tree)  # noqa: E731
    out = dict(params)
    out["layers"] = [idx(params["layers"], i) for i in range(n)]
    out["enc_layers"] = [idx(params["enc_layers"], i) for i in range(n)]
    return out


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_DEC)).astype(np.int32)
    return frames, tokens


def _pair(dtype=jnp.float32, tdtype=torch.float32, seed=3):
    jcfg = jreg.get_smoke_config(ARCH, dtype=dtype)
    tcfg = treg.get_smoke_config(ARCH, dtype=tdtype)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def fp32():
    jcfg, tcfg, jp, tp = _pair()
    frames, tokens = _inputs(jcfg)
    max_seq = S_DEC + N_STEPS
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    tbatch = {"frames": frames, "tokens": tokens}
    out = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jbatch=jbatch,
               tbatch=tbatch)
    out["jprefill"] = jtf.prefill(jp, jcfg, jbatch, max_seq)
    out["tprefill"] = ttf.prefill(tp, tcfg, tbatch, max_seq, device="cpu")
    # the listed layout: per-layer trees in both packages
    jl = _listed(jp, jcfg.num_layers)
    tl = ttf.params_from_jax(jax.tree.map(np.asarray, jl), tcfg, "cpu")
    out["lprefill"] = ttf.prefill(tl, tcfg, tbatch, max_seq, device="cpu")
    out["jlprefill"] = jtf.prefill(jl, jcfg, jbatch, max_seq)
    # N_STEPS greedy steps on both sides, each fed the reference's token;
    # the listed step reads the stacked cache as per-layer lists
    jc = out["jprefill"][1]
    tc = {k: v.clone() for k, v in out["tprefill"][1].items()}
    tok = np.asarray(out["jprefill"][0]).argmax(-1).astype(np.int32)
    steps = []
    for _ in range(N_STEPS):
        jlg, ju = jtf.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        tlg, tu = ttf.decode_step(tp, tcfg, tok, tc, device="cpu")
        lc = {k: v if k == "len" else list(v) for k, v in tc.items()}
        llg, lu = ttf.decode_step(tl, tcfg, tok, lc, device="cpu")
        steps.append(dict(jax=(jlg, ju), port=(tlg, tu), listed=(llg, lu)))
        jc = jtf.apply_decode_updates(jc, ju)
        tc = ttf.apply_decode_updates(tc, tu)
        tok = np.asarray(jlg).argmax(-1).astype(np.int32)
    out["steps"], out["jcache"], out["tcache"] = steps, jc, tc
    return out


def test_init_params_matches_the_reference_tree():
    jcfg, tcfg, jp, tp = _pair()
    own = ttf.init_params(0, tcfg, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        keys = [p.key for p in path]
        got, mine = tp, own
        for k in keys:
            got, mine = got[k], mine[k]
        assert torch.equal(got, torch.from_numpy(np.array(leaf))), keys
        assert mine.shape == got.shape and mine.dtype == got.dtype, keys
    assert sorted(own) == sorted(jp) == ["embed", "enc_layers", "enc_norm",
                                         "final_norm", "layers", "lm_head"]
    assert own["enc_layers"]["attn"]["wq"].shape[0] == tcfg.encoder_layers
    assert sorted(own["layers"]) == ["attn", "cross", "ffn", "norm1",
                                     "norm2", "norm3"]
    assert float(own["layers"]["norm3"].abs().max()) == 0.0
    again = ttf.init_params(0, tcfg, device="cpu")
    assert torch.equal(own["layers"]["cross"]["wk"],
                       again["layers"]["cross"]["wk"])


def test_forward_logits_match_the_reference(fp32):
    jl, _ = jtf.forward(fp32["jp"], fp32["jcfg"], fp32["jbatch"])
    tl, taux = ttf.forward(fp32["tp"], fp32["tcfg"], fp32["tbatch"],
                           device="cpu")
    assert float(taux) == 0.0
    assert tl.shape == (B, S_DEC, fp32["tcfg"].vocab_size)
    _close(tl, jl, ATOL)


@pytest.mark.parametrize("layout", ["stacked", "listed"])
def test_prefill_logits_and_caches_match_the_reference(fp32, layout):
    tkey, jkey = ("tprefill", "jprefill") if layout == "stacked" else \
        ("lprefill", "jlprefill")
    (tl, tc), (jl, jc) = fp32[tkey], fp32[jkey]
    _close(tl, jl, PTOL)
    assert set(tc) == set(jc) == {"k", "v", "ck", "cv", "len"}
    assert torch.equal(tc["len"], torch.full((B,), S_DEC, dtype=torch.int32))
    L, cfg = fp32["tcfg"].num_layers, fp32["tcfg"]
    for key in ("k", "v", "ck", "cv"):
        t = torch.stack(tc[key]) if layout == "listed" else tc[key]
        j = np.stack(jc[key]) if layout == "listed" else np.asarray(jc[key])
        S = S_ENC if key in ("ck", "cv") else S_DEC + N_STEPS
        assert t.shape == (L, B, cfg.num_kv_heads, S, 64), key
        assert t[0].is_contiguous(), key
        _close(t, j, PTOL)


def test_listed_prefill_equals_stacked_bit_for_bit(fp32):
    (sl, sc), (ll, lc) = fp32["tprefill"], fp32["lprefill"]
    assert torch.equal(sl, ll)
    for key in ("k", "v", "ck", "cv"):
        assert isinstance(lc[key], list), key
        assert torch.equal(torch.stack(lc[key]), sc[key]), key


def test_decode_steps_match_the_reference_stacked_and_listed(fp32):
    for st in fp32["steps"]:
        (jl, ju), (tl, tu), (ll, lu) = st["jax"], st["port"], st["listed"]
        _close(tl, jl, ATOL)
        assert torch.equal(ll, tl)
        assert set(tu) == set(lu) == set(ju) == {"k_new", "v_new", "len"}
        for key in ("k_new", "v_new"):
            _close(tu[key], ju[key], ATOL)
            assert torch.equal(torch.stack(lu[key]), tu[key]), key
    # the caches after N_STEPS placements agree; the cross K/V are read,
    # never written
    jc, tc = fp32["jcache"], fp32["tcache"]
    for key in ("k", "v", "ck", "cv"):
        _close(tc[key], jc[key], ATOL)
    assert torch.equal(tc["ck"], fp32["tprefill"][1]["ck"])
    assert torch.equal(tc["len"], torch.full((B,), S_DEC + N_STEPS,
                                             dtype=torch.int32))


def test_decode_step_calls_the_dense_decode_kernel_twice_a_layer(
        fp32, monkeypatch):
    """Self- and cross-attention both go through ``decode_attention`` (row
    5's wrapper), the cross call over every encoder row at G = 1."""
    calls = []
    plain = tda.decode_attention

    def counted(q, k, v, cache_len, **kw):
        calls.append((tuple(k.shape), cache_len.tolist()))
        return plain(q, k, v, cache_len, **kw)
    monkeypatch.setattr(tda, "decode_attention", counted)
    tc = fp32["tprefill"][1]
    ttf.decode_step(fp32["tp"], fp32["tcfg"], [1, 2], tc, device="cpu")
    L, Hkv = fp32["tcfg"].num_layers, fp32["tcfg"].num_kv_heads
    assert len(calls) == 2 * L
    cross = [c for c in calls if c[0][2] == S_ENC]
    assert len(cross) == L
    assert all(c == ((B, Hkv, S_ENC, 64), [S_ENC] * B) for c in cross)


def test_bf16_matches_the_reference():
    jcfg, tcfg, jp, tp = _pair(jnp.bfloat16, torch.bfloat16, seed=4)
    frames, tokens = _inputs(jcfg, seed=1)
    jbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tokens)}
    tbatch = {"frames": frames, "tokens": tokens}
    jf, _ = jtf.forward(jp, jcfg, jbatch)
    tf, _ = ttf.forward(tp, tcfg, tbatch, device="cpu")
    _close(tf.float(), np.asarray(jf.astype(jnp.float32)), BTOL)
    jlg, jc = jtf.prefill(jp, jcfg, jbatch, S_DEC + 2)
    tlg, tc = ttf.prefill(tp, tcfg, tbatch, S_DEC + 2, device="cpu")
    assert tc["ck"].dtype == torch.bfloat16
    _close(tlg.float(), np.asarray(jlg.astype(jnp.float32)), BTOL)
    tok = np.asarray(jlg.astype(jnp.float32)).argmax(-1).astype(np.int32)
    for _ in range(2):
        jlg, ju = jtf.decode_step(jp, jcfg, jnp.asarray(tok), jc)
        tlg, tu = ttf.decode_step(tp, tcfg, tok, tc, device="cpu")
        _close(tlg.float(), np.asarray(jlg.astype(jnp.float32)), BTOL)
        jc = jtf.apply_decode_updates(jc, ju)
        tc = ttf.apply_decode_updates(tc, tu)
        tok = np.asarray(jlg.astype(jnp.float32)).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("Bq,H,Hkv,S", [(2, 4, 4, 40), (3, 16, 16, 7),
                                        (1, 8, 2, 33)])
def test_cross_attention_twin_matches_the_jnp_partial(Bq, H, Hkv, S):
    rng = np.random.default_rng(S)
    q = rng.standard_normal((Bq, H, 64)).astype(np.float32)
    k = rng.standard_normal((Bq, Hkv, S, 64)).astype(np.float32)
    v = rng.standard_normal((Bq, Hkv, S, 64)).astype(np.float32)
    got = tattn.decode_cross_attention(*(torch.from_numpy(a)
                                         for a in (q, k, v)))
    full = jnp.full((Bq,), S, jnp.int32)
    want = jcomb.finalize(jattn.decode_attention_partial_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), full))
    assert got.shape == (Bq, H, 64) and got.dtype == torch.float32
    _close(got, want, XTOL)


def test_audio_is_served_only_by_the_dense_cache_entry_points():
    """As in the reference: no padded prefill, no paged step, no engine."""
    from repro_torch.serving import LLMEngine
    tcfg = treg.get_smoke_config(ARCH)
    tp = ttf.init_params(0, tcfg, device="cpu")
    frames, tokens = _inputs(tcfg)
    batch = {"frames": frames, "tokens": tokens}
    with pytest.raises(NotImplementedError):
        ttf.prefill(tp, tcfg, batch, 9, device="cpu",
                    length=torch.tensor([S_DEC]))
    with pytest.raises(NotImplementedError):
        ttf.decode_step_paged(tp, tcfg, [1], None, None, [[0]], [1],
                              device="cpu")
    with pytest.raises(NotImplementedError):
        LLMEngine(tcfg, tp, device="cpu")
