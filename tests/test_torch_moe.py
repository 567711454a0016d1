"""The port's MoE layer (``repro_torch.models.moe``), its model-level paths
and the expert pool against the JAX reference on the CPU.

* ``moe_forward`` (y and the aux loss) equals the JAX function within
  1e-5 at fp32: one routing group and several (T = 512, gs = 256), a
  decode batch, ``capacity_factor`` 1.25 and 0.5 (tokens dropped: the
  cases assert that choices were dropped), 64 (none dropped) and a router
  of zeros (every probability ties: the lower expert id wins, as
  ``jax.lax.top_k``). bf16 inputs and experts agree within 2e-2 (one
  bf16 rounding of the combine weights and of each product's output).
* The T % gs guard raises where the reference asserts.
* ``_capacity`` over a grid; ``init_moe`` through ``params_from_jax`` and
  the port's own ``init_params`` (the router stays fp32 in a bf16 model).
* qwen3's ``qk_norm`` with random non-zero ``q_norm`` / ``k_norm`` against
  JAX ``qkv_project``; ``forward`` and ``prefill`` -> ``decode_step`` ->
  ``apply_decode_updates`` of the qwen3 smoke model against JAX (fp32,
  1e-4: reordered sums on O(1) logits).
* ``transfer_bytes_moe`` and ``ExpertWorkerPool`` (its divisibility guard,
  ``run_experts`` with ``account``) against the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import worker_pool as jwp
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving import worker_pool as twp
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "qwen3-moe-30b-a3b"
ATOL = 1e-5          # moe_forward at fp32
BF16_TOL = 2e-2      # moe_forward at bf16 (module docstring)
MODEL_ATOL = 1e-4    # logits of the stacked model at fp32


def _cfgs(**kw):
    return jreg.get_smoke_config(ARCH, **kw), treg.get_smoke_config(ARCH, **kw)


def _moe_params(cfg, seed=0):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), cfg)
    return p, ttf.params_from_jax(jax.tree.map(np.asarray, p), cfg, "cpu")


def _dropped(tp, tcfg, x, group_size=256):
    """Routing choices dropped past capacity in ``moe_forward(x)``."""
    B, S, d = x.shape
    gs = min(group_size, B * S)
    C = tmoe._capacity(gs, tcfg.experts_per_token, tcfg.num_experts,
                       tcfg.capacity_factor)
    _, _, onehot, keep, _ = tmoe.route(tp["router"], tcfg,
                                       x.reshape(-1, gs, d), C)
    return int(onehot.sum() - keep.sum())


MOE_CASES = {
    # name: (B, S, capacity_factor, drops expected)
    "one-group-T5": (1, 5, 1.25, None),
    "groups-T512-cf0.5": (1, 512, 0.5, True),
    "groups-B2xS256": (2, 256, 1.25, None),
    "decode-B4": (4, 1, 1.25, None),
    "cf0.5-T64": (1, 64, 0.5, True),
    "cf64-no-drops": (2, 40, 64.0, False),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(case):
    B, S, cf, drops = MOE_CASES[case]
    cfg, tcfg = _cfgs(capacity_factor=cf)
    p, tp = _moe_params(cfg)
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    y, aux = jmoe.moe_forward(p, cfg, jnp.asarray(x))
    ty, taux = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(float(taux), float(aux), atol=ATOL, rtol=ATOL)
    assert taux.dtype == torch.float32 and ty.shape == (B, S, cfg.d_model)
    if drops is not None:
        assert (_dropped(tp, tcfg, torch.from_numpy(x)) > 0) == drops


def test_moe_forward_ties_go_to_the_lower_expert():
    """A router of zeros: every probability is 1/E, the top-k are experts
    0..k-1 for every token (the reference's tie order), and the capacity
    drops the later tokens of each group."""
    cfg, tcfg = _cfgs()
    p, tp = _moe_params(cfg)
    p = dict(p, router=jnp.zeros_like(p["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(5).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32)
    y, aux = jmoe.moe_forward(p, cfg, jnp.asarray(x))
    ty, taux = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(float(taux), float(aux), atol=ATOL, rtol=ATOL)
    _, top_p, onehot, keep, _ = tmoe.route(
        tp["router"], tcfg, torch.from_numpy(x).reshape(1, 16, -1), 8)
    k = cfg.experts_per_token
    assert torch.equal(onehot[0, :, :, :k].sum(-1),
                       torch.ones((16, k)))            # experts 0..k-1
    assert torch.allclose(top_p, torch.full_like(top_p, 1.0 / k))
    assert int(keep.sum()) == 8 * k                    # C = 8 each


def test_moe_forward_bf16_matches_reference():
    cfg, tcfg = _cfgs(dtype=jnp.bfloat16)
    tcfg = tcfg.replace(dtype=torch.bfloat16)
    p, tp = _moe_params(cfg)
    assert tp["router"].dtype == torch.float32
    assert tp["w_up"].dtype == torch.bfloat16
    x = np.random.default_rng(4).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32)
    y, aux = jmoe.moe_forward(p, cfg, jnp.asarray(x, jnp.bfloat16))
    ty, taux = tmoe.moe_forward(tp, tcfg,
                                torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(y.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(float(taux), float(aux), atol=ATOL, rtol=ATOL)


def test_moe_forward_refuses_what_the_reference_asserts():
    cfg, tcfg = _cfgs()
    p, tp = _moe_params(cfg)
    x = np.zeros((1, 300, cfg.d_model), np.float32)    # 300 % 256 != 0
    with pytest.raises(AssertionError):
        jmoe.moe_forward(p, cfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="T=300.*gs=256"):
        tmoe.moe_forward(tp, tcfg, torch.from_numpy(x))
    # a multiple of the group size routes in groups
    y, _ = tmoe.moe_forward(tp, tcfg, torch.zeros((1, 512, cfg.d_model)))
    assert y.shape == (1, 512, cfg.d_model)


def test_capacity_matches_reference_over_a_grid():
    for gs in (1, 3, 5, 8, 64, 200, 256):
        for k in (1, 2, 8):
            for E in (4, 128, 384):
                for cf in (0.5, 1.0, 1.25, 2.0, 64.0):
                    assert tmoe._capacity(gs, k, E, cf) == \
                        jmoe._capacity(gs, k, E, cf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_crosses_over_and_follows_the_init_rules(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cfg, tcfg = _cfgs(dtype=jdt)
    tcfg = tcfg.replace(dtype=tdt)
    p = jtf.init_params(jax.random.PRNGKey(0), cfg)
    crossed = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    own = ttf.init_params(0, tcfg, device="cpu")
    for tree in (crossed, own):
        moe = tree["layers"]["moe"]
        assert "ffn" not in tree["layers"]
        assert moe["router"].dtype == torch.float32
        assert moe["router"].shape == (cfg.num_layers, cfg.d_model,
                                       cfg.num_experts)
        for name, shape in (("w_gate", (cfg.d_model, cfg.moe_d_ff)),
                            ("w_up", (cfg.d_model, cfg.moe_d_ff)),
                            ("w_down", (cfg.moe_d_ff, cfg.d_model))):
            assert moe[name].dtype == tdt
            assert moe[name].shape == (cfg.num_layers, cfg.num_experts,
                                       *shape)
    for a, b in zip(jax.tree.leaves(p["layers"]["moe"]),
                    [crossed["layers"]["moe"][k] for k in
                     sorted(crossed["layers"]["moe"])]):
        assert np.array_equal(np.asarray(a, np.float32),
                              b.float().numpy())
    # each expert drawn with fan-in d (w_gate) / f (w_down), as vmapped
    # dense_init in the reference: the same spread as the reference's
    for name in ("w_gate", "w_down"):
        ours = float(own["layers"]["moe"][name].float().std())
        theirs = float(crossed["layers"]["moe"][name].float().std())
        assert abs(ours / theirs - 1) < 0.05, name
    w = own["layers"]["moe"]["w_gate"]
    assert not torch.equal(w[0, 0], w[0, 1])


def test_qk_norm_projection_matches_reference():
    """qwen3 is the one config with qk_norm: random non-zero q_norm /
    k_norm weights through qkv_project."""
    cfg, tcfg = _cfgs()
    p = jattn.init_attention(jax.random.PRNGKey(2), cfg)
    rng = np.random.default_rng(9)
    hd = cfg.resolved_head_dim
    p = dict(p, q_norm=jnp.asarray(rng.standard_normal(hd), jnp.float32),
             k_norm=jnp.asarray(rng.standard_normal(hd), jnp.float32))
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p.items()}
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7) + 3, (2, 7))
    want = jattn.qkv_project(p, cfg, jnp.asarray(x), jnp.asarray(pos))
    got = tattn.qkv_project(tp, tcfg, torch.from_numpy(x),
                            torch.from_numpy(pos.copy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=ATOL)
    # the norms act: zero weights give another projection
    plain = tattn.qkv_project(dict(tp, q_norm=torch.zeros(hd),
                                   k_norm=torch.zeros(hd)), tcfg,
                              torch.from_numpy(x),
                              torch.from_numpy(pos.copy()))
    assert not torch.allclose(plain[0], got[0], atol=1e-3)


@pytest.fixture(scope="module")
def model():
    cfg, tcfg = _cfgs()
    p = jtf.init_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(10)
    hd = cfg.resolved_head_dim
    # non-zero qk norms, so the model path exercises them too
    attn = dict(p["layers"]["attn"])
    for name in ("q_norm", "k_norm"):
        attn[name] = jnp.asarray(
            rng.standard_normal((cfg.num_layers, hd)), jnp.float32)
    p = dict(p, layers=dict(p["layers"], attn=attn))
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, p), tcfg, "cpu")
    return cfg, tcfg, p, tp


def _close(got, want, atol=MODEL_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def test_forward_matches_reference(model):
    cfg, tcfg, p, tp = model
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 24))
    want, want_aux = jtf.forward(p, cfg, {"tokens": jnp.asarray(toks,
                                                                jnp.int32)})
    got, got_aux = ttf.forward(tp, tcfg, {"tokens": toks}, device="cpu")
    _close(got, want)
    _close(got_aux, want_aux)


@pytest.mark.parametrize("bits", [16, 8])
def test_dense_cache_prefill_decode_matches_reference(model, bits):
    """prefill -> 4 x (decode_step + apply_decode_updates) over a dense
    cache (int8 with per-token scales at 8 bits), B = 2."""
    cfg, tcfg, p, tp = model
    cfg, tcfg = cfg.replace(kv_cache_bits=bits), \
        tcfg.replace(kv_cache_bits=bits)
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 13))
    lj, cj = jtf.prefill(p, cfg, {"tokens": jnp.asarray(toks, jnp.int32)},
                         max_seq=20)
    lt, ct = ttf.prefill(tp, tcfg, {"tokens": toks}, max_seq=20,
                         device="cpu")
    _close(lt, lj)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(lj, -1), np.int32)
        assert np.array_equal(lt.argmax(-1).numpy(), nxt)
        lj, uj = jtf.decode_step(p, cfg, jnp.asarray(nxt), cj)
        cj = jtf.apply_decode_updates(cj, uj)
        lt, ut = ttf.decode_step(tp, tcfg, nxt, ct, device="cpu")
        ct = ttf.apply_decode_updates(ct, ut)
        _close(lt, lj)
    assert int(ct["len"][0]) == 17


def test_transfer_bytes_moe_matches_reference():
    for arch in (ARCH, "kimi-k2-1t-a32b"):
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        for B in (1, 3, 8, 128):
            assert twp.transfer_bytes_moe(tcfg, B) == \
                jwp.transfer_bytes_moe(jcfg, B)
    tcfg = treg.get_config(ARCH)
    assert twp.transfer_bytes_moe(tcfg, 1) == \
        2 * 2 * tcfg.d_model * tcfg.num_layers


def test_expert_pool_guard_and_accounting():
    cfg, tcfg = _cfgs()
    with pytest.raises(ValueError, match="divisible"):
        twp.ExpertWorkerPool(tcfg, 3)           # 4 experts % 3 != 0
    with pytest.raises(ValueError):
        jwp.ExpertWorkerPool(cfg, 3)
    p, tp = _moe_params(cfg)
    x = np.random.default_rng(6).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    jpool, tpool = jwp.ExpertWorkerPool(cfg, 2), twp.ExpertWorkerPool(tcfg, 2)
    y = jpool.run_experts(p, jnp.asarray(x), account=True)
    ty = tpool.run_experts(tp, torch.from_numpy(x), account=True)
    _close(ty, y, ATOL)
    want, _ = tmoe.moe_forward(tp, tcfg, torch.from_numpy(x))
    assert torch.equal(ty, want)                 # one moe_forward call
    tpool.run_experts(tp, torch.from_numpy(x))   # account=False: no bytes
    for pool in (jpool, tpool):
        pool.log_iteration(3)
    assert vars(tpool.log) == vars(jpool.log)
    assert tpool.per_worker_tokens == jpool.per_worker_tokens == [0, 0]
