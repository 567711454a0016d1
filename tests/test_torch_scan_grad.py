"""The scans' backward on the CPU: the plain backward twins
(``ssm_scan_bwd_plain``, ``rwkv6_scan_bwd_plain``) against autograd through
the plain forward twins, and against ``jax.grad`` of the reference oracles
(``repro.kernels.ref`` ``ssm_scan_ref`` / ``rwkv6_scan_ref``, a
``lax.scan``: the reference's training path differentiates such a scan);
the autograd Functions ``ssm_scan`` / ``rwkv6_scan``; and the remat
recompute at model level.

Cases: ragged S (not a multiple of the 16-step tile: 1, 17, 37), decays of
exactly 0 and exactly 1.0 (a whole tile of 1.0 too), RWKV6 in the model's
bf16 (its decays exp(-exp(-6 + noise)) round to 0.984 .. 1.0 in bf16).

Tolerances: both sides fp32 step math, sums in another order; the
gradients are sums over up to S steps of O(1)-O(10) products, held to
1e-5 of each gradient's largest entry plus 1e-5 relative. The bf16 case
is held in fp32 (both sides read the same bf16 inputs) to the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro_torch.configs import registry as treg
from repro_torch.kernels import rwkv6_scan as trw
from repro_torch.kernels import ssm_scan as tssm
from repro_torch.models import transformer as ttf
from repro_torch.tree import tree_leaves, tree_unflatten
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5


def _close(got, want, what=""):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _decays(rng, shape, edges):
    a = np.exp(-np.exp(rng.standard_normal(shape) - 1.0))
    if edges:
        pick = rng.random(shape)
        a = np.where(pick < 0.05, 0.0, np.where(pick > 0.75, 1.0, a))
        a[:, 16:32] = 1.0
    return a.astype(np.float32)


def _ssm_inputs(seed, B, S, H, P, N, edges):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bi = rng.standard_normal((B, S, N)).astype(np.float32)
    Ci = rng.standard_normal((B, S, N)).astype(np.float32)
    a = _decays(rng, (B, S, H), edges)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    return (x, Bi, Ci, a), dy


SSM_CASES = [(2, 37, 3, 8, 16, False), (1, 1, 2, 8, 16, False),
             (2, 40, 2, 16, 32, True), (1, 17, 2, 8, 16, True)]


@pytest.mark.parametrize("B,S,H,P,N,edges", SSM_CASES)
def test_ssm_scan_bwd_plain_matches_autograd_and_jax(B, S, H, P, N, edges):
    ops, dy = _ssm_inputs(S + N, B, S, H, P, N, edges)
    got = tssm.ssm_scan_bwd_plain(*map(torch.from_numpy, ops),
                                  torch.from_numpy(dy))
    # autograd through the plain forward twin
    leaves = [torch.from_numpy(a).requires_grad_() for a in ops]
    y = tssm.ssm_scan_plain(*leaves)
    auto = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    # jax.grad of the reference oracle (its lax.scan)
    _, vjp = jax.vjp(lambda x, b, c, a: jref.ssm_scan_ref(x, None, b, c, a),
                     *map(jnp.asarray, ops))
    ref = vjp(jnp.asarray(dy))
    for name, g, a, r in zip(("dx", "dB", "dC", "ddecay"), got, auto, ref):
        assert g.shape == a.shape and g.dtype == torch.float32
        _close(g, a.detach(), name + " vs autograd")
        _close(g, np.asarray(r), name + " vs jax")


def _rwkv_inputs(seed, B, S, H, P, decays):
    rng = np.random.default_rng(seed)
    shape = (B, S, H, P)
    r, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    if decays == "model":
        w = np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal(shape)))
        w = w.astype(np.float32)
    else:
        w = _decays(rng, shape, decays == "edges")
    u = (0.5 * rng.standard_normal((H, P))).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return (r, k, v, w, u), dy


RWKV_CASES = [(2, 37, 3, 8, "randn", False), (1, 1, 2, 8, "randn", False),
              (2, 40, 2, 16, "edges", False), (1, 17, 2, 8, "edges", False),
              (2, 33, 2, 16, "model", True)]


@pytest.mark.parametrize("B,S,H,P,decays,bf16", RWKV_CASES)
def test_rwkv6_scan_bwd_plain_matches_autograd_and_jax(B, S, H, P, decays,
                                                       bf16):
    ops, dy = _rwkv_inputs(S + P, B, S, H, P, decays)
    if bf16:             # the model's bf16 r/k/v/w (u stays fp32)
        t = [torch.from_numpy(a).bfloat16() for a in ops[:4]]
        ops = tuple(x.float().numpy() for x in t) + ops[4:]
    else:
        t = [torch.from_numpy(a) for a in ops[:4]]
    tops = t + [torch.from_numpy(ops[4])]
    got = trw.rwkv6_scan_bwd_plain(*tops, torch.from_numpy(dy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ops]
    y = trw.rwkv6_scan_plain(*leaves)
    # at S = 1 the decay is never applied: its gradient is zero
    auto = torch.autograd.grad(y, leaves, torch.from_numpy(dy),
                               allow_unused=True, materialize_grads=True)
    _, vjp = jax.vjp(jref.rwkv6_scan_ref, *map(jnp.asarray, ops))
    ref = vjp(jnp.asarray(dy))
    for name, g, a, r in zip(("dr", "dk", "dv", "dw", "du"), got, auto, ref):
        assert g.shape == a.shape and g.dtype == torch.float32
        _close(g, a.detach(), name + " vs autograd")
        _close(g, np.asarray(r), name + " vs jax")
    if bf16:
        assert float(torch.min(t[3].float())) >= 0.98   # 0.984 .. 1.0
        assert bool((t[3].float() == 1.0).any())


def test_scan_functions_differentiate_through_the_plain_backward():
    """On CPU tensors ``ssm_scan`` / ``rwkv6_scan`` run the plain forward
    twin and, in the backward, the plain backward twin; the gradients come
    back in the inputs' dtypes."""
    ops, dy = _ssm_inputs(1, 2, 37, 3, 8, 16, True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ops]
    y = tssm.ssm_scan(*leaves)
    assert torch.equal(y.detach(), tssm.ssm_scan_plain(*leaves).detach())
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = tssm.ssm_scan_bwd_plain(*map(torch.from_numpy, ops),
                                   torch.from_numpy(dy))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    rops, rdy = _rwkv_inputs(2, 2, 33, 2, 8, "model")
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_()
              for a in rops[:4]] + [torch.from_numpy(rops[4])
                                    .requires_grad_()]
    y = trw.rwkv6_scan(*leaves)
    assert y.dtype == torch.float32
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(rdy))
    want = trw.rwkv6_scan_bwd_plain(*(x.detach() for x in leaves),
                                    torch.from_numpy(rdy))
    for g, w, x in zip(grads, want, leaves):
        assert g.dtype == x.dtype and torch.equal(g, w.to(x.dtype))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_remat_recomputes_the_scans_and_changes_no_gradient(arch,
                                                            monkeypatch):
    """With ``remat`` every remat unit's scans run again in the backward
    (zamba2: the superblocks' mamba layers, not the tail's, as the
    reference wraps them; rwkv6: every layer), and the loss and every
    gradient equal those without remat bit for bit."""
    cfg = treg.get_smoke_config(arch).replace(dtype=torch.float32)
    params = ttf.init_params(4, cfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20))
    mod, name = (tssm, "ssm_scan_plain") if arch == "zamba2-1.2b" else \
        (trw, "rwkv6_scan_plain")
    calls = []
    plain = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: calls.append(1) or plain(*a))
    out = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        leaves = [p.detach().requires_grad_()
                  for p in tree_leaves(params)]
        loss, _ = ttf.loss_fn(tree_unflatten(params, leaves), c,
                              {"tokens": toks}, device="cpu")
        calls.clear()
        grads = torch.autograd.grad(loss, leaves)
        out[remat] = (loss, grads, len(calls))
    if arch == "zamba2-1.2b":
        n_super = cfg.num_layers // cfg.shared_attn_period
        want = n_super * cfg.shared_attn_period
    else:
        want = cfg.num_layers
    assert out[False][2] == 0 and out[True][2] == want
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
