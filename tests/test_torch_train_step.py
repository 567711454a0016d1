"""The port's train step against the reference's, on the CPU.

One ``make_train_step`` (forward, backward, AdamW) for every assigned arch
at its smoke size in fp32, from the same parameters (``params_from_jax``,
exact) and the same numpy batch (tokens, labels, a mask with zeros, and
the vlm / audio stub inputs): the loss, "ce", "aux", "grad_norm", "lr",
every moment and every updated parameter; then gradient accumulation.

The reference's step is jitted; the port's runs eagerly. The recurrent
archs run the reference's ``lax.scan`` under ``jax.grad`` and the port's
scan twins under its hand-written backward (``ssm_scan_bwd_plain``,
``rwkv6_scan_bwd_plain``); zamba2 and the other archs with ``remat``
rematerialise their layers on both sides.

Tolerances (fp32 both sides, sums in another order): scalars 1e-5
relative; the moments mu = 0.1·g and nu = 0.05·g² (step 1) 1e-4 of their
leaf's largest entry. A first AdamW step moves each parameter by about
±lr (mhat / sqrt(vhat) = g / (|g| + eps)), which flips with the sign of a
gradient entry at fp32 noise: where the reference's |g| is at least 1e-3
of its leaf's largest the updated parameters agree to 1e-6 (observed:
every entry that differs by more sits below 1e-4 of its leaf's largest
|g|); everywhere they agree to one update (2·lr + 1e-6). The port's
parameters also follow the AdamW formula from its own moments to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.training import optimizer as jopt
from repro.training.train_loop import make_train_step as jmake
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.training import optimizer as topt
from repro_torch.training.train_loop import make_train_step as tmake
from repro_torch.tree import tree_leaves
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

LR = 1e-3
SCALAR_RTOL = 1e-5
MOMENT_TOL = 1e-4
PARAM_ATOL = 1e-6
SIGN_FLOOR = 1e-3          # |g| / max |g| of the leaf below which a flip


def _configs(arch):
    return (jreg.get_smoke_config(arch).replace(dtype=jnp.float32),
            treg.get_smoke_config(arch).replace(dtype=torch.float32))


def _batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
          "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
          "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
    if cfg.family == "audio":
        nb["frames"] = rng.standard_normal((B, 24, cfg.d_model)).astype(
            np.float32)
    if cfg.modality == "vision":
        nb["frontend"] = rng.standard_normal((B, 8, cfg.d_model)).astype(
            np.float32)
    return nb


def _adamw(mod):
    return mod.AdamWConfig(lr=LR, warmup_steps=1, total_steps=10)


def _run_both(arch, seed=0, grad_accum=1, B=2):
    jcfg, tcfg = _configs(arch)
    jp = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    nb = _batch(jcfg, seed, B=B)
    jout = jax.jit(jmake(jcfg, _adamw(jopt), grad_accum))(
        jp, jopt.init_opt_state(jp), {k: jnp.asarray(v) for k, v in
                                      nb.items()})
    tout = tmake(tcfg, _adamw(topt), grad_accum)(
        tp, topt.init_opt_state(tp), {k: torch.from_numpy(v) for k, v in
                                      nb.items()})
    return jout, tout, tp


def _check_step(jout, tout, tp):
    (jn, js, jm), (tn, ts, tm) = jout, tout
    assert set(tm) == {"ce", "aux", "loss", "grad_norm", "lr"}
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=SCALAR_RTOL, atol=1e-7, err_msg=k)
    assert int(ts.step) == int(js.step) == 1
    lr = float(tm["lr"])
    b1c, b2c = 1 - 0.9, 1 - 0.95
    for jpar, tpar, jmu, tmu, jnu, tnu, p0 in zip(
            jax.tree.leaves(jn), tree_leaves(tn),
            jax.tree.leaves(js.mu), tree_leaves(ts.mu),
            jax.tree.leaves(js.nu), tree_leaves(ts.nu),
            tree_leaves(tp)):
        assert tpar.dtype == torch.float32 and tmu.dtype == torch.float32
        jmu, jnu, jpar = (np.asarray(a) for a in (jmu, jnu, jpar))
        for want, got in ((jmu, tmu), (jnu, tnu)):
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=MOMENT_TOL * max(float(np.abs(want).max()), 1e-30))
        g = np.abs(jmu) / 0.1
        sure = g >= SIGN_FLOOR * g.max()
        got = tpar.numpy()
        np.testing.assert_allclose(got[sure], jpar[sure], rtol=0,
                                   atol=PARAM_ATOL)
        assert float(np.abs(got - jpar).max()) <= 2 * lr + PARAM_ATOL
        # the port's update from its own moments
        m, v, p = (t.double().numpy() for t in (tmu, tnu, p0))
        delta = (m / b1c) / (np.sqrt(v / b2c) + 1e-8)
        if p.ndim >= 2:
            delta = delta + 0.1 * p
        np.testing.assert_allclose(got, p - lr * delta, rtol=0,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("arch", jreg.ASSIGNED)
def test_train_step_matches_the_reference(arch):
    _check_step(*_run_both(arch))


def test_grad_accumulation_equivalence():
    """The reference's ``test_models.py`` check on the port: two
    microbatches of 2 = one batch of 4, at its tolerances."""
    tcfg = treg.get_smoke_config("tinyllama-1.1b")
    params = ttf.init_params(3, tcfg, device="cpu")
    state = topt.init_opt_state(params)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (4, 16)).astype(np.int32))}
    p1, _, m1 = tmake(tcfg, _adamw(topt), 1)(params, state, batch)
    p2, _, m2 = tmake(tcfg, _adamw(topt), 2)(params, state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               atol=1e-3, rtol=1e-3)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=5e-3)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-moe-30b-a3b"])
def test_grad_accumulation_matches_the_reference(arch):
    """Two microbatches on each side, fp32: the fp32 gradient sums and the
    averaged metrics agree at the single step's tolerances."""
    _check_step(*_run_both(arch, seed=1, grad_accum=2, B=4))


def test_loss_fn_defaults_and_aux_weight():
    """No labels: the next token, 0 past the end; no mask: the mean; the
    moe aux loss enters at ``router_aux_weight`` (reference ``:338``)."""
    for arch in ("llama3-8b", "qwen3-moe-30b-a3b"):
        jcfg, tcfg = _configs(arch)
        jp = jtf.init_params(jax.random.PRNGKey(5), jcfg)
        tp = ttf.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                                 (2, 16)).astype(np.int32)
        jl, jm = jtf.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks)})
        tl, tm = ttf.loss_fn(tp, tcfg, {"tokens": toks}, device="cpu")
        np.testing.assert_allclose(float(tl), float(jl), rtol=SCALAR_RTOL)
        for k in ("ce", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=SCALAR_RTOL, atol=1e-7)
        want = float(tm["ce"]) + tcfg.router_aux_weight * float(tm["aux"])
        assert abs(float(tl) - want) < 1e-6
        assert (float(tm["aux"]) > 0) == (tcfg.family == "moe")
