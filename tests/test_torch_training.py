"""The reference's training tests (``tests/test_training.py``) on the
port, on the CPU, and the crossings between the two packages: the
synthetic batches bit for bit, checkpoints written by either package
restored by the other leaf for leaf and dtype for dtype, the train_small
flow (half the steps, checkpoint, restore, the rest) bit for bit against
an uninterrupted run, and the training CLI."""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import synthetic as jsyn
from repro.models import transformer as jtf
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.data.synthetic import SyntheticCorpus, packed_batches
from repro_torch.models import transformer as ttf
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import train
from repro_torch.tree import tree_leaves, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _bits(x):
    """A leaf as comparable numpy bits (bf16 through its 16-bit view)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


# ---------------------------------------------------------------------------
# the reference's tests/test_training.py on the port
# ---------------------------------------------------------------------------
def test_loss_decreases():
    cfg = treg.get_smoke_config("tinyllama-1.1b")
    data = packed_batches(cfg.vocab_size, batch=4, seq_len=64, seed=0)
    _, _, hist = train(
        cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60),
        data, 60, log_every=10, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.15


def test_checkpoint_roundtrip():
    cfg = treg.get_smoke_config("qwen3-moe-30b-a3b")
    params = ttf.init_params(0, cfg, device="cpu")
    state = opt.init_opt_state(params)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, params, state, step=3)
        ckpt.save(d, params, state, step=9)
        assert ckpt.latest_step(d) == 9
        tree, step = ckpt.restore(d, {"params": params, "opt": state})
        assert step == 9
        for a, b in zip(tree_leaves(params),
                        tree_leaves(tree["params"])):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
        assert isinstance(tree["opt"], opt.OptState)


def test_lr_schedule_warmup_and_cosine():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                          min_lr_ratio=0.1)
    assert float(opt.lr_schedule(cfg, torch.tensor(5))) < 0.6
    assert float(opt.lr_schedule(cfg, torch.tensor(10))) == 1.0
    end = float(opt.lr_schedule(cfg, torch.tensor(110)))
    assert abs(end - 0.1) < 1e-5
    jcfg = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                            min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 60, 109, 110, 200):      # fp32 both sides
        assert float(opt.lr_schedule(cfg, s)) == \
            float(jopt.lr_schedule(jcfg, jnp.asarray(s)))


def test_grad_clip_bounds_update():
    cfg = treg.get_smoke_config("tinyllama-1.1b")
    params = ttf.init_params(0, cfg, device="cpu")
    state = opt.init_opt_state(params)
    huge = tree_map(lambda p: torch.full(p.shape, 100.0), params)
    new, _, m = opt.apply_updates(params, huge, state,
                                  opt.AdamWConfig(grad_clip=1.0))
    assert float(m["grad_norm"]) > 1.0  # reported pre-clip
    for p, q in zip(tree_leaves(params), tree_leaves(new)):
        assert q.dtype == p.dtype


def test_synthetic_corpus_has_structure():
    c = SyntheticCorpus(vocab_size=64, seed=0)
    rng = np.random.default_rng(0)
    doc = c.document(rng, 2000)
    # successor entropy must be far below uniform (learnable structure)
    pair_counts = {}
    for a, b in zip(doc[:-1], doc[1:]):
        pair_counts.setdefault(int(a), []).append(int(b))
    uniq = np.mean([len(set(v)) for v in pair_counts.values()
                    if len(v) >= 10])
    assert uniq < 32  # far fewer than 64 distinct successors


def test_packed_batches_shapes():
    it = packed_batches(100, batch=3, seq_len=32, seed=0)
    b = next(it)
    assert b["tokens"].shape == (3, 32)
    assert b["labels"].shape == (3, 32)
    assert b["mask"].shape == (3, 32)
    assert float(b["mask"][0, -1]) == 0.0


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
def test_packed_batches_equal_the_reference_bit_for_bit():
    kw = dict(frontend_shape=(2, 8, 16), frames_shape=(2, 24, 16))
    ours = packed_batches(500, 2, 48, seed=3, dtype=torch.bfloat16, **kw)
    ref = jsyn.packed_batches(500, 2, 48, seed=3, dtype=jnp.bfloat16, **kw)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert set(a) == set(b)
        for k in a:
            assert str(a[k].dtype).split(".")[-1] == str(b[k].dtype), k
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), k)
    a, b = next(packed_batches(64, 1, 16)), next(jsyn.packed_batches(64, 1,
                                                                      16))
    assert set(a) == {"tokens", "labels", "mask"} == set(b)


def _jax_tree(arch, dtype, seed):
    """A reference params tree and an optimizer state at step 1 with
    random fp32 moments."""
    cfg = jreg.get_smoke_config(arch).replace(dtype=dtype)
    params = jtf.init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    moment = lambda p: jnp.asarray(  # noqa: E731
        rng.standard_normal(p.shape).astype(np.float32))
    state = jopt.OptState(step=jnp.asarray(1, jnp.int32),
                          mu=jax.tree.map(moment, params),
                          nu=jax.tree.map(moment, params))
    return cfg, params, state


def _assert_same_leaves(a_tree, b_tree):
    a = tree_leaves(a_tree) if isinstance(
        tree_leaves(a_tree)[0], torch.Tensor) else jax.tree.leaves(a_tree)
    b = jax.tree.leaves(b_tree) if not isinstance(
        jax.tree.leaves(b_tree)[0], torch.Tensor) else tree_leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == tuple(y.shape)
        assert str(x.dtype).split(".")[-1] == str(y.dtype).split(".")[-1]
        np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-7b",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_checkpoints_cross_between_the_packages(arch):
    """bf16 params with fp32 moments and an int32 step: a checkpoint the
    reference writes restores in the port, and one the port writes
    restores in the reference, leaf for leaf and dtype for dtype."""
    jcfg, jparams, jstate = _jax_tree(arch, jnp.bfloat16, 0)
    tcfg = treg.get_smoke_config(arch).replace(dtype=torch.bfloat16)
    tparams = ttf.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
    tstate = opt.OptState(
        torch.tensor(int(jstate.step), dtype=torch.int32),
        ttf.params_from_jax(jax.tree.map(np.asarray, jstate.mu), tcfg, "cpu"),
        ttf.params_from_jax(jax.tree.map(np.asarray, jstate.nu), tcfg, "cpu"))
    ttemplate = {"params": ttf.init_params(1, tcfg, device="cpu")}
    ttemplate["opt"] = opt.init_opt_state(ttemplate["params"])
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, jparams, jstate, step=7)
        tree, step = ckpt.restore(d, ttemplate)
        assert step == 7
        _assert_same_leaves(tree, {"params": jparams, "opt": jstate})
        assert int(tree["opt"].step) == 1
        assert tree["params"]["embed"].dtype == torch.bfloat16
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, tparams, tstate, step=11)
        jtemplate = {"params": jtf.init_params(jax.random.PRNGKey(2), jcfg)}
        jtemplate["opt"] = jopt.init_opt_state(jtemplate["params"])
        tree, step = jckpt.restore(d, jtemplate)
        assert step == 11 and jckpt.latest_step(d) == 11
        _assert_same_leaves({"params": tparams, "opt": tstate}, tree)


def test_train_small_flow_resumes_bit_for_bit():
    """``examples/train_small.py``'s flow on the port: half the steps with
    a checkpoint, a restore, the rest on the same data stream; the loss
    falls and the result equals an uninterrupted run bit for bit."""
    cfg = treg.get_smoke_config(
        "tinyllama-1.1b", num_layers=2, d_model=64, d_ff=192, vocab_size=256,
        num_heads=1, num_kv_heads=1)
    steps = 12
    adamw = opt.AdamWConfig(lr=6e-3, warmup_steps=steps // 10,
                            total_steps=steps)
    full_p, full_s, full_h = train(
        cfg, adamw, packed_batches(cfg.vocab_size, 4, 32, seed=0), steps,
        log_every=steps // 2, device="cpu")
    data = packed_batches(cfg.vocab_size, 4, 32, seed=0)
    with tempfile.TemporaryDirectory() as d:
        params, state, hist = train(
            cfg, adamw, data, steps // 2, log_every=steps // 2,
            checkpoint_dir=d, checkpoint_every=steps // 2, device="cpu")
        tree, step = ckpt.restore(d, {"params": params, "opt": state})
    assert step == steps // 2
    params, state, hist2 = train(
        cfg, adamw, data, steps - steps // 2, params=tree["params"],
        state=tree["opt"], log_every=steps // 2, device="cpu")
    assert hist2[-1]["loss"] < hist[0]["loss"]
    assert int(state.step) == int(full_s.step) == steps
    assert hist2[-1]["loss"] == full_h[-1]["loss"]
    for a, b in zip(tree_leaves((params, state)),
                    tree_leaves((full_p, full_s))):
        assert torch.equal(a, b)


def test_train_cli_runs_and_checkpoints(capsys):
    from repro_torch.launch import train as cli
    with tempfile.TemporaryDirectory() as d:
        params, state, hist = cli.main([
            "--arch", "rwkv6-7b", "--smoke", "--steps", "3", "--batch",
            "2", "--seq", "16", "--checkpoint-dir", d,
            "--checkpoint-every", "3", "--device", "cpu"])
        assert ckpt.latest_step(d) == 3
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("step     1 loss=") and "gnorm=" in lines[0]
    assert int(state.step) == 3 and len(hist) == 1
