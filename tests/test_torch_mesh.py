"""The port's mesh and placement rules (``launch/mesh.py``,
``core/disagg.py``) and the placed train step, held against the JAX
reference: the port's counterpart of ``tests/test_sharding.py:25, 117``.

The spec rules run here on the port's ``AbstractMesh`` at the production
shapes, leaf for leaf against the reference's on JAX's (meta
parameters on the port's side, ``jax.eval_shape`` on the reference's: no
process group, nothing allocated). One world of 8 gloo processes
(``torch.multiprocessing`` spawn, one PyTorch thread each, rendezvous
through a file in ``tmp_path``) builds the meshes, places tensors and runs
the placed train step on a (2, 4) mesh; each test reads its part of the
world's results. No JAX runs in the ranks."""
import dataclasses
import datetime
import os
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 8
MESHES = (((16, 16), ("data", "model")),
          ((16, 4, 4), ("data", "model", "attn")),
          ((2, 16, 16), ("pod", "data", "model")))
MESH_IDS = ["16x16", "attn_pool_16x4x4", "multi_pod_2x16x16"]
TRAIN_OVERRIDES = dict(num_heads=8, num_kv_heads=4, d_model=256)
# the largest |placed - single-process| parameter difference after one
# step allowed (observed: 1.2e-6, fp32 sums in another order)
PARAM_TOL = 1e-5


# ---------------------------------------------------------------------------
# spec rules, leaf for leaf
# ---------------------------------------------------------------------------
def _jax_mesh(shape, axes):
    import jax
    return jax.sharding.AbstractMesh(shape, axes)


def _jax_specs(tree):
    import jax
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree):
    from repro_torch.tree import tree_leaves
    return [tuple(s) for s in tree_leaves(tree)]


def _assert_divisible(specs, shapes, axes_sizes, what):
    for spec, shape in zip(specs, shapes):
        assert len(spec) <= len(shape), (what, shape, spec)
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            n = 1
            for a in ((ax,) if isinstance(ax, str) else ax):
                n *= axes_sizes[a]
            assert shape[i] % n == 0, (what, shape, spec)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
def test_param_specs_match_the_reference_for_every_assigned_arch(mesh_shape):
    import jax

    from repro.configs import registry as jreg
    from repro.core import disagg as jd
    from repro.models import transformer as jT
    from repro_torch.configs import registry
    from repro_torch.core import disagg
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves

    shape, axes = mesh_shape
    jm, pm = _jax_mesh(shape, axes), AbstractMesh(shape, axes)
    for arch in registry.ASSIGNED:
        fsdp = arch == "kimi-k2-1t-a32b"
        jcfg, cfg = jreg.get_config(arch), registry.get_config(arch)
        jshape = jax.eval_shape(
            lambda c=jcfg: jT.init_params(jax.random.PRNGKey(0), c))
        params = transformer.init_params(0, cfg, device="meta")
        shapes = [tuple(p.shape) for p in tree_leaves(params)]
        assert shapes == [p.shape for p in jax.tree.leaves(jshape)], arch
        got = _port_specs(disagg.specs_for_params(cfg, params, pm,
                                                  fsdp=fsdp))
        want = _jax_specs(jd.specs_for_params(jcfg, jshape, jm, fsdp=fsdp))
        assert got == want, arch
        _assert_divisible(got, shapes, pm.shape, arch)


def _listed(cache):
    """The listed layout of a dense-family cache: per-layer lists of the
    stacked (L, ...) leaves, ``len`` as it is."""
    return {k: (v if k == "len" else [v[i] for i in range(v.shape[0])])
            for k, v in cache.items()}


def _jax_listed(cache):
    import jax
    return {k: (v if k == "len" else
                [jax.ShapeDtypeStruct(v.shape[1:], v.dtype)] * v.shape[0])
            for k, v in cache.items()}


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
def test_cache_batch_and_logits_specs_match_the_reference(mesh_shape):
    import jax

    from repro.configs import registry as jreg
    from repro.core import disagg as jd
    from repro.models import transformer as jT
    from repro_torch.configs import registry
    from repro_torch.core import disagg
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves

    shape, axes = mesh_shape
    jm, pm = _jax_mesh(shape, axes), AbstractMesh(shape, axes)
    for arch in registry.ASSIGNED:
        jbase, base = jreg.get_config(arch), registry.get_config(arch)
        variants = [(jbase, base)]
        if base.family in ("dense", "vlm", "moe"):     # int8 scale leaves
            variants.append((dataclasses.replace(jbase, kv_cache_bits=8),
                             dataclasses.replace(base, kv_cache_bits=8)))
        for jcfg, cfg in variants:
            for B in (1, 32):
                jc = jax.eval_shape(lambda c=jcfg: jT.init_cache(c, B, 1024))
                pc = transformer.init_cache(cfg, B, 1024, device="meta")
                layouts = [(jc, pc)]
                if cfg.family in ("dense", "vlm", "moe"):
                    layouts.append((_jax_listed(jc), _listed(pc)))
                for jtree, ptree in layouts:
                    shapes = [tuple(x.shape) for x in tree_leaves(ptree)]
                    assert shapes == [x.shape for x in
                                      jax.tree.leaves(jtree)], arch
                    for part in ("head", "seq", "auto"):
                        got = _port_specs(disagg.specs_for_cache(
                            cfg, ptree, pm, part))
                        assert got == _jax_specs(jd.specs_for_cache(
                            jcfg, jtree, jm, part)), (arch, B, part)
                        _assert_divisible(got, shapes, pm.shape, arch)
        for B in (1, 16, 32, 256):
            assert tuple(disagg.logits_spec(base, pm, B)) == \
                tuple(jd.logits_spec(jbase, jm, B)), (arch, B)
    for B in (1, 16, 32, 256):
        pbatch = {"tokens": torch.empty((B, 64), device="meta"),
                  "mask": torch.empty((B, 64), device="meta")}
        jbatch = {k: jax.ShapeDtypeStruct((B, 64), np.int32) for k in pbatch}
        assert _port_specs(disagg.specs_for_batch(base, pbatch, pm)) == \
            _jax_specs(jd.specs_for_batch(jbase, jbatch, jm))
        assert disagg.batch_axes(pm) == jd.batch_axes(jm)


def test_specs_are_one_entry_a_dim_and_placements_keep_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.disagg import P, placements
    from repro_torch.launch.mesh import AbstractMesh

    assert tuple(P(("data",), None)) == ("data", None)
    assert tuple(P((), "model")) == (None, "model")
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="not in mesh order"):
        placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="twice"):
        placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="not one of"):
        placements(P("attn"), mesh)


def test_partition_spec_and_abstract_mesh_store_what_jax_stores():
    from jax.sharding import PartitionSpec as JP

    from repro_torch.core.disagg import P
    from repro_torch.launch.mesh import AbstractMesh, mesh_axes

    for dims in ((), (None,), (("data",), None), ((), "model"),
                 (("pod", "data"), "model"), ("data", ("model",), None)):
        assert tuple(P(*dims)) == tuple(JP(*dims)), dims
    for shape, axes in MESHES:
        mesh = AbstractMesh(shape, axes)
        assert tuple(mesh.shape.items()) == \
            tuple(_jax_mesh(shape, axes).shape.items())
        assert tuple(mesh_axes(mesh)) == axes
    with pytest.raises(ValueError, match="differ in length"):
        AbstractMesh((16, 16), ("data",))


@pytest.mark.parametrize("attn_pool", [0, 2, 4])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_matches_the_reference(monkeypatch, multi_pod,
                                                     attn_pool):
    """The reference's shape and axes, read by recording what it passes to
    ``jax.make_mesh`` (patched in this test only)."""
    import jax

    from repro.launch import mesh as jmesh
    from repro_torch.launch.mesh import production_mesh_shape
    seen = []
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, axes, **kw: seen.append(
                            (tuple(shape), tuple(axes))))
    jmesh.make_production_mesh(multi_pod=multi_pod, attn_pool=attn_pool)
    assert [production_mesh_shape(multi_pod=multi_pod,
                                  attn_pool=attn_pool)] == seen


def test_production_mesh_refuses_an_attn_pool_that_does_not_divide_16():
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh
    with pytest.raises(ValueError, match="must divide 16"):
        jmesh.make_production_mesh(attn_pool=3)
    with pytest.raises(ValueError, match=r"attn_pool \(3\) must divide 16"):
        mesh.make_production_mesh(attn_pool=3)
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_test_mesh((2, 4), device_type="cpu")


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
def _batch(vocab: int):
    """Tokens, next-token labels and a mask with some positions off (the
    masked loss runs placed too)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, vocab, (4, 33)).astype(np.int32)
    return {"tokens": tokens[:, :32], "labels": tokens[:, 1:],
            "mask": (rng.random((4, 32)) > 0.25).astype(np.float32)}


def _part_mesh(inputs):
    from repro_torch.core.disagg import P, place, placements
    from repro_torch.launch import mesh as M

    res = {}
    for kw in ({}, {"multi_pod": True}, {"attn_pool": 4}):
        try:
            M.make_production_mesh(device_type="cpu", **kw)
        except ValueError as e:
            res[("production", tuple(kw.items()))] = str(e)
    mesh = M.make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
    pool = M.make_test_attn_pool_mesh(4, 2, device_type="cpu")
    res["axes"] = [dict(M.mesh_axes(mesh)), dict(M.mesh_axes(pool))]
    full = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    tree = {"a": full, "b": [full.T.contiguous()]}
    spec = {"a": P(("data", "model"), None), "b": [P(None, "model")]}
    placed = place(tree, spec, mesh)
    res["local_a"] = placed["a"].to_local().numpy()
    res["local_b"] = placed["b"][0].to_local().numpy()
    res["coords"] = (mesh.get_local_rank("data"),
                     mesh.get_local_rank("model"))
    res["round_trip"] = bool(torch.equal(placed["a"].full_tensor(), full))
    res["placements"] = [repr(p) for p in placements(spec["a"], mesh)]
    return res


def _part_train(inputs):
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.core import disagg
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import tree_leaves

    mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
    cfg = registry.get_smoke_config("llama3-8b", **TRAIN_OVERRIDES)
    params = torch.load(inputs, weights_only=False)
    state = opt.init_opt_state(params)
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(cfg.vocab_size).items()}
    pspecs = disagg.specs_for_params(cfg, params, mesh)
    p0 = disagg.place(params, pspecs, mesh)
    s0 = opt.OptState(disagg.place(state.step, disagg.P(), mesh),
                      disagg.place(state.mu, pspecs, mesh),
                      disagg.place(state.nu, pspecs, mesh))
    b0 = disagg.place(batch, disagg.specs_for_batch(cfg, batch, mesh), mesh)
    step = make_train_step(cfg, opt.AdamWConfig(lr=1e-3))
    p1, s1, m1 = step(p0, s0, b0)
    kept = all(
        isinstance(a, DTensor) and a.placements == b.placements
        for t0, t1 in ((p0, p1), (s0.mu, s1.mu), (s0.nu, s1.nu))
        for a, b in zip(tree_leaves(t1), tree_leaves(t0)))
    full = lambda x: x.full_tensor() if isinstance(x, DTensor) else x  # noqa
    return {"kept_placements": kept,
            "loss_is_placed": isinstance(m1["loss"], DTensor),
            "metrics": {k: float(full(v)) for k, v in m1.items()},
            "params": [full(x).numpy() for x in tree_leaves(p1)],
            "step": int(full(s1.step)),
            "sharded_leaves": sum(
                any(not p.is_replicate() for p in x.placements)
                for x in tree_leaves(p0))}


SERVE_MAX_SEQ = 48


def _serve_inputs(vocab: int):
    """The prompts and the next tokens of the placed serve steps."""
    rng = np.random.default_rng(2)
    return (rng.integers(0, vocab, (4, 24)).astype(np.int32),
            rng.integers(0, vocab, (4,)).astype(np.int32))


def _part_serve(inputs):
    """The placed prefill, then the dense-cache decode step over the cache
    placed at the head and at the seq partition (S over ``model``):
    logits, the step's new K/V, and the placements the cache kept."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.core import disagg
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map

    mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
    cfg = registry.get_smoke_config("llama3-8b", **TRAIN_OVERRIDES)
    params = torch.load(inputs, weights_only=False)
    prompts, nxt = (torch.as_tensor(a) for a in _serve_inputs(
        cfg.vocab_size))
    p0 = disagg.place(params, disagg.specs_for_params(cfg, params, mesh),
                      mesh)
    batch = {"tokens": prompts}
    b0 = disagg.place(batch, disagg.specs_for_batch(cfg, batch, mesh), mesh)
    full = lambda x: x.full_tensor() if isinstance(x, DTensor) else x  # noqa
    logits, cache = transformer.prefill(p0, cfg, b0, SERVE_MAX_SEQ,
                                        device="cpu")
    res = {"prefill_logits": full(logits).numpy(),
           "prefill_k": full(cache["k"]).numpy()}
    tok = disagg.place(nxt, disagg.specs_for_batch(
        cfg, {"t": nxt}, mesh)["t"], mesh)
    for part in ("head", "seq"):
        specs = disagg.specs_for_cache(cfg, cache, mesh, part)
        placed = tree_map(
            lambda t, spec: t.redistribute(mesh, disagg.placements(
                spec, mesh)) if isinstance(t, DTensor) else
            disagg.place(t, spec, mesh), cache, specs)
        lg, upd = transformer.decode_step(p0, cfg, tok, placed, device="cpu")
        res[part] = {"logits": full(lg).numpy(),
                     "k_new": full(upd["k_new"]).numpy(),
                     "v_new": full(upd["v_new"]).numpy(),
                     "cache_placements": [repr(p) for p in
                                          placed["k"].placements]}
    return res


FAMILY_ARCHS = ("zamba2-1.2b", "rwkv6-7b", "qwen3-moe-30b-a3b")


def _family_step(cfg, params, batch, mesh=None):
    """One train step; with a mesh, of the parameters, AdamW state and
    batch placed at the reference's specs."""
    from repro_torch.core import disagg
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    state = opt.init_opt_state(params)
    if mesh is not None:
        pspecs = disagg.specs_for_params(cfg, params, mesh)
        params = disagg.place(params, pspecs, mesh)
        state = opt.OptState(disagg.place(state.step, disagg.P(), mesh),
                             disagg.place(state.mu, pspecs, mesh),
                             disagg.place(state.nu, pspecs, mesh))
        batch = disagg.place(batch, disagg.specs_for_batch(cfg, batch, mesh),
                             mesh)
    return make_train_step(cfg, opt.AdamWConfig(lr=1e-3))(params, state,
                                                          batch)


def _part_families(inputs):
    """One placed train step of a hybrid, an ssm and a moe smoke config
    (the scans on each rank's batch and heads, the moe routing on each
    rank's token groups): the loss and the gradient norm."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer

    mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
    res = {}
    for arch in FAMILY_ARCHS:
        cfg = registry.get_smoke_config(arch)
        params = transformer.init_params(0, cfg, device="cpu")
        batch = {k: torch.as_tensor(v)
                 for k, v in _batch(cfg.vocab_size).items()}
        try:
            _, _, m = _family_step(cfg, params, batch, mesh)
        except Exception:
            res[arch] = {"error": traceback.format_exc()}
            continue
        full = lambda x: x.full_tensor() if isinstance(x, DTensor) else x  # noqa
        res[arch] = {k: float(full(v)) for k, v in m.items()}
        if cfg.family in ("ssm", "hybrid"):
            res[arch].update(_recurrent_serve(cfg, params, mesh))
    return res


def _recurrent_serve(cfg, params, mesh=None):
    """prefill -> decode_step of a recurrent smoke config (placed at the
    reference's specs when a mesh is given): the logits of both and the
    prefill's final states, as numpy."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core import disagg
    from repro_torch.models import transformer
    prompts, nxt = (torch.as_tensor(a) for a in _serve_inputs(
        cfg.vocab_size))
    batch = {"tokens": prompts}
    if mesh is not None:
        params = disagg.place(params, disagg.specs_for_params(
            cfg, params, mesh), mesh)
        batch = disagg.place(batch, disagg.specs_for_batch(cfg, batch, mesh),
                             mesh)
        nxt = disagg.place(nxt, disagg.specs_for_batch(
            cfg, {"t": nxt}, mesh)["t"], mesh)
    full = lambda x: x.full_tensor() if isinstance(x, DTensor) else x  # noqa
    with torch.no_grad():
        logits, cache = transformer.prefill(params, cfg, batch, SERVE_MAX_SEQ,
                                            device="cpu")
        if mesh is not None:
            specs = disagg.specs_for_cache(cfg, cache, mesh)
            cache = {k: v.redistribute(mesh, disagg.placements(specs[k], mesh))
                     if isinstance(v, DTensor) else
                     disagg.place(v, specs[k], mesh)
                     for k, v in cache.items()}
        lg, _ = transformer.decode_step(params, cfg, nxt, cache,
                                        device="cpu")
    state = "S" if cfg.family == "ssm" else "h"
    return {"prefill_logits": full(logits).numpy(),
            "state": full(cache[state]).numpy(), "logits": full(lg).numpy()}


PARTS = (("mesh", _part_mesh), ("train", _part_train),
         ("serve", _part_serve), ("families", _part_families))


def _rank_main(rank: int, world: int, store: str, out_dir: str,
               inputs: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    res = {}
    try:
        for name, part in PARTS:
            try:
                res[name] = part(inputs)
            except Exception:
                res[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def _jax_setup():
    import jax

    from repro.configs import registry as jreg
    from repro.models import transformer as jT
    cfg = jreg.get_smoke_config("llama3-8b", **TRAIN_OVERRIDES)
    params = jT.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    from repro_torch.configs import registry
    from repro_torch.models import transformer
    d = tmp_path_factory.mktemp("mesh_world")
    _, jparams = _jax_setup()
    cfg = registry.get_smoke_config("llama3-8b", **TRAIN_OVERRIDES)
    params = transformer.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    torch.save(params, d / "params.pt")
    mp.start_processes(_rank_main,
                       args=(WORLD, str(d / "store"), str(d),
                             str(d / "params.pt")),
                       nprocs=WORLD, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _part(world, name):
    for r, res in enumerate(world):
        assert "error" not in res[name], f"rank {r}:\n{res[name]['error']}"
    return [res[name] for res in world]


def test_production_mesh_refuses_a_world_of_another_size(world):
    for res in _part(world, "mesh"):
        assert "needs 256 ranks" in res[("production", ())]
        assert "has 8" in res[("production", ())]
        assert "needs 512 ranks" in res[("production",
                                         (("multi_pod", True),))]
        assert "needs 256 ranks" in res[("production",
                                         (("attn_pool", 4),))]


def test_test_meshes_have_the_reference_axes(world):
    for res in _part(world, "mesh"):
        assert res["axes"] == [{"data": 2, "model": 4},
                               {"model": 2, "attn": 4}]


def test_place_shards_a_dim_over_two_axes_in_jax_order(world):
    """P(("data", "model")) on rows: JAX gives device (i, j) row block
    i·4 + j (the spec's first axis outermost); DTensor must too."""
    full = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for res in _part(world, "mesh"):
        i, j = res["coords"]
        np.testing.assert_array_equal(res["local_a"],
                                      full[(i * 4 + j) * 2:(i * 4 + j + 1)
                                           * 2])
        np.testing.assert_array_equal(res["local_b"],
                                      full.T[:, j * 4:(j + 1) * 4])
        assert res["round_trip"]
        assert res["placements"] == ["Shard(dim=0)", "Shard(dim=0)"]


@pytest.fixture(scope="module")
def single_steps():
    """One train step of the port in one process and of the JAX reference,
    from the same parameters and batch."""
    import jax
    import jax.numpy as jnp

    from repro.training import optimizer as jopt
    from repro.training.train_loop import make_train_step as jstep
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import tree_leaves
    jcfg, jparams = _jax_setup()
    batch = _batch(jcfg.vocab_size)
    _, _, jm = jax.jit(jstep(jcfg, jopt.AdamWConfig(lr=1e-3)))(
        jparams, jopt.init_opt_state(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = registry.get_smoke_config("llama3-8b", **TRAIN_OVERRIDES)
    params = transformer.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    p1, _, m1 = make_train_step(cfg, opt.AdamWConfig(lr=1e-3))(
        params, opt.init_opt_state(params),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return (float(jm["loss"]), {k: float(v) for k, v in m1.items()},
            [x.numpy() for x in tree_leaves(p1)])


def test_placed_train_step_loss_matches_single_process_and_jax(world,
                                                               single_steps):
    jax_loss, port, _ = single_steps
    for res in _part(world, "train"):
        m = res["metrics"]
        assert np.isfinite(m["loss"])
        assert abs(m["loss"] - port["loss"]) < 1e-3
        assert abs(m["loss"] - jax_loss) < 1e-3
        assert abs(m["grad_norm"] - port["grad_norm"]) < 1e-4
        assert res["loss_is_placed"]


def test_placed_train_step_parameters_match_single_process(world,
                                                           single_steps):
    _, _, want = single_steps
    for res in _part(world, "train"):
        assert res["step"] == 1
        err = max(float(np.max(np.abs(a - b)))
                  for a, b in zip(res["params"], want))
        assert err < PARAM_TOL, err


def test_placed_train_step_keeps_every_leaf_placed(world):
    for res in _part(world, "train"):
        assert res["kept_placements"]
        assert res["sharded_leaves"] >= 8   # the step really is sharded


@pytest.fixture(scope="module")
def single_serve():
    """The single-process prefill and decode step of the same parameters,
    prompts and tokens."""
    import jax

    from repro_torch.configs import registry
    from repro_torch.models import transformer
    _, jparams = _jax_setup()
    cfg = registry.get_smoke_config("llama3-8b", **TRAIN_OVERRIDES)
    params = transformer.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    prompts, nxt = (torch.as_tensor(a) for a in _serve_inputs(
        cfg.vocab_size))
    with torch.no_grad():
        logits, cache = transformer.prefill(params, cfg, {"tokens": prompts},
                                            SERVE_MAX_SEQ, device="cpu")
        lg, upd = transformer.decode_step(params, cfg, nxt, cache,
                                          device="cpu")
    return {"prefill_logits": logits.numpy(), "prefill_k": cache["k"].numpy(),
            "logits": lg.numpy(), "k_new": upd["k_new"].numpy(),
            "v_new": upd["v_new"].numpy()}


def test_placed_prefill_matches_single_process(world, single_serve):
    for res in _part(world, "serve"):
        np.testing.assert_allclose(res["prefill_logits"],
                                   single_serve["prefill_logits"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["prefill_k"],
                                   single_serve["prefill_k"], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("part", ["head", "seq"])
def test_placed_decode_step_matches_single_process(world, single_serve,
                                                   part):
    """The decode step over a cache split by kv heads (no collective of
    K/V) or by sequence (each rank's slice, its partial psum-combined):
    logits and the new token's K/V at fp32 1e-5 of the single-process
    step; under the head split the first layer's new K/V bit for bit (a
    later layer's input has passed through the placed out-projections,
    whose partial sums add in another order)."""
    for res in _part(world, "serve"):
        got = res[part]
        assert got["cache_placements"] == (
            ["Shard(dim=1)", "Shard(dim=2)"] if part == "head" else
            ["Shard(dim=1)", "Shard(dim=3)"])
        np.testing.assert_allclose(got["logits"], single_serve["logits"],
                                   rtol=0, atol=1e-5)
        for key in ("k_new", "v_new"):
            np.testing.assert_allclose(got[key], single_serve[key], rtol=0,
                                       atol=1e-5)
            if part == "head":
                np.testing.assert_array_equal(got[key][0],
                                              single_serve[key][0])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_placed_train_step_of_each_family_matches_single_process(world,
                                                                 arch):
    """zamba2 / rwkv6 (the scans on each rank's shards, their gradients
    summed over the ranks that share an operand) and qwen3-moe (routing on
    each rank's token groups, the router's gradient summed): the placed
    step's loss and gradient norm equal the single-process step's."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    cfg = registry.get_smoke_config(arch)
    params = transformer.init_params(0, cfg, device="cpu")
    batch = {k: torch.as_tensor(v)
             for k, v in _batch(cfg.vocab_size).items()}
    _, _, want = _family_step(cfg, params, batch)
    for r, res in enumerate(_part(world, "families")):
        got = res[arch]
        assert "error" not in got, f"rank {r}:\n{got['error']}"
        assert abs(got["loss"] - float(want["loss"])) < 1e-4, got
        assert abs(got["grad_norm"] - float(want["grad_norm"])) < \
            1e-4 * max(1.0, float(want["grad_norm"])), got


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_placed_recurrent_serve_step_matches_single_process(world, arch):
    """The placed prefill (the scans and their closed-form final states on
    each rank's batch and heads) and decode step (rwkv6's recurrence on
    each rank's heads): logits and final states at fp32 1e-5 of the
    single-process steps."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    cfg = registry.get_smoke_config(arch)
    want = _recurrent_serve(cfg, transformer.init_params(0, cfg,
                                                         device="cpu"))
    for res in _part(world, "families"):
        got = res[arch]
        for key in ("prefill_logits", "state", "logits"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-5, err_msg=key)
