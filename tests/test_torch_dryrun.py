"""The port's dry run (``configs/base.py`` ``input_specs``,
``launch/entrypoints.py``, ``launch/hlo_analysis.py``,
``launch/dryrun.py``, ``launch/roofline.py``) held against the JAX
reference and against hand counts.

One fake process group of 8 ranks (``torch.testing._internal.distributed.
fake_pg``, in this process, a module fixture) backs a (2, 4) ``"cpu"``
mesh; every trace runs under ``FakeTensorMode`` and allocates nothing.
The counters are held against hand counts: a sharded matmul's per-rank
FLOPs, a placed tree's argument bytes, a redistribute's collective bytes.
``run_one`` runs the reference's ``test_sharding.py:155`` case on the
port. The scans' shape-only faces are held against the reference's
``recurrence_corrections``, and a real CPU step's count against its fake
trace's."""
import json
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL = {"num_layers": 2, "vocab_size": 2048}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "").replace("dtype(", "").strip("')")


# ---------------------------------------------------------------------------
# input_specs and the unstacking functions (no process group needed)
# ---------------------------------------------------------------------------
def _flat(tree, leaves):
    return [(tuple(x.shape), _dtype_name(x.dtype)) for x in leaves(tree)]


def test_input_specs_match_the_reference_for_every_assigned_arch():
    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro_torch.configs import base, registry
    for arch in registry.ASSIGNED:
        for shape in registry.applicable_shapes(arch):
            cfg = registry.config_for_shape(arch, shape)
            jcfg = jreg.config_for_shape(arch, shape)
            got = base.input_specs(cfg, shape)
            want = jbase.input_specs(jcfg, shape)
            assert set(got) == set(want), (arch, shape)
            for key in want:
                g, w = got[key], want[key]
                if isinstance(w, dict):
                    assert set(g) == set(w), (arch, shape, key)
                    for k in w:
                        assert tuple(g[k].shape) == tuple(w[k].shape), \
                            (arch, shape, key, k)
                        assert _dtype_name(g[k].dtype) == \
                            _dtype_name(w[k].dtype), (arch, shape, key, k)
                        assert g[k].device.type == "meta"
                else:
                    assert tuple(g.shape) == tuple(w.shape)
                    assert _dtype_name(g.dtype) == _dtype_name(w.dtype)
            for S in (128, 4096, 32768, 524288):
                assert base.frontend_len(cfg, S) == \
                    jbase.frontend_len(jcfg, S), (arch, S)


UNSTACK_ARCHS = ("llama3-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b",
                 "rwkv6-7b", "seamless-m4t-medium", "pixtral-12b")


@pytest.mark.parametrize("arch", UNSTACK_ARCHS)
def test_unstacked_shapes_match_the_reference(arch):
    import jax

    from repro.configs import base as jbase
    from repro.configs import registry as jreg
    from repro.launch import entrypoints as jE
    from repro.models import transformer as jT
    from repro_torch.configs import base, registry
    from repro_torch.launch import entrypoints as E
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves
    cfg, jcfg = registry.get_config(arch), jreg.get_config(arch)
    jparams = jax.eval_shape(
        lambda: jT.init_params(jax.random.PRNGKey(0), jcfg))
    params = transformer.init_params(0, cfg, device="meta")
    got = E.unstack_params_shape(cfg, params)
    want = jE.unstack_params_shape(jcfg, jparams)
    assert isinstance(got["layers"], list)
    assert _flat(got, tree_leaves) == _flat(want, jax.tree.leaves)
    gcache = E.unstack_cache_shape(
        cfg, base.input_specs(cfg, "decode_32k")["cache"])
    wcache = jE.unstack_cache_shape(
        jcfg, jbase.input_specs(jcfg, "decode_32k")["cache"])
    assert set(gcache) == set(wcache)
    for k in wcache:
        assert _flat(gcache[k], tree_leaves) == \
            _flat(wcache[k], jax.tree.leaves), k


# ---------------------------------------------------------------------------
# the fake (2, 4) world
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh24():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_test_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_counter_flops_of_a_sharded_matmul_are_one_ranks(mesh24):
    """X (64, 1024) rows over data @ W (1024, 4096) columns over model:
    each rank multiplies its (32, 1024) by its (1024, 1024), the global
    FLOPs over the 8 ranks exactly (FlopCounterMode would add the global
    count to the local one)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.hlo_analysis import LocalCounter
    with FakeTensorMode():
        X = distribute_tensor(torch.empty(64, 1024, dtype=torch.bfloat16),
                              mesh24, [Shard(0), Replicate()],
                              src_data_rank=None)
        W = distribute_tensor(torch.empty(1024, 4096, dtype=torch.bfloat16),
                              mesh24, [Replicate(), Shard(1)],
                              src_data_rank=None)
        with LocalCounter((X, W)) as c:
            Y = X @ W
    assert c.flops == 2 * 64 * 1024 * 4096 / 8
    assert c.collectives == []
    assert tuple(Y.placements) == (Shard(0), Shard(1))
    # the bytes it read and wrote: the two local operands and its result
    assert c.bytes == 2 * (32 * 1024 + 1024 * 1024 + 32 * 1024)


def test_counter_argument_bytes_are_the_local_shards(mesh24):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import registry
    from repro_torch.core import disagg
    from repro_torch.launch.hlo_analysis import LocalCounter
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves, tree_map
    cfg = registry.get_smoke_config("llama3-8b")
    meta = transformer.init_params(0, cfg, device="meta")
    specs = disagg.specs_for_params(cfg, meta, mesh24)
    sizes = mesh_axes(mesh24)
    want = 0
    for t, spec in zip(tree_leaves(meta), tree_leaves(specs)):
        n = t.numel() * t.element_size()
        for entry in spec:
            for ax in (() if entry is None else
                       (entry,) if isinstance(entry, str) else entry):
                n //= sizes[ax]
        want += n
    with FakeTensorMode():
        placed = disagg.place(
            tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), meta),
            specs, mesh24)
        c = LocalCounter(placed)
    assert c.argument_bytes == want
    assert want < sum(t.numel() * t.element_size()
                      for t in tree_leaves(meta))


def test_counter_collective_bytes_of_a_redistribute(mesh24):
    """An all-gather over the 4 model ranks of a (B, d) bf16 tensor whose
    rows are split over them: each rank hands its (B/4, d) shard to one
    all-gather, counted at its bytes times the all-gather multiplier."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import hlo_analysis as H
    B, d = 64, 512
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(B, d, dtype=torch.bfloat16),
                              mesh24, [Replicate(), Shard(0)],
                              src_data_rank=None)
        with H.LocalCounter((x,)) as c:
            x.redistribute(mesh24, [Replicate(), Replicate()])
    got = H.collective_bytes(c)
    assert got["count"] == 1
    assert got["all-gather"] == B // 4 * d * 2 * H._MULT["all-gather"]
    assert got["total"] == got["all-gather"] == got["dedup_total"]


def test_collective_bytes_keys_and_multipliers_are_the_reference():
    from repro.launch import hlo_analysis as jH
    from repro_torch.launch import hlo_analysis as H
    assert H._MULT == jH._MULT
    assert H._COLLECTIVES == jH._COLLECTIVES
    assert set(H.collective_bytes([])) == set(jH.collective_bytes(""))


def test_roofline_terms_match_the_reference_but_for_the_constants():
    from repro.launch import hlo_analysis as jH
    from repro_torch.launch import hlo_analysis as H
    kw = dict(flops=3.2e14, hbm_bytes=7.5e11, coll_bytes_per_chip=4.1e10,
              chips=256, model_flops=5.0e16)
    got, want = H.RooflineTerms(**kw), jH.RooflineTerms(**kw)
    assert set(got.as_dict()) == set(want.as_dict())
    assert math.isclose(got.t_compute * H.PEAK_FLOPS,
                        want.t_compute * jH.PEAK_FLOPS, rel_tol=1e-12)
    assert math.isclose(got.t_memory * H.HBM_BW, want.t_memory * jH.HBM_BW,
                        rel_tol=1e-12)
    assert math.isclose(got.t_collective * H.NVLINK_BW,
                        want.t_collective * jH.ICI_BW, rel_tol=1e-12)
    assert got.useful_ratio == want.useful_ratio
    assert (H.PEAK_FLOPS, H.HBM_BW, H.NVLINK_BW, H.NIC_BW) == \
        (989e12, 3350e9, 450e9, 50e9)
    terms = {"compute": got.t_compute, "memory": got.t_memory,
             "collective": got.t_collective}
    assert got.dominant == max(terms, key=terms.get)


# ---------------------------------------------------------------------------
# run_one: the reference's test_sharding.py:155 on the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def records(mesh24, tmp_path_factory):
    from repro_torch.launch import dryrun, mesh as M
    out = tmp_path_factory.mktemp("dryrun")
    orig = M.make_production_mesh
    M.make_production_mesh = lambda multi_pod=False, device_type="cuda": \
        M.make_test_mesh((2, 4), ("data", "model"), device_type=device_type)
    try:
        recs = {shape: dryrun.run_one("tinyllama-1.1b", shape,
                                      multi_pod=False, mode="both",
                                      out_dir=str(out), overrides=SMALL,
                                      device="cpu")
                for shape in ("decode_32k", "prefill_32k", "train_4k")}
    finally:
        M.make_production_mesh = orig
    return recs, out


def test_dryrun_entry_small_mesh(records):
    recs, out = records
    for shape, rec in recs.items():
        assert rec["ok"], shape
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert rec["chips"] == 8
        assert rec["cost_method"] == "unrolled_full"
        assert rec["cost"]["flops_correction"] == 0.0
        assert rec["cost"]["bytes_correction"] == 0.0
        mem = rec["memory"]
        assert mem["per_chip_total"] == mem["argument_bytes"] + \
            mem["temp_bytes"]
        assert mem["fits_h100_80g"] == (mem["per_chip_total"] <=
                                        80 * (1 << 30))
        assert not any(rec["launches"].values())
        saved = json.loads((out / f"tinyllama-1.1b_{shape}_pod1.json")
                           .read_text())
        assert saved["entry"] == rec["entry"]
    # the entries the reference lowers, and the serve step's KV never moves
    assert recs["decode_32k"]["entry"].endswith("serve_step")
    assert recs["prefill_32k"]["entry"].endswith("prefill_step")
    assert recs["train_4k"]["entry"].endswith("train_step")
    # natural (8 microbatches) and listed (1) train passes: the same FLOPs
    tr = recs["train_4k"]
    assert math.isclose(tr["cost_natural"]["flops"],
                        tr["cost"]["flops_hlo"], rel_tol=1e-9)


def test_decode_trace_moves_no_kv(records):
    """The serve step's collectives are the small ones its placements need
    (the head partition: no (a, s, m) triple, no cache): each is far below
    one layer's local K/V."""
    recs, _ = records
    rec = recs["decode_32k"]
    kv_local = rec["memory"]["argument_bytes"] / 2
    assert rec["collectives"]["total"] < kv_local / 100


def test_roofline_tables_read_the_records(records):
    from repro_torch.launch import roofline
    recs, out = records
    loaded = roofline.load(str(out))
    assert len(loaded) == 3
    dry = roofline.dryrun_table(loaded)
    roof = roofline.roofline_table(loaded)
    assert len(dry) == 2 + 3 and len(roof) == 2 + 3
    assert all("tinyllama-1.1b" in row for row in dry[2:] + roof[2:])
    assert "fits H100 80G" in dry[0]
    cand = roofline.worst_candidates(loaded)
    assert cand[0].startswith("worst")


def test_extrapolated_cost_equals_the_full_trace(mesh24):
    """A layer-uniform program at 6 layers: traced at 1 and 2 layers and
    extended linearly, its FLOPs, bytes and collective bytes by kind equal
    the full trace's (``dedup_total`` counts an operand shared by every
    layer once, so it is not linear in the layers and is left out)."""
    from repro_torch.launch import dryrun
    ov = {"num_layers": 6, "vocab_size": 2048}
    _, full = dryrun.cost_pass("tinyllama-1.1b", "decode_32k", mesh24,
                               overrides=ov)
    _, ext = dryrun.cost_pass("tinyllama-1.1b", "decode_32k", mesh24,
                              overrides=ov, unit=1)
    assert ext["method"] == "extrapolated_u1"
    for key in ("flops", "bytes"):
        assert math.isclose(ext[key], full[key], rel_tol=1e-9), key
    for key, val in full["collectives"].items():
        if key == "dedup_total":
            continue
        assert math.isclose(ext["collectives"][key], val, rel_tol=1e-9,
                            abs_tol=1e-6), key


def test_run_one_restores_global_state(records):
    from repro_torch.models import common, moe
    assert common._ACT_CONSTRAINT is None
    assert moe._SHARDING_HOOK is None
    assert dist.is_initialized()        # the caller's group is left alone


def test_run_one_makes_and_destroys_its_own_group(monkeypatch, tmp_path,
                                                  mesh24):
    """Without a group, run_one makes a fake one of the mesh's size and
    destroys it; here the production shape is patched to (2, 4) and the
    module's group set aside for the call."""
    from repro_torch.launch import dryrun, mesh as M
    monkeypatch.setattr(M, "production_mesh_shape",
                        lambda multi_pod=False: ((2, 4), ("data", "model")))
    monkeypatch.setattr(
        M, "make_production_mesh",
        lambda multi_pod=False, device_type="cuda": M.make_test_mesh(
            (2, 4), ("data", "model"), device_type=device_type))
    seen = []
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(seen))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: seen.append(kw["world_size"]))
    destroyed = []
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a: destroyed.append(True))
    rec = dryrun.run_one("tinyllama-1.1b", "decode_32k", multi_pod=False,
                         mode="natural", out_dir=str(tmp_path),
                         overrides=SMALL, device="cpu")
    assert rec["ok"] and seen == [8] and destroyed == [True]


# ---------------------------------------------------------------------------
# the scans' faces and real = fake
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b"])
def test_scan_faces_count_the_reference_recurrence(arch):
    """A smoke prefill's scan calls (recorded on the CPU), each replayed on
    fake CUDA tensors through the wrapper's face: their FLOPs equal the
    reference's per-step recurrence term x B·S·L, so the port adds no
    recurrence correction; no kernel launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs import registry as jreg
    from repro.launch import analytic as jA
    from repro_torch.configs import registry
    from repro_torch.kernels import ops, rwkv6_scan, ssm_scan
    from repro_torch.launch.hlo_analysis import LocalCounter
    from repro_torch.models import ssm, transformer
    cfg = registry.get_smoke_config(arch)
    params = transformer.init_params(0, cfg, device="cpu")
    B, S = 2, 24
    calls = []
    name = "rwkv6_scan" if cfg.family == "ssm" else "ssm_scan"
    orig = getattr(ops, name)

    def record(*args):
        calls.append([(tuple(a.shape), a.dtype) for a in args])
        return orig(*args)

    setattr(ops, name, record)
    try:
        with torch.no_grad():
            transformer.prefill(params, cfg, {"tokens": torch.zeros(
                (B, S), dtype=torch.int32)}, S, device="cpu")
    finally:
        setattr(ops, name, orig)
    assert len(calls) == cfg.num_layers
    launches = (ssm_scan.ssm_scan.launches, rwkv6_scan.rwkv6_scan.launches)
    with FakeTensorMode():
        args = [[torch.empty(s, dtype=dt, device="cuda") for s, dt in c]
                for c in calls]
        with LocalCounter() as c:
            for a in args:
                orig(*a)
    assert (ssm_scan.ssm_scan.launches,
            rwkv6_scan.rwkv6_scan.launches) == launches
    jcfg = jreg.get_smoke_config(arch)
    corr = jA.recurrence_corrections(jcfg, "prefill_32k")
    shp = jA.INPUT_SHAPES["prefill_32k"]
    per_step = corr["flops"] / (jcfg.num_layers *
                                (shp.global_batch * shp.seq_len -
                                 shp.global_batch))
    assert c.kernel_flops == per_step * B * S * cfg.num_layers
    assert sum(c.kernel_calls.values()) == cfg.num_layers


def test_a_real_step_counts_as_its_fake_trace():
    """A smoke prefill and decode step on real CPU tensors counted by the
    same mode as their fake trace: FLOPs, bytes and peak bytes equal."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import LocalCounter
    from repro_torch.models import transformer
    cfg = registry.get_smoke_config("llama3-8b")
    params = transformer.init_params(0, cfg, device="cpu")
    tokens = torch.zeros((2, 16), dtype=torch.int32)

    def step(p, t):
        logits, cache = transformer.prefill(p, cfg, {"tokens": t}, 32,
                                            device="cpu")
        return transformer.decode_step(p, cfg, t[:, -1], cache,
                                       device="cpu")

    with torch.no_grad():
        with LocalCounter((params, tokens)) as real:
            step(params, tokens)
        fake = dryrun.trace(step, (params, tokens))
    assert real.total_flops == fake["flops"] > 0
    assert real.total_bytes == fake["bytes"] > 0
    assert real.peak_bytes == fake["temp_bytes"] > 0
    assert real.argument_bytes == fake["argument_bytes"]
    assert np.isfinite(real.total_flops)


def test_dryrun_cli_defaults_to_the_card():
    import argparse

    from repro_torch.launch import dryrun
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        ns = orig(self, argv, namespace)
        seen.update(vars(ns))
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            dryrun.main(["--arch", "tinyllama-1.1b", "--shape",
                         "decode_32k"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    assert seen["device"] == "cuda" and seen["mode"] == "both"
