"""The port's collective attention backends (``core/attention_parallel.py``)
and ``psum_combine`` held against the JAX reference's oracles, the port's
counterpart of ``tests/test_sharding.py:59, 84, 183, 231, 265``.

One world of 8 gloo processes (``torch.multiprocessing`` spawn, one
PyTorch thread each, rendezvous through a file in ``tmp_path``) runs every
backend once; each test reads its part of the world's results. Inputs are
made from seeds with numpy in the ranks and again here, where the JAX
oracles run on one device. No JAX runs in the ranks."""
import contextlib
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
TOL = 1e-4
BLOCK_KW = ({}, {"sliding_window": 23, "attention_sinks": 3},
            {"logit_softcap": 30.0})
PAGED_KW = ({}, {"sliding_window": 9, "attention_sinks": 2})


# ---------------------------------------------------------------------------
# inputs, made the same way in the ranks and in the test process
# ---------------------------------------------------------------------------
def _dense_inputs():
    rng = np.random.default_rng(0)
    B, S, H, Hkv, hd = 4, 64, 8, 4, 32
    return (rng.standard_normal((B, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, hd)).astype(np.float32),
            np.array([64, 17, 33, 50], np.int32))


def _paged_inputs(int8: bool):
    rng = np.random.default_rng(1)
    B, Hkv, G, hd, bs, nb = 4, 4, 2, 32, 8, 4
    NB = B * nb + 3
    q = rng.standard_normal((B, Hkv * G, hd)).astype(np.float32)
    bt = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    clen = np.array([32, 7, 20, 15], np.int32)
    if not int8:
        kp = rng.standard_normal((Hkv, NB, bs, hd)).astype(np.float32)
        vp = rng.standard_normal((Hkv, NB, bs, hd)).astype(np.float32)
        return q, kp, vp, bt, clen, None, None
    kp = rng.integers(-127, 128, (Hkv, NB, bs, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (Hkv, NB, bs, hd)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, (Hkv, NB, bs)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (Hkv, NB, bs)).astype(np.float32)
    return q, kp, vp, bt, clen, ks, vs


def _psum_inputs():
    rng = np.random.default_rng(2)
    B, H, hd, S = 3, 4, 16, 32
    return (rng.standard_normal((B, H, hd)).astype(np.float32),
            rng.standard_normal((B, H, S, hd)).astype(np.float32),
            rng.standard_normal((B, H, S, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------
class _Collectives:
    """What a rank hands to the collectives inside ``with c.window():``:
    the bytes of its ``torch.distributed.all_reduce`` calls (the only
    collective ``psum_combine`` issues) and, through ``CommDebugMode``,
    the count of every other collective it issues, functional ones
    included (DTensor's redistribute all-gathers and all-to-alls through
    them), so that a pool moved by DTensor would show."""

    def __init__(self):
        self.bytes = self.calls = self.others = 0
        orig = dist.all_reduce

        def counted(t, *a, **k):
            self.bytes += t.numel() * t.element_size()
            self.calls += 1
            return orig(t, *a, **k)
        dist.all_reduce = counted

    @contextlib.contextmanager
    def window(self):
        from torch.distributed.tensor.debug import CommDebugMode
        self.bytes = self.calls = 0
        with CommDebugMode() as mode:
            yield
        self.others = mode.get_total_counts() - self.calls

    def sent(self) -> dict:
        return {"bytes": self.bytes, "other_collectives": self.others}


def _placed(t, mesh, spec):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.disagg import placements
    return distribute_tensor(torch.as_tensor(t), mesh,
                             placements(spec, mesh), src_data_rank=None)


def _out(x):
    return {"out": x.full_tensor().numpy(),
            "placements": [repr(p) for p in x.placements]}


def _part_dense(counter):
    from repro_torch.core import attention_parallel as ap
    from repro_torch.core.disagg import P
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
    q, kc, vc, clen = map(torch.as_tensor, _dense_inputs())
    res = {}
    for name, fn, axis, kvspec, kw in (
            ("seq", ap.seq_parallel_decode_attention, "model",
             P("data", "model", None, None), {"batch_axis": "data"}),
            ("head", ap.head_parallel_decode_attention, "model",
             P("data", None, "model", None), {"batch_axis": "data"}),
            ("request", ap.request_parallel_decode_attention, "data",
             P("data", None, None, None), {})):
        kv = _placed(kc, mesh, kvspec), _placed(vc, mesh, kvspec)
        with counter.window():
            out = fn(mesh, axis, q, *kv, clen, **kw)
        res[name] = dict(_out(out), **counter.sent())
    return res


def _part_paged(counter):
    from repro_torch.core import attention_parallel as ap
    from repro_torch.core.disagg import P
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
    res = {}
    for int8 in (False, True):
        q, kp, vp, bt, clen, ks, vs = map(
            lambda a: None if a is None else torch.as_tensor(a),
            _paged_inputs(int8))
        for i, kw in enumerate(PAGED_KW):
            for name, axis, pspec, sspec, extra in (
                    ("head", "model", P("model", None, None, None),
                     P("model", None, None), {}),
                    ("head_batch", "model", P("model", None, None, None),
                     P("model", None, None), {"batch_axis": "data"}),
                    ("request", "data", P(), P(), {})):
                fn = (ap.request_parallel_paged_decode_attention
                      if name == "request"
                      else ap.head_parallel_paged_decode_attention)
                skw = {} if ks is None else dict(
                    k_scale=_placed(ks, mesh, sspec),
                    v_scale=_placed(vs, mesh, sspec))
                kv = _placed(kp, mesh, pspec), _placed(vp, mesh, pspec)
                with counter.window():
                    out = fn(mesh, axis, q, *kv, bt, clen, **kw, **extra,
                             **skw)
                res[(name, i, int8)] = dict(_out(out), **counter.sent())
    # the no-densify rule: a pool placed otherwise than the spec raises
    q, kp, vp, bt, clen, _, _ = map(
        lambda a: None if a is None else torch.as_tensor(a),
        _paged_inputs(False))
    errors, sent = {}, {}
    v_arg = _placed(vp, mesh, P("model"))
    for what, k_arg in (("replicated", _placed(kp, mesh, P())),
                        ("plain", kp)):
        with counter.window():
            try:
                ap.head_parallel_paged_decode_attention(
                    mesh, "model", q, k_arg, v_arg, bt, clen)
            except ValueError as e:
                errors[what] = str(e)
        sent[what] = counter.sent()
    res["misplaced"] = errors
    res["misplaced_sent"] = sent
    return res


def _block_cache(int8: bool):
    from repro_torch.configs import registry
    from repro_torch.serving.kvcache import PagedKVCache

    cfg = registry.get_smoke_config("llama3-8b")
    kv = PagedKVCache(cfg, num_blocks=64, block_size=8, n_shards=4,
                      kv_dtype="int8" if int8 else "bf16", device="cpu")
    kv.allocate(0, 200)   # long: spans every shard
    kv.allocate(1, 13)    # short: some shards hold nothing
    rng = np.random.default_rng(3 + int8)
    shape = kv.k_pool.shape[1:]
    if int8:
        pools = [rng.integers(-127, 128, shape).astype(np.int8)
                 for _ in range(2)]
        scales = [rng.uniform(0.002, 0.02, shape[:3]).astype(np.float32)
                  for _ in range(2)]
    else:
        pools = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2)]
        scales = [None, None]
    Hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    q = rng.standard_normal((2, cfg.num_heads, hd)).astype(np.float32)
    bt, lens = kv.block_table_batch([0, 1])
    lt, lp, st = kv.block_table_shards([0, 1])
    return dict(q=q, kp=pools[0], vp=pools[1], ks=scales[0], vs=scales[1],
                bt=np.asarray(bt), lens=np.asarray(lens), lt=lt, lp=lp, st=st,
                Hkv=Hkv)


def _part_block(counter):
    from repro_torch.core import attention_parallel as ap
    from repro_torch.core.disagg import P
    from repro_torch.launch.mesh import make_test_attn_pool_mesh

    mesh = make_test_attn_pool_mesh(4, 2, device_type="cpu")
    res = {}
    for int8 in (False, True):
        c = _block_cache(int8)
        pspec, sspec = P(None, "attn", None, None), P(None, "attn", None)
        skw = {} if c["ks"] is None else dict(
            k_scale=_placed(c["ks"], mesh, sspec),
            v_scale=_placed(c["vs"], mesh, sspec))
        kv = _placed(c["kp"], mesh, pspec), _placed(c["vp"], mesh, pspec)
        for i, kw in enumerate(BLOCK_KW):
            with counter.window():
                out = ap.block_parallel_paged_decode_attention(
                    mesh, "attn", torch.as_tensor(c["q"]), *kv,
                    torch.as_tensor(c["lt"]), torch.as_tensor(c["lp"]),
                    torch.as_tensor(c["lens"]), **kw, **skw)
            res[(i, int8)] = dict(_out(out), **counter.sent())
        res[("tables", int8)] = {k: c[k] for k in ("bt", "lens", "lt", "lp",
                                                   "st")}
    return res


def _part_psum(counter):
    from repro_torch.core import combine as C
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh((2, 4), ("data", "pool"), device_type="cpu")
    q, k, v = map(torch.as_tensor, _psum_inputs())
    n, S = 4, k.shape[2]
    Ss = S // n
    i = mesh.get_local_rank("pool")
    mask = torch.arange(S) < (S - Ss)      # shard 3's subset is empty
    sl = slice(i * Ss, (i + 1) * Ss)
    part = C.partial_attention(q, k[:, :, sl], v[:, :, sl], mask=mask[sl])
    before = [t.clone() for t in part]
    with counter.window():
        merged = C.psum_combine(part, mesh, "pool")
    res = dict(counter.sent(), out=C.finalize(merged).numpy(),
               unchanged=all(torch.equal(a, b)
                             for a, b in zip(part, before)))
    empty = C.partial_attention(q, k, v, mask=torch.zeros((S,), dtype=torch.bool))
    res["empty"] = C.finalize(C.psum_combine(empty, mesh, "pool")).numpy()
    return res


PARTS = (("dense", _part_dense), ("paged", _part_paged),
         ("block", _part_block), ("psum", _part_psum))


def _rank_main(rank: int, world: int, store: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    counter = _Collectives()
    res = {}
    try:
        for name, part in PARTS:
            try:
                res[name] = part(counter)
            except Exception:
                res[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("attention_parallel_world")
    mp.start_processes(_rank_main, args=(WORLD, str(d / "store"), str(d)),
                       nprocs=WORLD, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _part(world, name):
    for r, res in enumerate(world):
        assert "error" not in res[name], f"rank {r}:\n{res[name]['error']}"
    return [res[name] for res in world]


# ---------------------------------------------------------------------------
# the reference's oracles, on one device
# ---------------------------------------------------------------------------
def _paged_ref(q, kp, vp, bt, clen, ks=None, vs=None, **kw):
    import jax.numpy as jnp

    from repro.kernels import ref
    B, H, hd = q.shape
    Hkv = kp.shape[0]
    qg = jnp.asarray(q).reshape(B, Hkv, H // Hkv, hd)
    if ks is None:
        out = ref.paged_decode_attention_ref(
            qg, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
            jnp.asarray(clen), **kw)
    else:
        out = ref.paged_decode_attention_int8_ref(
            qg, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ks),
            jnp.asarray(vs), jnp.asarray(bt), jnp.asarray(clen), **kw)
    return np.asarray(out).reshape(B, H, hd)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", ["seq", "head", "request"])
def test_dense_splits_match_decode_attention_jnp(world, split):
    import jax.numpy as jnp

    from repro.models.attention import decode_attention_jnp
    q, kc, vc, clen = _dense_inputs()
    want = np.asarray(decode_attention_jnp(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(clen)))
    for res in _part(world, "dense"):
        np.testing.assert_allclose(res[split]["out"], want, atol=TOL,
                                   rtol=0)


def test_dense_splits_place_their_results_at_the_out_specs(world):
    res = _part(world, "dense")[0]
    assert res["seq"]["placements"] == ["Shard(dim=0)", "Replicate()"]
    assert res["head"]["placements"] == ["Shard(dim=0)", "Shard(dim=1)"]
    assert res["request"]["placements"] == ["Shard(dim=0)", "Replicate()"]


@pytest.mark.parametrize("case", range(len(PAGED_KW)),
                         ids=["plain", "window_sinks"])
@pytest.mark.parametrize("split", ["head", "head_batch", "request"])
def test_paged_head_and_request_splits_match_the_paged_oracle(world, split,
                                                              case):
    q, kp, vp, bt, clen, _, _ = _paged_inputs(False)
    want = _paged_ref(q, kp, vp, bt, clen, **PAGED_KW[case])
    for res in _part(world, "paged"):
        np.testing.assert_allclose(res[(split, case, False)]["out"], want,
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("case", range(len(PAGED_KW)),
                         ids=["plain", "window_sinks"])
@pytest.mark.parametrize("split", ["head", "head_batch", "request"])
def test_paged_splits_over_int8_pools_match_the_int8_oracle(world, split,
                                                           case):
    q, kp, vp, bt, clen, ks, vs = _paged_inputs(True)
    want = _paged_ref(q, kp, vp, bt, clen, ks, vs, **PAGED_KW[case])
    for res in _part(world, "paged"):
        np.testing.assert_allclose(res[(split, case, True)]["out"], want,
                                   atol=TOL, rtol=0)


def test_a_misplaced_pool_raises_and_moves_nothing(world):
    for res in _part(world, "paged"):
        assert set(res["misplaced"]) == {"replicated", "plain"}
        for msg in res["misplaced"].values():
            assert "never moves it" in msg
        for sent in res["misplaced_sent"].values():
            assert sent == {"bytes": 0, "other_collectives": 0}


def _reference_in_shard(c, kw, path: str):
    """The reference's block split on one device: each shard's partial by
    its jnp path or its Pallas kernel (interpret mode), merged by
    ``combine_many``."""
    import jax.numpy as jnp

    from repro.core import combine as JC
    from repro.kernels.ops import _triple_to_partial
    from repro.kernels.paged_decode_attention import paged_decode_attention
    from repro.models.attention import paged_decode_attention_partial_pos_jnp
    q = jnp.asarray(c["q"])
    B, H, hd = q.shape
    Hkv = c["kp"].shape[0]
    n = c["lt"].shape[0]
    npb = c["kp"].shape[1] // n
    clen = jnp.asarray(c["lens"])
    parts = []
    for s in range(n):
        sl = slice(s * npb, (s + 1) * npb)
        skw = {} if c["ks"] is None else dict(
            k_scale=jnp.asarray(c["ks"][:, sl]),
            v_scale=jnp.asarray(c["vs"][:, sl]))
        kp, vp = jnp.asarray(c["kp"][:, sl]), jnp.asarray(c["vp"][:, sl])
        lt, lp = jnp.asarray(c["lt"][s]), jnp.asarray(c["lp"][s])
        if path == "jnp":
            parts.append(paged_decode_attention_partial_pos_jnp(
                q, kp, vp, lt, lp, clen, window_total=clen, **kw, **skw))
        else:
            o, l, m = paged_decode_attention(
                q.reshape(B, Hkv, H // Hkv, hd), kp, vp, lt, clen,
                block_positions=lp, interpret=True, return_partials=True,
                **kw, **skw)
            parts.append(_triple_to_partial(o, l, m, B, H, hd))
    return np.asarray(JC.finalize(JC.combine_many(parts)))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", range(len(BLOCK_KW)),
                         ids=["plain", "window_sinks", "softcap"])
def test_block_split_matches_the_full_table_oracle(world, case, int8):
    c = _block_cache(int8)
    res = _part(world, "block")
    np.testing.assert_array_equal(res[0][("tables", int8)]["lt"], c["lt"])
    assert (c["st"].sum(1) > 0).all()     # the batch spans all 4 shards
    assert (c["st"] == 0).any()           # and some shard holds nothing
    kw = BLOCK_KW[case]
    want = _paged_ref(c["q"], c["kp"], c["vp"], c["bt"], c["lens"], c["ks"],
                      c["vs"], **kw)
    for r in res:
        np.testing.assert_allclose(r[(case, int8)]["out"], want, atol=TOL,
                                   rtol=0)
        assert r[(case, int8)]["placements"] == ["Replicate()"] * 2


@pytest.mark.parametrize("path", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("case", range(len(BLOCK_KW)),
                         ids=["plain", "window_sinks", "softcap"])
def test_block_split_matches_the_references_in_shard_paths(world, case,
                                                           path):
    c = _block_cache(False)
    want = _reference_in_shard(c, BLOCK_KW[case], path)
    for r in _part(world, "block"):
        np.testing.assert_allclose(r[(case, False)]["out"], want, atol=TOL,
                                   rtol=0)


def test_only_the_triple_crosses_ranks(world):
    """What a call hands to the collectives: the triple's bytes (fp32 a,
    s, m: B·H·(hd + 2)·4) to the all-reduces for the block and seq
    splits, none for head and request, and no other collective of any
    kind (``CommDebugMode``'s count less the all-reduces)."""
    B, H, hd = _dense_inputs()[0].shape
    for res in _part(world, "dense"):
        assert res["seq"]["bytes"] == (B // 2) * H * (hd + 2) * 4
        assert res["head"]["bytes"] == 0 and res["request"]["bytes"] == 0
        for split in ("seq", "head", "request"):
            assert res[split]["other_collectives"] == 0, split
    for res in _part(world, "paged"):
        for key, v in res.items():
            if isinstance(key, tuple):
                assert (v["bytes"], v["other_collectives"]) == (0, 0), key
    c = _block_cache(False)
    B, H, hd = c["q"].shape
    for res in _part(world, "block"):
        for key, v in res.items():
            if key[0] != "tables":
                assert v["bytes"] == B * H * (hd + 2) * 4, key
                assert v["other_collectives"] == 0, key


def test_psum_combine_matches_combine_many_incl_empty_shard(world):
    import jax.numpy as jnp

    from repro.core import combine as JC
    q, k, v = map(jnp.asarray, _psum_inputs())
    n, S = 4, k.shape[2]
    Ss = S // n
    mask = jnp.arange(S) < (S - Ss)
    parts = [JC.partial_attention(q, k[:, :, i * Ss:(i + 1) * Ss],
                                  v[:, :, i * Ss:(i + 1) * Ss],
                                  mask=mask[i * Ss:(i + 1) * Ss])
             for i in range(n)]
    assert not np.isfinite(np.asarray(parts[-1].m)).any()   # empty shard
    want = np.asarray(JC.finalize(JC.combine_many(parts)))
    B, H, hd = q.shape
    for res in _part(world, "psum"):
        np.testing.assert_allclose(res["out"], want, atol=1e-5, rtol=1e-5)
        assert res["unchanged"]                # works on copies
        assert res["bytes"] == B * H * (hd + 2) * 4
        assert res["other_collectives"] == 0


def test_psum_combine_of_all_empty_partials_stays_finite(world):
    for res in _part(world, "psum"):
        assert np.all(np.isfinite(res["empty"]))
        assert not res["empty"].any()


def test_backends_take_no_backend_or_interpret_argument():
    from repro_torch.core import attention_parallel as ap
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((2, 4), ("data", "model"))
    q, kp, vp, bt, clen, _, _ = _paged_inputs(False)
    for fn in (ap.head_parallel_paged_decode_attention,
               ap.request_parallel_paged_decode_attention):
        for kw in ({"backend": "pallas"}, {"interpret": True}):
            with pytest.raises(TypeError):
                fn(mesh, "model", q, kp, vp, bt, clen, **kw)
    with pytest.raises(TypeError):
        ap.block_parallel_paged_decode_attention(
            mesh, "model", q, kp, vp, bt[None], bt[None], clen,
            backend="jnp")


def test_head_splits_name_the_papers_divisibility_caveat():
    from repro_torch.core import attention_parallel as ap
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((2, 3), ("data", "model"))
    q, kp, vp, bt, clen, _, _ = _paged_inputs(False)
    with pytest.raises(ValueError, match=r"kv_heads \(4\) divisible by "
                       r"pool size \(3\) — paper §5; use block-level"):
        ap.head_parallel_paged_decode_attention(mesh, "model", q, kp, vp,
                                                bt, clen)
    q, kc, vc, clen = _dense_inputs()
    with pytest.raises(ValueError, match=r"paper §5; use seq-level"):
        ap.head_parallel_decode_attention(mesh, "model", q, kc, vc, clen)
