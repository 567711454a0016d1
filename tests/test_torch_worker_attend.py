"""``AttentionWorkerPool.attend`` — decode attention over a DENSE
head-major cache split across memory workers by head or by request — on
the port against the JAX package's (``serving/worker_pool.py:93``), on the
CPU: outputs, ``per_worker_kv_bytes``, the ``TransferLog`` after
``account=True`` and the head partition's divisibility guard, at the
llama3-8b smoke shape (G = 2) and at glm4-9b's G = 16. An int8 cache
(which the reference's ``attend`` does not take; its per-worker partial is
the reference's jnp int8 partial) through both partitions equals the
reference's ``decode_attention_combine`` with scales over the whole batch
and heads: the §4.2.2 combine is exact across workers.

Inputs are fp32 from numpy seeds. Tolerance 2e-5: fp32 attention over a
few dozen keys, sums in another order.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.serving.worker_pool import AttentionWorkerPool as JPool
from repro_torch.configs import registry as treg
from repro_torch.serving import AttentionWorkerPool, TransferLog
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)
SHAPES = {"llama3-8b": ("llama3-8b", dict(num_kv_heads=2)),
          "glm4-g16": ("glm4-9b", dict(num_heads=32, num_kv_heads=2))}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(cfg, seed, B=3, S=29, int8=False):
    rng = np.random.default_rng(seed)
    Hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    q = rng.standard_normal((B, cfg.num_heads, hd)).astype(np.float32)
    if int8:
        kc = rng.integers(-127, 128, size=(B, Hkv, S, hd)).astype(np.int8)
        vc = rng.integers(-127, 128, size=(B, Hkv, S, hd)).astype(np.int8)
    else:
        kc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
        vc = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    kn = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    vn = rng.standard_normal((B, Hkv, hd)).astype(np.float32)
    lens = np.array([S, 11, 1][:B], np.int32)
    ks = rng.uniform(0.002, 0.03, size=(B, Hkv, S)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, size=(B, Hkv, S)).astype(np.float32)
    return q, kc, vc, lens, kn, vn, ks, vs


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("partition,n", [("head", 2), ("request", 2),
                                         ("request", 3), ("head", 1)])
@pytest.mark.parametrize("sw,cap", [(0, 0.0), (9, 30.0)])
def test_attend_matches_reference(shape, partition, n, sw, cap):
    arch, kw = SHAPES[shape]
    jcfg = jreg.get_smoke_config(arch, **kw)
    tcfg = treg.get_smoke_config(arch, **kw)
    q, kc, vc, lens, kn, vn, _, _ = _inputs(jcfg, n + sw)
    jpool = JPool(jcfg, n_workers=n, partition=partition)
    tpool = AttentionWorkerPool(tcfg, n_workers=n, partition=partition)
    akw = dict(sliding_window=sw, logit_softcap=cap, account=True)
    want = jpool.attend(*map(jnp.asarray, (q, kc, vc, lens, kn, vn)), **akw)
    got = tpool.attend(*map(_t, (q, kc, vc, lens, kn, vn)), **akw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tpool.per_worker_kv_bytes == jpool.per_worker_kv_bytes
    assert isinstance(tpool.log, TransferLog)
    assert dataclasses.asdict(tpool.log) == dataclasses.asdict(jpool.log)
    # a second call without accounting: the log stays, the bytes grow
    tpool.attend(*map(_t, (q, kc, vc, lens, kn, vn)), sliding_window=sw,
                 logit_softcap=cap)
    jpool.attend(*map(jnp.asarray, (q, kc, vc, lens, kn, vn)),
                 sliding_window=sw, logit_softcap=cap)
    assert tpool.per_worker_kv_bytes == jpool.per_worker_kv_bytes
    assert dataclasses.asdict(tpool.log) == dataclasses.asdict(jpool.log)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("partition", ["head", "request"])
def test_attend_over_an_int8_cache_equals_the_unsplit_reference(shape,
                                                                partition):
    arch, kw = SHAPES[shape]
    jcfg = jreg.get_smoke_config(arch, **kw)
    tcfg = treg.get_smoke_config(arch, **kw)
    q, kc, vc, lens, kn, vn, ks, vs = _inputs(jcfg, 7, int8=True)
    want = jattn.decode_attention_combine(
        *map(jnp.asarray, (q, kc, vc, lens, kn, vn)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    pool = AttentionWorkerPool(tcfg, n_workers=2, partition=partition)
    got = pool.attend(*map(_t, (q, kc, vc, lens, kn, vn)), k_scale=_t(ks),
                      v_scale=_t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the reference formula: 2 · cache elements of the worker's slice · 2
    per = [2 * kc[:, :1].size * 2] * 2 if partition == "head" else \
        [2 * kc[:2].size * 2, 2 * kc[2:].size * 2]
    assert pool.per_worker_kv_bytes == per


def test_head_partition_needs_kv_heads_divisible_by_workers():
    cfg = treg.get_smoke_config("glm4-9b", num_heads=32, num_kv_heads=2)
    with pytest.raises(ValueError, match="divisible by workers"):
        AttentionWorkerPool(cfg, n_workers=4, partition="head")
    with pytest.raises(ValueError, match="unknown partition"):
        AttentionWorkerPool(cfg, n_workers=2, partition="layer")
    AttentionWorkerPool(cfg, n_workers=4, partition="request")
