"""The two sharding hooks of the port (``models/common.py``
``set_activation_constraint`` / ``constrain_activation``, ``models/moe.py``
``set_sharding_hook``) and ``launch/entrypoints.py``
``install_activation_constraint``, held against the JAX reference.

A stub hook on each side records every call of a smoke forward of each
family: the activation constraint must be called at the same sites, as
many times and on the same shapes, and the MoE hook must see the same
(shape, kind) sequence. Both packages run the listed layout (a Python loop
over layers on both sides; the reference's stacked layout traces a scan
body once) without remat (a ``jax.checkpoint`` body's Python runs once
per signature). The reference runs op by op with a Python callback, so nothing
in the JAX package changes. The installed constraint's placements are held
against the reference's ``PartitionSpec``, captured by stubbing
``jax.lax.with_sharding_constraint``."""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ("llama3-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b", "rwkv6-7b",
            "pixtral-12b", "seamless-m4t-medium")


def _listed(params, cfg, index, n_of):
    """The reference's listed layout of a stacked parameter tree:
    ``index(tree, i)`` picks layer i, ``n_of(tree)`` counts layers."""
    out = dict(params)

    def unstack(tree):
        return [index(tree, i) for i in range(n_of(tree))]

    if cfg.family == "hybrid":
        out["layers"] = [unstack(sup) for sup in unstack(params["layers"])]
        if "tail" in params:
            out["tail"] = unstack(params["tail"])
    else:
        out["layers"] = unstack(params["layers"])
    if "enc_layers" in params:
        out["enc_layers"] = unstack(params["enc_layers"])
    return out


def _batch(cfg, B=2, S=16):
    rng = np.random.default_rng(0)
    nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        nb["frames"] = rng.standard_normal((B, 24, cfg.d_model)).astype(
            np.float32)
    if cfg.modality == "vision":
        nb["frontend"] = rng.standard_normal((B, 8, cfg.d_model)).astype(
            np.float32)
    return nb


def _jax_calls(arch):
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.models import common as jcommon
    from repro.models import moe as jmoe
    from repro.models import transformer as jT
    # remat off: a jax.checkpoint body runs its Python once per signature
    cfg = jreg.get_smoke_config(arch).replace(dtype=jnp.float32,
                                              remat=False)
    params = jT.init_params(jax.random.PRNGKey(0), cfg)
    params = _listed(params, cfg,
                     lambda t, i: jax.tree.map(lambda a: a[i], t),
                     lambda t: jax.tree.leaves(t)[0].shape[0])
    acts, moes = [], []
    jcommon.set_activation_constraint(
        lambda x: (acts.append(tuple(x.shape)), x)[1])
    jmoe.set_sharding_hook(
        lambda x, kind: (moes.append((tuple(x.shape), kind)), x)[1])
    try:
        jT.forward(params, cfg, {k: jnp.asarray(v) for k, v in
                                 _batch(cfg).items()})
    finally:
        jcommon.set_activation_constraint(None)
        jmoe.set_sharding_hook(None)
    return acts, moes


def _port_calls(arch):
    from repro_torch.configs import registry
    from repro_torch.models import common, moe, transformer
    from repro_torch.tree import tree_leaves, tree_map
    cfg = registry.get_smoke_config(arch)
    params = transformer.init_params(0, cfg, device="cpu")
    params = _listed(params, cfg, lambda t, i: tree_map(lambda a: a[i], t),
                     lambda t: tree_leaves(t)[0].shape[0])
    acts, moes = [], []
    common.set_activation_constraint(
        lambda x: (acts.append(tuple(x.shape)), x)[1])
    moe.set_sharding_hook(
        lambda x, kind: (moes.append((tuple(x.shape), kind)), x)[1])
    try:
        with torch.no_grad():
            transformer.forward(params, cfg, {k: torch.from_numpy(v) for k, v
                                              in _batch(cfg).items()},
                                device="cpu")
    finally:
        common.set_activation_constraint(None)
        moe.set_sharding_hook(None)
    return acts, moes


@pytest.mark.parametrize("arch", FAMILIES)
def test_hooks_are_called_at_the_reference_sites(arch):
    j_acts, j_moes = _jax_calls(arch)
    p_acts, p_moes = _port_calls(arch)
    assert p_acts == j_acts
    assert p_moes == j_moes
    assert p_acts                          # every family pins activations
    if arch.startswith("qwen3"):
        kinds = [k for _, k in p_moes]
        assert kinds[:5] == ["tokens", "dispatch", "expert_tokens",
                             "expert_tokens", "dispatch"]


def test_hooks_are_identity_and_uninstalled_by_default():
    from repro_torch.models import common, moe
    x = torch.ones(2, 3, 4)
    assert common._ACT_CONSTRAINT is None and moe._SHARDING_HOOK is None
    assert common.constrain_activation(x) is x
    assert moe._shard(x, "tokens") is x


# ---------------------------------------------------------------------------
# install_activation_constraint on a fake (2, 4) mesh
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


def _reference_spec(jcfg, shape):
    """The reference constraint's PartitionSpec for an activation of
    ``shape`` on a (2, 4) mesh, captured from its
    ``with_sharding_constraint`` call (None: the activation is passed
    through unconstrained)."""
    import jax
    import jax.numpy as jnp

    from repro.launch import entrypoints as jE
    from repro.models import common as jcommon
    mesh = jax.sharding.AbstractMesh((2, 4), ("data", "model"))
    got = []
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = \
        lambda x, s: (got.append(tuple(s.spec)), x)[1]
    try:
        jE.install_activation_constraint(jcfg, mesh)
        jcommon.constrain_activation(jnp.zeros(shape, jnp.float32))
    finally:
        jax.lax.with_sharding_constraint = orig
        jcommon.set_activation_constraint(None)
    return got[0] if got else None


CONSTRAINT_SHAPES = [(8, 6, 512), (8, 6, 256), (3, 6, 512), (4, 5, 6, 1024),
                     (1, 6, 2048), (8, 6, 500), (8, 512)]


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_install_activation_constraint_matches_the_reference(arch, mesh24):
    """Residuals (B, S, d) and fused (B, X, S, d) intermediates: batch over
    data where it divides, d over model when d // 4 >= 128 (the reference's
    rule, the MoE family included); other ranks pass unchanged."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro.configs import registry as jreg
    from repro_torch.configs import registry
    from repro_torch.core.disagg import P, placements
    from repro_torch.launch.entrypoints import install_activation_constraint
    from repro_torch.models import common
    cfg = registry.get_config(arch)
    install_activation_constraint(cfg, mesh24)
    try:
        for shape in CONSTRAINT_SHAPES:
            want = _reference_spec(jreg.get_config(arch), shape)
            x = distribute_tensor(torch.zeros(shape), mesh24,
                                  [Replicate(), Replicate()])
            y = common.constrain_activation(x)
            if want is None:
                assert y is x, shape
                continue
            assert tuple(y.placements) == placements(P(*want), mesh24), \
                (shape, want, y.placements)
            assert y.shape == x.shape
        plain = torch.zeros(8, 6, 512)
        assert common.constrain_activation(plain) is plain
    finally:
        common.set_activation_constraint(None)
