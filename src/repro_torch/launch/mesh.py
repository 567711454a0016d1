"""Mesh construction. Port of ``repro/launch/mesh.py``.

The reference builds ``jax.make_mesh`` meshes; here each mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process group,
which the caller initializes first with its backend, rank, world size and
rendezvous given explicitly (``torch.distributed.init_process_group``):
nothing here picks a backend or reads a cluster from the environment. The
device type is an argument too (``"cuda"`` by default, ``"cpu"`` for gloo
processes on the CPU). Functions, not module constants: importing this
module touches no process group.

:class:`AbstractMesh` is the counterpart of ``jax.sharding.AbstractMesh``:
axis names and sizes with no process group behind them, so the placement
rules of ``core/disagg.py`` run for the production shape without its 256
ranks.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class AbstractMesh:
    """Axis names and sizes only: ``.shape`` is an ordered axis -> size
    mapping, as ``jax.sharding.AbstractMesh.shape`` is. It has no process
    group, so it can describe the rules' inputs, not run a collective."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.shape = OrderedDict(zip(axes, (int(n) for n in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(self.shape)})"


def production_mesh_shape(*, multi_pod: bool = False, attn_pool: int = 0
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of the production mesh, the reference's rule:
    (data=16, model=16), with a leading ``pod=2`` axis on multi-pod; an
    attention pool of ``attn_pool`` ranks is carved out of ``model`` as a
    trailing ``attn`` axis (model shrinks to 16 // attn_pool), the memory
    devices of the paper's disaggregation. Requires 16 % attn_pool == 0."""
    if attn_pool:
        if 16 % attn_pool:
            raise ValueError(f"attn_pool ({attn_pool}) must divide 16")
        shape = ((2, 16, 16 // attn_pool, attn_pool) if multi_pod
                 else (16, 16 // attn_pool, attn_pool))
        axes = (("pod", "data", "model", "attn") if multi_pod
                else ("data", "model", "attn"))
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def _mesh(shape, axes, device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            "a DeviceMesh needs the default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) first")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, attn_pool: int = 0,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh (:func:`production_mesh_shape`) over the default
    process group, whose world size must be the mesh's size (256, or 512
    multi-pod): a wrong world size raises; the mesh never shrinks."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod,
                                        attn_pool=attn_pool)
    return _mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small mesh over the default process group (world size =
    prod(shape))."""
    return _mesh(shape, axes, device_type)


def make_test_attn_pool_mesh(n_pool: int = 4, model: int = 2, *,
                             device_type: str = "cuda") -> DeviceMesh:
    """The disaggregated mesh at test size: a ``model`` axis for the dense
    slices and an ``attn`` pool axis the paged KV blocks shard over."""
    return make_test_mesh((model, n_pool), ("model", "attn"),
                          device_type=device_type)


def mesh_axes(mesh) -> "OrderedDict[str, int]":
    """Axis name -> size of a ``DeviceMesh`` or an :class:`AbstractMesh`,
    in mesh-dim order."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the placement rules need a mesh with dim names")
    return OrderedDict(zip(names, mesh.shape))
