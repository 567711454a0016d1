"""Model-attention disaggregation placement rules (paper §3,
§4). Port of ``repro/core/disagg.py``.

The paper's two device pools are two placement domains on a mesh:

  * dense weights: tensor-parallel over the ``model`` axis (Megatron-style
    column / row pairs), optionally FSDP over ``data`` for the 1T-param
    config;
  * KV caches and recurrent state, the "memory pool": batch over ``data``
    (and ``pod``), and the attention partition over the pool axis:
    ``head`` (the paper's choice), ``seq`` (partial-combine, for kv-head
    counts that do not divide the axis and batch-1 long context) or
    ``request`` (the rejected baseline).

The rules build a :class:`PartitionSpec` for every leaf: one entry a
tensor dim, each ``None``, an axis name or a tuple of axis names. They
take a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh`` and the port's
trees (dicts and lists of tensors, meta tensors included), walked by the
reference's path names (``layers/attn/wq``; a listed layout's index is a
path part). :func:`placements` maps a spec to DTensor placements and
:func:`place` distributes a tree: together they are the reference's
``NamedSharding`` + ``jax.device_put``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.common import ModelConfig
from repro_torch.tree import tree_map


class PartitionSpec:
    """How each tensor dim maps onto mesh axes: ``None`` (replicated), an
    axis name, or a tuple of axis names (the dim split over all of them,
    the first the outermost). An entry of one axis is stored as its name
    and an empty tuple as ``None``, as ``jax.sharding.PartitionSpec`` stores
    them. A leaf of a spec tree, not a sequence node of it
    (``repro_torch.tree`` walks tuples)."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(
            (d[0] if len(d) == 1 else d or None) if isinstance(d, tuple)
            else d for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self.dims == other.dims
        return NotImplemented

    def __repr__(self):
        return f"PartitionSpec{self.dims!r}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _div(n: int, shape, axis: str) -> bool:
    return axis in shape and n % shape[axis] == 0


def _map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()) -> Any:
    """``fn("a/b/0/c", leaf)`` over a tree of dicts and lists; the result
    keeps the tree's structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


# ---------------------------------------------------------------------------
# Parameter placement
# ---------------------------------------------------------------------------
def specs_for_params(cfg: ModelConfig, params, mesh,
                     fsdp: bool = False) -> Any:
    """A :class:`PartitionSpec` tree mirroring ``params`` (tensors of any
    device, meta included: only shapes are read)."""
    ms = mesh_axes(mesh)

    def rule(name, leaf) -> P:
        shape = tuple(leaf.shape)
        parts = name.split("/")
        stacked = name.startswith(("layers", "enc_layers", "tail"))
        # leading stacking dims (zamba2's mamba layers are (S, P, ...)),
        # less the listed layout's path indices ("layers/3/..." has none)
        lead = 0
        if stacked:
            lead = 1
            if name.startswith("layers") and cfg.family == "hybrid":
                lead = 2
            lead -= sum(1 for p in parts[1:3] if p.isdigit())
            lead = max(lead, 0)
        dims: list = [None] * len(shape)
        base = parts[-1]
        if name == "embed":
            if _div(shape[0], ms, "model"):
                dims[0] = "model"
            return P(*dims)
        if name == "lm_head":
            if _div(shape[1], ms, "model"):
                dims[1] = "model"
            return P(*dims)
        if len(shape) - lead < 2:  # norms, biases, scalars
            return P(*dims)

        if base in ("wq", "wk", "wv"):           # (..., d, H, hd)
            h_i = lead + 1
            if _div(shape[h_i], ms, "model"):
                dims[h_i] = "model"
            elif _div(shape[h_i + 1], ms, "model") and \
                    shape[h_i + 1] // ms["model"] >= 8:
                # kv heads that do not divide the axis: shard head_dim
                # rather than replicate the projections and their moments
                dims[h_i + 1] = "model"
            elif fsdp and _div(shape[lead], ms, "data"):
                dims[lead] = "data"
            if fsdp and dims[lead] is None and _div(shape[lead], ms, "data"):
                dims[lead] = "data"
            return P(*dims)
        if base == "wo":                          # (..., H, hd, d)
            if _div(shape[lead], ms, "model"):
                dims[lead] = "model"
            if fsdp and _div(shape[-1], ms, "data"):
                dims[-1] = "data"
            return P(*dims)
        if "moe" in name and base in ("w_gate", "w_up", "w_down"):
            # (..., E, d, f) expert-parallel over model
            if _div(shape[lead], ms, "model"):
                dims[lead] = "model"
            if fsdp and _div(shape[lead + 1], ms, "data"):
                dims[lead + 1] = "data"
            return P(*dims)
        if base in ("w_gate", "w_up", "w_fc"):    # (..., d, f) col-parallel
            if _div(shape[-1], ms, "model"):
                dims[-1] = "model"
            if fsdp and _div(shape[-2], ms, "data"):
                dims[-2] = "data"
            return P(*dims)
        if base in ("w_down", "w_proj"):          # (..., f, d) row-parallel
            if _div(shape[-2], ms, "model"):
                dims[-2] = "model"
            if fsdp and _div(shape[-1], ms, "data"):
                dims[-1] = "data"
            return P(*dims)
        if base == "router":
            return P(*dims)                       # small, replicated
        # generic 2D+ rule: last dim over model if divisible, else previous
        if _div(shape[-1], ms, "model"):
            dims[-1] = "model"
        elif _div(shape[-2], ms, "model"):
            dims[-2] = "model"
        if fsdp:
            for i in range(lead, len(shape)):
                if dims[i] is None and _div(shape[i], ms, "data"):
                    dims[i] = "data"
                    break
        return P(*dims)

    return _map_with_path(rule, params)


# ---------------------------------------------------------------------------
# Batch / cache / activation placement
# ---------------------------------------------------------------------------
def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry the global batch: ('pod', 'data') on multi-pod."""
    ms = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in ms)


def _batch_spec(B: int, mesh):
    """The batch axes that divide B, taken in mesh order while they do."""
    ms = mesh_axes(mesh)
    use, total = [], 1
    for a in batch_axes(mesh):
        if B % (total * ms[a]) == 0:
            use.append(a)
            total *= ms[a]
    return tuple(use) if use else None


def specs_for_batch(cfg: ModelConfig, batch: Dict, mesh) -> Dict:
    def rule(name, leaf):
        shape = tuple(leaf.shape)
        return P(_batch_spec(shape[0], mesh), *([None] * (len(shape) - 1)))

    return _map_with_path(rule, batch)


def specs_for_cache(cfg: ModelConfig, cache: Dict, mesh,
                    attention_partition: str = "auto") -> Dict:
    """The memory-pool placements (paper §5 "Attention parallelism").

    head: the KV head dim over ``model`` (needs divisibility); seq: the KV
    sequence dim over ``model`` (and a batch axis too when the batch cannot
    shard); auto: head if divisible, else seq.

    Handles the stacked layout ((L, B, Hkv, S, hd) buffers) and the listed
    one (paths like "k/3", the layer dims gone)."""
    ms = mesh_axes(mesh)
    baxes = batch_axes(mesh)

    def kv_fill(B, Hkv, S, rank):
        bs = _batch_spec(B, mesh)
        part = attention_partition
        if part == "auto":
            part = "head" if _div(Hkv, ms, "model") else "seq"
        fill = [bs] + [None] * (rank - 1)
        if part == "head" and _div(Hkv, ms, "model"):
            fill[1] = "model"
        elif _div(S, ms, "model"):
            fill[2] = "model"
            if bs is None:  # batch 1, long context: spread S wider
                extra = [a for a in baxes if S % (ms[a] * ms["model"]) == 0]
                if extra:
                    fill[2] = (extra[0], "model")
        return fill

    def rule(name, leaf):
        base = name.split("/")[0]
        shape = tuple(leaf.shape)
        if base == "len":
            return P(_batch_spec(shape[0], mesh))

        def dims_for(fill):
            """The spec of a leaf whose last len(fill) dims carry the
            semantics in ``fill`` (leading stacking dims None)."""
            return P(*([None] * (len(shape) - len(fill)) + fill))

        def model_if(n):
            return "model" if _div(n, ms, "model") else None

        if base in ("k", "v", "ck", "cv"):       # head-major (B, Hkv, S, hd)
            return dims_for(kv_fill(shape[-4], shape[-3], shape[-2], 4))
        if base in ("k_scale", "v_scale"):       # int8 scales (B, Hkv, S)
            return dims_for(kv_fill(shape[-3], shape[-2], shape[-1], 3))
        if base in ("k_new", "v_new"):           # (B, Hkv, hd)
            return dims_for([_batch_spec(shape[-3], mesh),
                             model_if(shape[-2]), None])
        if base in ("S", "h", "tail_h"):         # rwkv (B, H, P, P); mamba
            return dims_for([_batch_spec(shape[-4], mesh),  # (B, H, P, N)
                             model_if(shape[-3]), None, None])
        if base in ("conv", "tail_conv"):        # (B, K-1, ch)
            return dims_for([_batch_spec(shape[-3], mesh), None,
                             model_if(shape[-1])])
        if base in ("x_tm", "x_cm"):             # (B, d)
            return dims_for([_batch_spec(shape[-2], mesh),
                             model_if(shape[-1])])
        bs = _batch_spec(shape[0], mesh) if shape else None
        return P(bs, *([None] * (len(shape) - 1)))

    return _map_with_path(rule, cache)


def logits_spec(cfg: ModelConfig, mesh, batch: int) -> P:
    return P(_batch_spec(batch, mesh),
             "model" if _div(cfg.vocab_size, mesh_axes(mesh), "model")
             else None)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------
def placements(spec: P, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dim,
    ``Shard(d)`` where the spec puts that axis on tensor dim d, else
    ``Replicate()``. A mesh dim of size 1 is ``Replicate()`` whatever the
    spec says: the same layout (its one shard is the whole tensor), and
    DTensor refuses to reshape a size-1 tensor dim sharded over it (the
    decode entry at B = 1 on a (1, 1) mesh, where "data" divides B).

    A dim split over several axes is sharded by DTensor in mesh-dim order
    (the first mesh dim outermost) and by JAX in the spec's order; every
    spec of these rules lists them in mesh order, so any other order
    raises rather than silently transposing the shards."""
    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    seen = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of "
                                 f"the mesh's {tuple(names)}")
            if a in seen:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            seen.add(a)
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec} splits dim {d} over {axes}, not "
                             f"in mesh order {tuple(names)}: DTensor would "
                             f"lay the shards out in another order than JAX")
    return tuple(out)


def place(tree, spec_tree, mesh) -> Any:
    """``tree``'s tensors distributed on ``mesh`` at ``spec_tree``'s specs
    (every rank passes the same full tensors)."""
    return tree_map(lambda t, spec: distribute_tensor(
        t, mesh, placements(spec, mesh)), tree, spec_tree)
