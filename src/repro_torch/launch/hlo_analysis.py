"""Per-device accounting of a traced step: FLOPs, bytes, memory and the
collectives it issues, and the roofline terms. Port of
``repro/launch/hlo_analysis.py``; the name is kept so a reader finds the
counterpart.

PyTorch has no post-SPMD HLO to parse. What it has is the program itself:
a step run on placed (DTensor) operands issues, on each rank, local aten
ops on its shards, the hand-written kernels (or their shape-only faces,
``kernels/_cuda.py``) and the collectives that DTensor's redistributions
and ``psum_combine`` call. :class:`LocalCounter` is a ``TorchDispatchMode``
that records these on ONE rank's local tensors:

  * FLOPs of every local op through ``torch.utils.flop_counter``'s
    registry (matrix products, convolutions, attention), plus each kernel
    call's FLOPs as its wrapper reports them;
  * bytes each op reads and writes (its tensor operands and results; view
    and metadata ops move none), plus each kernel's;
  * every ``c10d_functional`` / ``_c10d_functional`` / ``c10d``
    collective with its kind and local input bytes;
  * the live bytes of the storages the step allocates (a weak reference
    on each storage frees it from the count), whose peak is the step's
    temporary memory.

A call with a DTensor argument is not counted: the mode defers it to
DTensor, whose local ops then come back to the mode and are counted (a
DTensor-level call counted too would add the global work to the local:
``FlopCounterMode`` does so). The global-shape meta computation DTensor
runs to propagate a sharding is not counted either. So every number is
per device, as the reference's post-SPMD module gives them.

:func:`collective_bytes` sums a recorded trace by kind with the
reference's ring multipliers; :class:`RooflineTerms` turns per-chip FLOPs,
bytes and collective bytes into times at the H100's rates
(``core/costmodel.py`` ``HARDWARE["h100"]``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.costmodel import HARDWARE
from repro_torch.kernels import _cuda

_H100 = HARDWARE["h100"]
PEAK_FLOPS = _H100.flops             # bf16 / card
HBM_BW = _H100.mem_bw                # bytes/s / card
NVLINK_BW = _H100.ici_gbs * 1e9      # bytes/s / card, one direction
NIC_BW = _H100.net_gbs * 1e9         # bytes/s / card (400 Gb/s NIC)
HBM_BYTES = _H100.mem_bytes          # device memory / card

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# ring cost multiplier on operand bytes (per-device bytes on the wire)
_MULT = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}

# op name (after its namespace) -> collective kind
_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLL_NAMESPACES = ("c10d_functional", "_c10d_functional", "c10d")
# ops that read and write no tensor data
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
             "is_same_size", "device", "wait_tensor"}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(node))
        elif isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


@contextlib.contextmanager
def _mark_sharding_propagation(counter: "LocalCounter"):
    """Flag DTensor's sharding propagation, which runs the op on
    global-shape stand-ins and computes shard sizes with host tensors once
    per new op signature: none of it is the rank's work, so the counter
    skips what it calls. A strided shard's sizes are computed from a host
    index tensor (``_StridedShard.local_shard_size_and_offset``), which a
    fake mode would fake and then fail to read: it runs with the fake mode
    unset."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def flagged(orig, host=False):
        def run(*a, **kw):
            counter._meta_depth += 1
            try:
                if host:
                    with unset_fake_temporarily():
                        return orig(*a, **kw)
                return orig(*a, **kw)
            finally:
                counter._meta_depth -= 1
        return run

    patches = [(ShardingPropagator, name, False) for name in
               ("_propagate_tensor_meta_non_cached",
                "propagate_op_sharding_non_cached")
               if hasattr(ShardingPropagator, name)]
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and hasattr(strided,
                                       "local_shard_size_and_offset"):
        patches.append((strided, "local_shard_size_and_offset", True))
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in patches]
    for cls, name, host in patches:
        orig = cls.__dict__[name]
        if isinstance(orig, staticmethod):
            setattr(cls, name, staticmethod(flagged(orig.__func__, host)))
        else:
            setattr(cls, name, flagged(orig, host))
    try:
        yield
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


class LocalCounter(TorchDispatchMode):
    """One rank's FLOPs, bytes, collectives and live memory over the calls
    made while it is entered (module docstring). ``args`` are the step's
    inputs: their storages are counted in :attr:`argument_bytes`, not in
    the live count. Enter it inside ``FakeTensorMode`` for a trace, or
    alone around a real step: both count the same."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.kernel_calls: Dict[str, int] = {}
        self.collectives: List[Tuple[str, float, str, int]] = []
        self.ops = 0
        self._meta_depth = 0
        self._live: Dict[int, int] = {}       # storage key -> bytes
        self.live_bytes = 0
        self.peak_bytes = 0
        self._args = set()
        self.argument_bytes = 0
        for t in self._local(_tensors(args)):
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._args:
                self._args.add(key)
                self.argument_bytes += st.nbytes()
        self._stack = contextlib.ExitStack()

    @staticmethod
    def _local(ts):
        return [t._local_tensor if _is_dtensor(t) else t for t in ts]

    # -- kernel calls (rows 1-7, 6-bwd, 7-bwd), real or faces ------------
    def _kernel(self, entry: str, flops: float, nbytes: float) -> None:
        if self._meta_depth:
            return
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.kernel_calls[entry] = self.kernel_calls.get(entry, 0) + 1

    def __enter__(self):
        self._stack.enter_context(_mark_sharding_propagation(self))
        _cuda.ACCOUNTANTS.append(self._kernel)
        self._stack.callback(_cuda.ACCOUNTANTS.remove, self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    # -- live storages ----------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._args:
                continue
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            weakref.finalize(st, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(_is_dtensor(t) for t in ins):
            return NotImplemented        # DTensor issues the local ops
        out = func(*args, **kwargs)
        if self._meta_depth:
            return out
        self.ops += 1
        outs = _tensors(out)
        self._track(outs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _COLL_NAMESPACES:
            kind = _KIND.get(name)
            if kind is not None and ins:
                self.collectives.append(
                    (kind, float(sum(_nbytes(t) for t in ins)), str(func),
                     ins[0].untyped_storage()._cdata))
            return out
        if name in _NO_BYTES or func.is_view:
            return out
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.bytes += sum(_nbytes(t) for t in ins) + \
            sum(_nbytes(t) for t in outs)
        return out

    # -- results ----------------------------------------------------------
    @property
    def total_flops(self) -> float:
        return self.flops + self.kernel_flops

    @property
    def total_bytes(self) -> float:
        return self.bytes + self.kernel_bytes


def collective_bytes(record) -> Dict[str, float]:
    """Per-device collective bytes by kind, from a :class:`LocalCounter`
    (or its ``collectives`` list of (kind, local input bytes, op, input
    storage)): each collective's local input bytes times the ring
    multiplier ``_MULT``. ``count`` is the number of collectives;
    ``dedup_total`` counts a collective of one kind over the same input
    storage once, as the reference collapses repeats of one operand."""
    coll = getattr(record, "collectives", record)
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    out["count"] = 0
    seen: Dict[tuple, float] = {}
    for kind, nbytes, op, src in coll:
        b = nbytes * _MULT[kind]
        out[kind] += b
        out["count"] += 1
        seen.setdefault((kind, op, src), b)
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["dedup_total"] = float(sum(seen.values()))
    return out


@dataclasses.dataclass
class RooflineTerms:
    """All traced quantities are PER CHIP (counted on one rank's local
    tensors); model_flops is the GLOBAL analytic reference."""
    flops: float                # traced FLOPs per chip
    hbm_bytes: float            # traced bytes accessed per chip
    coll_bytes_per_chip: float  # per-chip collective bytes
    chips: int
    model_flops: float = 0.0    # global 6·N·D / 2·N·D reference

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> Optional[float]:
        total = self.flops * self.chips
        return self.model_flops / total if total else None

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "chips": self.chips, "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }
