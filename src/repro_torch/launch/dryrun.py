"""Production-mesh dry run: the per-chip memory, FLOPs, bytes and
collectives of every entry point, proven without allocating anything.
Port of ``repro/launch/dryrun.py``.

For one (arch, shape) pair :func:`run_one`:
  1. builds the production mesh, (16, 16) or (2, 16, 16) with
     ``--multi-pod``, over a fake process group of that size in this one
     process (``torch.testing._internal.distributed.fake_pg``: every
     collective returns at once and moves nothing);
  2. traces the entry point (train_step / prefill_step / serve_step,
     ``launch/entrypoints.py``) once under ``FakeTensorMode``: parameters,
     optimizer state, batch and cache are fake tensors on the mesh's device
     type, placed at the reference's specs (``core/disagg.place``), so the
     step runs on DTensors whose local shards hold shapes only; on a
     ``"cuda"`` mesh every hand-written kernel is traced through its
     shape-only face (``kernels/_cuda.py``) and none launches;
  3. counts one rank's local work while it runs (``launch/hlo_analysis.py``
     ``LocalCounter``): live bytes (the memory record: arguments, outputs,
     the peak of the temporaries), FLOPs, bytes, and every collective the
     placements issue, outputs redistributed to their specs included;
  4. for ``--mode cost``, traces the listed layout (``unrolled``), the
     "heavy" configs at two depths extrapolated linearly in the layers;
  5. writes a JSON record under ``--out-dir`` that ``launch/roofline.py``
     turns into tables.

The kernels' faces count the scans' FLOPs call by call, so no
recurrence correction is added (the reference adds
``launch/analytic.py``'s, because XLA counts a rolled scan body once): the
record's ``flops_correction`` / ``bytes_correction`` stay 0.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k \\
      [--multi-pod] [--mode natural|cost|both] [--device cuda|cpu]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 7]
      (--jobs N: N records at once, each in a process of its own)

A run sets global state and restores it: the activation constraint is
uninstalled and the fake process group destroyed when it returns (a
process group the caller made is used and left alone).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as mesh_mod


def _kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch counter (real launches only)."""
    from repro_torch.kernels import (decode_attention as da,
                                     paged_decode_attention as pda,
                                     paged_prefill_attention as ppa,
                                     rwkv6_scan as rwkv, ssm_scan as ssm)
    fns = (pda.paged_decode_attention, pda.paged_decode_attention_int8,
           ppa.paged_prefill_chunk_attention,
           ppa.paged_prefill_chunk_attention_int8, da.decode_attention,
           da.decode_attention_int8, ssm.ssm_scan, ssm.ssm_scan_bwd,
           rwkv.rwkv6_scan, rwkv.rwkv6_scan_bwd)
    return {f.__name__: f.launches for f in fns}


def _storage_bytes(tensors) -> int:
    seen, n = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            n += st.nbytes()
    return n


def trace(fn, args, mesh=None, in_specs=None, out_specs=None, *,
          device: str = "cpu") -> Dict:
    """``fn(*args)`` traced once under ``FakeTensorMode`` and counted on
    one rank: ``args`` are trees of tensors of any device (meta included:
    only shapes, strides and dtypes are read), made fake on the mesh's
    device type and placed at the spec trees ``in_specs`` (without a mesh:
    fake tensors on ``device``, unplaced); the result is redistributed to
    ``out_specs`` when given. Returns the rank's ``argument_bytes``,
    ``output_bytes``, ``temp_bytes`` (the peak of live bytes above the
    arguments), ``flops``, ``bytes``, the ``collectives``
    (``hlo_analysis.collective_bytes``), the kernel calls and the ops
    counted. Nothing is allocated and no kernel launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.core.disagg import placements
    from repro_torch.tree import tree_leaves, tree_map

    dev = device if mesh is None else mesh.device_type

    def fake(t):
        return torch.empty_strided(tuple(t.shape), t.stride(), dtype=t.dtype,
                                   device=dev)

    def place(t, spec):
        return distribute_tensor(fake(t), mesh, placements(spec, mesh),
                                 src_data_rank=None)

    def settle(t, spec):
        if isinstance(t, DTensor):
            pl = placements(spec, mesh)
            if tuple(t.placements) != pl:
                return t.redistribute(mesh, pl)
        return t

    with FakeTensorMode():
        placed = tuple(tree_map(fake, a) for a in args) if mesh is None \
            else tuple(tree_map(place, a, s) for a, s in zip(args, in_specs))
        counter = hlo_analysis.LocalCounter(placed)
        with counter:
            out = fn(*placed)
            if out_specs is not None:
                out = tree_map(settle, out, out_specs)
        outs = [t._local_tensor if isinstance(t, DTensor) else t
                for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        return {"argument_bytes": counter.argument_bytes,
                "output_bytes": _storage_bytes(outs),
                "temp_bytes": counter.peak_bytes,
                "flops": counter.total_flops, "bytes": counter.total_bytes,
                "collectives": hlo_analysis.collective_bytes(counter),
                "kernel_calls": dict(counter.kernel_calls),
                "ops": counter.ops}


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks in this process (this one is
    rank 0), destroyed on exit; an initialized group is used as it is and
    left alone."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _traced(arch: str, shape: str, mesh, *, unrolled: bool, overrides,
            attention_partition: str):
    """(spec, :func:`trace` of the entry point): the activation
    constraint installed for the trace and uninstalled after it."""
    from repro_torch.launch.entrypoints import build_lowering_spec
    from repro_torch.models.common import set_activation_constraint
    spec = build_lowering_spec(arch, shape, mesh, unrolled=unrolled,
                               overrides=overrides,
                               attention_partition=attention_partition)
    try:
        return spec, trace(spec.fn, spec.args, mesh, spec.in_shardings,
                           spec.out_shardings)
    finally:
        set_activation_constraint(None)


def cost_pass(arch: str, shape: str, mesh, *, overrides=None,
              attention_partition: str = "auto", unit: Optional[int] = None,
              layers: Optional[int] = None):
    """The cost terms of the listed layout: (spec, {"flops", "bytes",
    "collectives", "method"}). With ``unit``, traced at u and 2u layers
    and extended linearly to ``layers`` (default: the config's depth;
    exact for layer-uniform programs, embedding and head in the base
    term), the reference's two-point extrapolation; else traced at full
    depth."""
    from repro_torch.launch.entrypoints import resolve_config
    kw = dict(unrolled=True, attention_partition=attention_partition)
    if unit is None:
        spec, c = _traced(arch, shape, mesh, overrides=overrides, **kw)
        return spec, {"flops": c["flops"], "bytes": c["bytes"],
                      "collectives": c["collectives"],
                      "method": "unrolled_full"}
    cfg0 = resolve_config(arch, shape, overrides=overrides)
    L = layers or cfg0.num_layers

    def at(n_layers):
        ov = dict(overrides or {})
        ov["num_layers"] = n_layers
        if cfg0.family == "audio":
            ov["encoder_layers"] = n_layers
        return _traced(arch, shape, mesh, overrides=ov, **kw)

    _, c1 = at(unit)
    spec, c2 = at(2 * unit)
    k = (L - unit) / unit   # units beyond the base trace

    def ext(a, b):
        return a + (b - a) * k

    coll = {kk: ext(c1["collectives"][kk], c2["collectives"][kk])
            for kk in c1["collectives"]}
    return spec, {"flops": ext(c1["flops"], c2["flops"]),
                  "bytes": ext(c1["bytes"], c2["bytes"]),
                  "collectives": coll, "method": f"extrapolated_u{unit}"}


def run_one(arch: str, shape: str, *, multi_pod: bool, mode: str,
            out_dir: str, attention_partition: str = "auto",
            overrides=None, tag: str = "", device: str = "cuda") -> dict:
    from repro_torch.configs import registry
    from repro_torch.launch import analytic
    from repro_torch.models.common import (resolve_device,
                                           set_activation_constraint)

    resolve_device(device)       # a "cuda" mesh needs the card's runtime
    mshape, _ = mesh_mod.production_mesh_shape(multi_pod=multi_pod)
    world = 1
    for n in mshape:
        world *= n
    record = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
              "mode": mode, "tag": tag,
              "attention_partition": attention_partition,
              "overrides": overrides or {}, "device": device}
    launches0 = _kernel_launches()
    t0 = time.time()
    with fake_world(world):
        try:
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                 device_type=device)
            chips = mesh.size()
            record["chips"] = chips

            # --- natural (stacked) layout: the memory proof -------------
            if mode in ("natural", "both"):
                spec, tr = _traced(arch, shape, mesh, unrolled=False,
                                   overrides=overrides,
                                   attention_partition=attention_partition)
                record["entry"] = spec.name
                per_chip = tr["argument_bytes"] + tr["temp_bytes"]
                record["memory"] = {
                    "argument_bytes": tr["argument_bytes"],
                    "output_bytes": tr["output_bytes"],
                    "temp_bytes": tr["temp_bytes"],
                    "generated_code_bytes": None,
                    "per_chip_total": per_chip,
                    "fits_h100_80g": bool(per_chip <=
                                          hlo_analysis.HBM_BYTES)}
                record["cost_natural"] = {"flops": tr["flops"],
                                          "bytes": tr["bytes"]}
                record["collectives_natural"] = tr["collectives"]
                record["kernel_calls_natural"] = tr["kernel_calls"]
                record["compile_s_natural"] = time.time() - t0

            # --- listed layout: the cost terms --------------------------
            if mode in ("cost", "both") and not multi_pod:
                t1 = time.time()
                cfg0 = registry.config_for_shape(arch, shape)
                unit = 2 if cfg0.local_global else (
                    cfg0.shared_attn_period if cfg0.family == "hybrid"
                    else 1)
                heavy = cfg0.num_layers * max(cfg0.d_model, 1) >= \
                    40 * 4096 or cfg0.num_experts >= 128 or \
                    cfg0.family in ("ssm", "hybrid")
                spec, c = cost_pass(
                    arch, shape, mesh, overrides=overrides,
                    attention_partition=attention_partition,
                    unit=unit if heavy and cfg0.num_layers > 4 * unit
                    else None, layers=cfg0.num_layers)
                terms = hlo_analysis.RooflineTerms(
                    flops=c["flops"], hbm_bytes=c["bytes"],
                    coll_bytes_per_chip=c["collectives"]["total"],
                    chips=chips,
                    model_flops=analytic.model_flops(spec.cfg, shape))
                record["entry"] = spec.name
                record["cost_method"] = c["method"]
                record["cost"] = {"flops_hlo": c["flops"],
                                  "bytes_hlo": c["bytes"],
                                  "flops_correction": 0.0,
                                  "bytes_correction": 0.0}
                record["collectives"] = c["collectives"]
                record["roofline"] = terms.as_dict()
                record["compile_s_cost"] = time.time() - t1
        finally:
            set_activation_constraint(None)

    after = _kernel_launches()
    record["launches"] = {k: after[k] - launches0[k] for k in after}
    record["ok"] = not any(record["launches"].values())
    record["total_s"] = time.time() - t0
    os.makedirs(out_dir, exist_ok=True)
    suffix = "pod2" if multi_pod else "pod1"
    if tag:
        suffix += f"_{tag}"
    path = os.path.join(out_dir, f"{arch}_{shape}_{suffix}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="both",
                    choices=["natural", "cost", "both"])
    ap.add_argument("--attention-partition", default="auto",
                    choices=["auto", "head", "seq"])
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides k=v (int/float parsed)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type: cuda traces the kernels' "
                         "faces; cpu their plain twins")
    ap.add_argument("--jobs", type=int, default=1,
                    help="records traced at once, each in a process of its "
                         "own (a trace runs on one core)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                overrides[k] = v

    from repro_torch.configs import registry

    combos = []
    if args.all:
        for arch in registry.ASSIGNED:
            for shape in registry.applicable_shapes(arch):
                combos.append((arch, shape))
    else:
        combos.append((args.arch, args.shape))

    if args.jobs > 1 and len(combos) > 1:
        keep, skip = [], False            # the flags every record shares
        for a in (argv if argv is not None else sys.argv[1:]):
            if skip:
                skip = False
            elif a in ("--arch", "--shape", "--jobs"):
                skip = True
            elif a != "--all":
                keep.append(a)
        return sweep([["--arch", a, "--shape", s, *keep] for a, s in combos],
                     args.jobs)
    torch.set_num_threads(1)
    failures = 0
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, multi_pod=args.multi_pod,
                          mode=args.mode, out_dir=args.out_dir,
                          attention_partition=args.attention_partition,
                          overrides=overrides or None, tag=args.tag,
                          device=args.device)
            r = rec.get("roofline", {})
            mem = rec.get("memory", {})
            print(f"{'OK ' if rec['ok'] else 'LAUNCHED'} {arch:24s} "
                  f"{shape:12s} chips={rec['chips']} "
                  f"mem/chip={mem.get('per_chip_total', 0)/(1<<30):.2f}GiB "
                  f"dominant={r.get('dominant', '-')} "
                  f"[{rec['total_s']:.0f}s]", flush=True)
            failures += not rec["ok"]
        except Exception:
            failures += 1
            print(f"FAIL {arch} {shape}", file=sys.stderr, flush=True)
            traceback.print_exc()
    return 1 if failures else 0


def sweep(runs, jobs: int) -> int:
    """Each record in a ``python -m repro_torch.launch.dryrun`` process of
    its own with the arguments in ``runs``, ``jobs`` at a time; their
    lines are printed as they end. Returns 1 if any failed. A terminated
    sweep ends its records' processes too."""
    import signal
    import subprocess
    todo = list(runs)
    running, failures = [], 0
    prev = signal.signal(signal.SIGTERM, lambda *a: sys.exit(143))
    try:
        while todo or running:
            while todo and len(running) < jobs:
                running.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     *todo.pop(0)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            done = [p for p in running if p.poll() is not None]
            if not done:
                time.sleep(0.2)
            for p in done:
                running.remove(p)
                print(p.stdout.read(), end="", flush=True)
                failures += p.returncode != 0
    finally:
        signal.signal(signal.SIGTERM, prev)
        for p in running:
            p.kill()
            p.wait()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
