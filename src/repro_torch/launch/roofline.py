"""Roofline report: the dry-run JSON records (``launch/dryrun.py``) as the
§Dry-run and §Roofline tables. Port of ``repro/launch/roofline.py``, at
the H100's rates (``launch/hlo_analysis.py``).

  python -m repro_torch.launch.roofline [--dir experiments/dryrun]
      [--candidates]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.launch.hlo_analysis import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                             PEAK_FLOPS)

SUGGESTIONS = {
    "compute": "shard more FLOPs (TP/EP) or cut redundant compute (remat "
               "policy, fused kernels)",
    "memory": "reduce bytes: fused attention (no KV up-repeat), narrower "
              "dtypes, better layouts",
    "collective": "reshard to cut boundary collectives (head- vs seq-"
                  "partition, overlap collectives with compute)",
}


def load(dir_: str) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def dryrun_table(recs: List[Dict]) -> List[str]:
    rows = ["| arch | shape | mesh | trace | mem/chip (GiB) | fits H100 80G | "
            "collectives/chip (nat) |",
            "|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"],
                                         x["multi_pod"])):
        mesh = "2x16x16" if r["multi_pod"] else "16x16"
        mem = r.get("memory", {})
        per = mem.get("per_chip_total")
        coll = r.get("collectives_natural", {}).get("total")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {mesh} | "
            f"{'OK' if r.get('ok') else 'FAIL'} | "
            f"{per/(1<<30):.2f} | {mem.get('fits_h100_80g')} | "
            f"{coll/1e6:.1f} MB |" if per is not None else
            f"| {r['arch']} | {r['shape']} | {mesh} | "
            f"{'OK' if r.get('ok') else 'FAIL'} | - | - | - |")
    return rows


def roofline_table(recs: List[Dict]) -> List[str]:
    rows = ["| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
            "dominant | MODEL_FLOPS | useful ratio | next move |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda x: (x["arch"], x["shape"])):
        if r.get("multi_pod") or "roofline" not in r:
            continue
        t = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{t['t_compute_s']*1e3:.3f} | {t['t_memory_s']*1e3:.3f} | "
            f"{t['t_collective_s']*1e3:.3f} | **{t['dominant']}** | "
            f"{t['model_flops']:.3g} | "
            f"{t['useful_ratio']:.3f} | {SUGGESTIONS[t['dominant']]} |")
    return rows


def worst_candidates(recs: List[Dict], k: int = 5) -> List[str]:
    scored = []
    for r in recs:
        if r.get("multi_pod") or "roofline" not in r:
            continue
        t = r["roofline"]
        tot = t["t_compute_s"] + t["t_memory_s"] + t["t_collective_s"]
        frac = t["t_compute_s"] / tot if tot else 0.0
        scored.append((frac, t["t_collective_s"] / max(tot, 1e-12), r))
    out = ["worst compute-fraction (hillclimb candidates):"]
    for frac, cfrac, r in sorted(scored, key=lambda x: x[0])[:k]:
        out.append(f"  {r['arch']} x {r['shape']}: compute-frac={frac:.4f} "
                   f"coll-frac={cfrac:.3f} dominant="
                   f"{r['roofline']['dominant']}")
    out.append("most collective-bound:")
    for frac, cfrac, r in sorted(scored, key=lambda x: -x[1])[:k]:
        out.append(f"  {r['arch']} x {r['shape']}: coll-frac={cfrac:.3f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--candidates", action="store_true")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print(f"## §Dry-run ({len(recs)} records; "
          f"H100: {PEAK_FLOPS/1e12:.0f} TF bf16, {HBM_BW/1e9:.0f} GB/s HBM, "
          f"{HBM_BYTES/(1 << 30):.0f} GiB, "
          f"{NVLINK_BW/1e9:.0f} GB/s NVLink)\n")
    print("\n".join(dryrun_table(recs)))
    print("\n## §Roofline (single-pod 16x16; per-chip traced terms)\n")
    print("\n".join(roofline_table(recs)))
    if args.candidates:
        print()
        print("\n".join(worst_candidates(recs)))


if __name__ == "__main__":
    main()
