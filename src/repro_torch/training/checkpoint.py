"""Dependency-free checkpointing in the reference's file format. Port of
``repro/training/checkpoint.py``.

A checkpoint is ``ckpt_%08d.npz`` (one array ``leaf_i`` per leaf of
{"params": ..., "opt": OptState}, in ``jax.tree.flatten``'s order:
``repro_torch.tree.tree_leaves``) plus ``ckpt_%08d.json`` ({"dtypes",
"step", "num_leaves"}); a bf16 leaf is stored as its uint16 view under the tag
``__bf16__``. So a checkpoint written by either package restores in the
other. ``restore`` rebuilds the tree of a template, each leaf on its
template leaf's device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_unflatten

_BF16_TAG = "__bf16__"


def _to_numpy(leaf: torch.Tensor):
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16_TAG
    arr = t.numpy()
    return arr, str(arr.dtype)


def _tree(params, opt_state):
    tree = {"params": params}
    if opt_state is not None:
        tree["opt"] = opt_state
    return tree


def save(directory: str, params: Any, opt_state: Any = None,
         step: int = 0) -> str:
    """Write step ``step``'s checkpoint of ``params`` (and ``opt_state``)
    into ``directory``; returns its path without the suffix."""
    os.makedirs(directory, exist_ok=True)
    leaves = tree_leaves(_tree(params, opt_state))
    arrays, dtypes = {}, []
    for i, leaf in enumerate(leaves):
        arr, tag = _to_numpy(leaf)
        arrays[f"leaf_{i}"] = arr
        dtypes.append(tag)
    path = os.path.join(directory, f"ckpt_{step:08d}")
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"dtypes": dtypes, "step": step,
                   "num_leaves": len(leaves)}, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[5:13]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return max(steps) if steps else None


def restore(directory: str, template: Any, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``template`` ({"params": ..., "opt":
    ...}); each leaf lands on its template leaf's device. Returns (tree,
    step); the latest step when ``step`` is None."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}")
    with np.load(path + ".npz") as data, open(path + ".json") as f:
        meta = json.load(f)
        out = []
        for i, leaf in enumerate(tree_leaves(template)):
            arr = data[f"leaf_{i}"]          # a fresh array: no copy
            if meta["dtypes"][i] == _BF16_TAG:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(t.to(leaf.device))
    return tree_unflatten(template, out), step
