"""The benchmark's weights and KV templates, drawn on the device from the
run's seed in a few large calls, in the type they are served in.

The weights are laid out as ``repro_torch``'s dense stack reads them
(stacked on a leading layer axis): the program is handed them, and the
plain reference reads the same tensors. Projections are N(0, 1/fan_in)
with fan_in the contraction width, embeddings N(0, 1), and the RMSNorm
offsets N(0, 0.1) (the norms scale by 1 + w), so the reference checks the
norms' arithmetic too.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _layout(dims: Dict):
    """(path, shape, std) of every tensor, in the order they are drawn."""
    L, d = dims["num_layers"], dims["d_model"]
    H, Hkv, hd = dims["num_heads"], dims["num_kv_heads"], dims["head_dim"]
    ff, V = dims["d_ff"], dims["vocab_size"]

    def inv(n):
        return 1.0 / math.sqrt(n)
    return [
        (("embed",), (V, d), 1.0),
        (("final_norm",), (d,), 0.1),
        (("lm_head",), (d, V), inv(d)),
        (("layers", "norm1"), (L, d), 0.1),
        (("layers", "norm2"), (L, d), 0.1),
        (("layers", "attn", "wq"), (L, d, H, hd), inv(d)),
        (("layers", "attn", "wk"), (L, d, Hkv, hd), inv(d)),
        (("layers", "attn", "wv"), (L, d, Hkv, hd), inv(d)),
        (("layers", "attn", "wo"), (L, H, hd, d), inv(H * hd)),
        (("layers", "ffn", "w_gate"), (L, d, ff), inv(d)),
        (("layers", "ffn", "w_up"), (L, d, ff), inv(d)),
        (("layers", "ffn", "w_down"), (L, ff, d), inv(ff)),
    ]


def _fill(tree: Dict, dims: Dict, seed: int) -> Dict:
    """Draw the weights of ``seed`` into the tensors of ``tree``, one
    ``randn`` a tensor."""
    gen = None
    for path, _, std in _layout(dims):
        t = tree
        for k in path:
            t = t[k]
        if gen is None:
            gen = torch.Generator(device=t.device)
            gen.manual_seed(seed)
        torch.randn(t.shape, generator=gen, out=t)
        t.mul_(std)
    return tree


def make_weights(dims: Dict, seed: int, dtype, device) -> Dict:
    """The weights of a dense decoder of ``dims`` (the port's
    ``ModelConfig`` field names) from ``seed``."""
    tree: Dict = {}
    for path, shape, _ in _layout(dims):
        t = tree
        for k in path[:-1]:
            t = t.setdefault(k, {})
        t[path[-1]] = torch.empty(shape, dtype=dtype, device=device)
    return _fill(tree, dims, seed)


def make_kv_templates(dims: Dict, n_templates: int, n_blocks: int,
                      block_size: int, seed: int, dtype, device):
    """``n_templates`` K and V templates of ``n_blocks`` pool blocks, block
    major ``(T, n_blocks, L, Hkv, bs, hd)``, N(0, 1), drawn on the device
    one template at a time and kept in pinned host memory: a handoff's
    payload is a slice of one, never made per request."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (n_blocks, dims["num_layers"], dims["num_kv_heads"], block_size,
             dims["head_dim"])
    pin = torch.device(device).type == "cuda"
    out = []
    for _ in range(2):
        host = torch.empty((n_templates,) + shape, dtype=dtype,
                           pin_memory=pin)
        for t in range(n_templates):
            host[t].copy_(torch.randn(shape, generator=gen, dtype=dtype,
                                      device=device))
        out.append(host)
    return out[0], out[1]
