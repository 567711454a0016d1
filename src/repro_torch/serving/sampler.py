"""Token sampling: greedy / temperature / top-k, per request.
Port of ``repro/serving/sampler.py``.

Greedy rows are exact (argmax, first index on ties, as in the reference).
Stochastic rows keep the reference's CONTRACT rather than its bits: token
``i`` of a request seeded ``s`` is drawn from a ``torch.Generator`` seeded by
:func:`request_seed`\\ ``(s, i)`` alone, so a request's stream is
independent of batch composition, admission order and preemption. The
reference draws from JAX's threefry ``fold_in(PRNGKey(s), i)``; the two
streams differ by design (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Sequence

import torch

_MASK64 = (1 << 64) - 1


def request_seed(seed: int, token_index: int) -> int:
    """64-bit generator seed for token `token_index` of a request seeded
    `seed` (splitmix64 over the pair, so nearby pairs do not collide)."""
    z = (seed * 0x9E3779B97F4A7C15 + token_index + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def request_generator(seed: int, token_index: int) -> torch.Generator:
    """The per-request, per-token CPU generator (see module docstring)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(request_seed(seed, token_index))
    return gen


def sample_per_request(logits: torch.Tensor,
                       generators: Sequence[torch.Generator],
                       temperatures: Sequence[float],
                       top_ks: Sequence[int]) -> torch.Tensor:
    """Per-request sampling. logits: (B, V); generators: one
    :func:`request_generator` per row; temperatures: (B,) (<= 0 → greedy
    for that row); top_ks: (B,) (0 → full softmax). Returns (B,) int64 on
    the CPU. Stochastic rows are drawn on the CPU from their own generator
    (the draw is device-independent)."""
    greedy = logits.argmax(dim=-1).cpu()
    temps = torch.as_tensor(temperatures, dtype=torch.float32)
    if bool((temps <= 0).all()):
        return greedy
    rows = logits.float().cpu()
    V = rows.shape[-1]
    out = greedy.clone()
    for i, (gen, t, k) in enumerate(zip(generators, temperatures, top_ks)):
        if t <= 0:
            continue
        scaled = rows[i] / max(float(t), 1e-6)
        if k > 0:
            cutoff = torch.sort(scaled, descending=True).values[min(k, V) - 1]
            scaled = torch.where(scaled < cutoff, -torch.inf, scaled)
        probs = torch.softmax(scaled, dim=-1)
        out[i] = torch.multinomial(probs, 1, generator=gen)[0]
    return out
