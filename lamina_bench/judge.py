"""Whether the served tokens are right: the reference re-runs a seeded
sample of the requests the window finished, the longest among them, over
each one's known context and its served tokens, and reads, at every
served token, the gap by which the token's reference logit lies below
the reference's best. Greedy decoding puts the best token first, so a
sound bfloat16 program misses it only where two logits lie within its
rounding; the widest such gap over the sample is the number compared.

A handed-over request's context is its payload: the reference reads the
template's K/V as a cache and recomputes the K/V of the served tokens
itself. A submitted request's context is its prompt: the reference runs
the whole prompt, so a wrong chunked prefill shows in the tokens after it.

The control puts the reference itself, in float8 (``precision="fp8"``),
in the program's place: at the same positions, the gap of the token the
float8 pass ranks first.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from lamina_bench.reference import model as ref


def sample(finished: List, seed: int, n: int) -> List:
    """The request with the most served tokens, then ``n - 1`` more drawn
    from ``seed`` (all of them where there are fewer)."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: len(finished[i].req.output))
    rest = [i for i in range(len(finished)) if i != longest]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [finished[longest]] + [finished[rest[i]] for i in sorted(pick)]


def _sequences(picked: List, arrival: str, prefix_of) -> List:
    seqs = []
    for sv in picked:
        out = list(sv.req.output)
        if arrival == "handoff":
            # output[0] came with the payload; output[j] is predicted by
            # the reference's row j - 1 (input output[j - 1])
            seqs.append(ref.Sequence_(tokens=out[:-1],
                                      start=sv.spec.context,
                                      prefix=prefix_of(sv.spec)))
        else:
            P = len(sv.spec.tokens)
            seqs.append(ref.Sequence_(tokens=list(sv.spec.tokens) + out[:-1],
                                      rows=range(P - 1, P - 1 + len(out))))
    return seqs


def _targets(picked: List, arrival: str) -> List[List[int]]:
    first = 1 if arrival == "handoff" else 0
    return [list(sv.req.output)[first:] for sv in picked]


def gaps(logits: torch.Tensor, targets: List[int]) -> torch.Tensor:
    """Per row: the best logit minus the target token's."""
    t = torch.as_tensor(targets, dtype=torch.long, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(1, t[:, None])[:, 0]


def judge(weights: Dict, dims: Dict, picked: List, arrival: str,
          prefix_of=None, control: bool = False) -> Dict:
    """The widest gap of the served tokens (``worst_gap``) over the
    ``picked`` requests, the number of tokens judged, and with
    ``control`` the widest gap of the float8 control's first choices."""
    seqs = _sequences(picked, arrival, prefix_of)
    targets = _targets(picked, arrival)
    logits = ref.forward(weights, dims, seqs)
    worst = max(float(gaps(lg, t).max()) for lg, t in zip(logits, targets))
    finite = all(bool(torch.isfinite(lg).all()) for lg in logits)
    out = {"worst_gap": worst, "tokens": sum(len(t) for t in targets),
           "requests": len(picked), "finite": finite}
    if control:
        ctrl = ref.forward(weights, dims, seqs, precision="fp8")
        out["control_gap"] = max(
            float(gaps(lg, c.argmax(dim=-1).tolist()).max())
            for lg, c in zip(logits, ctrl))
    return out


def verdict(result: Dict, limit: float) -> Optional[str]:
    """None when the served tokens pass, else why not."""
    if not result["requests"]:
        return "no request finished in the window"
    if not result["finite"]:
        return "the reference's logits are not finite"
    if not result["worst_gap"] <= limit:
        return (f"a served token's logit lies {result['worst_gap']} below "
                f"the reference's best (limit {limit})")
    return None
