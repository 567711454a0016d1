"""Request-trace generator matching the paper's Table 4 production traces.
Port (a numpy-only copy) of ``repro/data/traces.py``: the same seed gives
the same prompts and generation lengths as the reference.

The real Azure/Kimi traces only expose sequence-length distributions (the
paper itself uses dummy tokens of the right lengths — §6 "Workloads"); we
generate synthetic traces with the published mean prompt/generation lengths
using log-normal length distributions (standard for LLM serving traces).
A `scale` knob shrinks lengths proportionally for CPU-scale engine runs
while preserving the prompt:generation ratios that drive the paper's
batch-size and throughput effects.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.serving.request import Request, SamplingParams


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    n_requests: int
    mean_prompt: float
    mean_gen: float


# paper Table 4
TRACES: Dict[str, TraceSpec] = {
    "azure-conv": TraceSpec("azure-conv", 19366, 1154.7, 211.1),
    "azure-code": TraceSpec("azure-code", 8819, 2047.8, 27.9),
    "kimi-conv": TraceSpec("kimi-conv", 12031, 12035.1, 342.6),
    "kimi-ta": TraceSpec("kimi-ta", 23608, 8560.0, 182.1),
}


def _lognormal_lengths(rng, mean: float, n: int, sigma: float = 0.6,
                       lo: int = 1) -> np.ndarray:
    mu = np.log(mean) - sigma ** 2 / 2.0
    out = rng.lognormal(mu, sigma, size=n).astype(np.int64)
    return np.maximum(out, lo)


def generate(trace: str, n_requests: int = 64, vocab_size: int = 1000,
             scale: float = 1.0, seed: int = 0,
             max_prompt: int = 0) -> List[Request]:
    spec = TRACES[trace]
    rng = np.random.default_rng(seed)
    prompts = _lognormal_lengths(rng, max(spec.mean_prompt * scale, 2),
                                 n_requests, lo=2)
    gens = _lognormal_lengths(rng, max(spec.mean_gen * scale, 4),
                              n_requests, lo=2)
    if max_prompt:
        prompts = np.minimum(prompts, max_prompt)
    reqs = []
    for p, g in zip(prompts, gens):
        toks = rng.integers(0, vocab_size, size=int(p)).tolist()
        reqs.append(Request(prompt=toks,
                            params=SamplingParams(max_new_tokens=int(g))))
    return reqs


def stats(trace: str, scale: float = 1.0) -> Dict[str, float]:
    spec = TRACES[trace]
    return {"mean_prompt": spec.mean_prompt * scale,
            "mean_gen": spec.mean_gen * scale,
            "n_requests": spec.n_requests}
