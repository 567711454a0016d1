"""The one traffic generator: a closed loop over a fixed set of lengths.

A mix file (``traffic/<mix>.json``) gives log-normal prompt and output
lengths (mean, sigma, caps), the size of the set drawn from them and the
seed that draws it. The lengths and their order are the mix's own: every
run draws the same set from ``set_seed`` and walks it in the same order
(a fresh permutation, also from ``set_seed``, each time the set is used
up). The run's ``--seed`` draws what the requests hold: the token ids,
the handed-over first tokens and the KV templates' choice. So every seed
gives the same work in the same order, and as the engine's steps do not
depend on time, two runs' windows differ only by how fast the card took
the same steps. (An order drawn from ``--seed`` changed which long
requests shared a batch, and moved a 30 s window's tokens a second by
4-6 % from seed to seed on one H100.)

Each client's first request is a residual life, as a client met in
steady state would be: a request picked with probability proportional
to its output length, with an age drawn uniformly from the tokens it has
already produced; its context is its prompt plus that age and it has the
rest of its output to go.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def lognormal_lengths(rng, mean: float, n: int, sigma: float = 0.6,
                      lo: int = 1) -> np.ndarray:
    """Frozen copy of ``_lognormal_lengths`` in
    ``src/repro_torch/data/traces.py:40`` (the paper's Table 4 traces as
    log-normals): the same arithmetic, so the same ``rng`` state draws the
    same lengths."""
    mu = np.log(mean) - sigma ** 2 / 2.0
    out = rng.lognormal(mu, sigma, size=n).astype(np.int64)
    return np.maximum(out, lo)


def length_set(mix: Dict):
    """(prompts, outputs) of the mix's fixed set: drawn as
    ``data/traces.py:generate`` draws them (prompts, then outputs, from
    one ``default_rng(set_seed)``), then capped."""
    rng = np.random.default_rng(mix["set_seed"])
    n = mix["set_size"]
    p, o = mix["prompt"], mix["output"]
    prompts = lognormal_lengths(rng, p["mean"], n, p["sigma"], p["min"])
    outputs = lognormal_lengths(rng, o["mean"], n, o["sigma"], o["min"])
    return (np.minimum(prompts, p["max"]), np.minimum(outputs, o["max"]))


@dataclasses.dataclass
class RequestSpec:
    """One request as the generator makes it. ``context`` tokens are
    already known when it arrives (its prompt, plus its age for a first
    request); it is to end at ``out_len`` output tokens in all."""
    context: int
    out_len: int
    tokens: List[int]          # the context's token ids
    first_token: int           # handed over with a handoff's payload
    template: int              # KV template of a handoff's payload


class Stream:
    """Requests of ``mix``, their contents drawn from ``seed``."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix = mix
        self.vocab = vocab
        self.prompts, self.outputs = length_set(mix)
        self.order = np.random.default_rng([mix["set_seed"], 1])
        self.rng = np.random.default_rng(seed)
        self.templates = int(mix.get("kv_templates", 1))
        self._order: np.ndarray = np.empty(0, np.int64)
        self._pos = 0

    def _spec(self, context: int, out_len: int) -> RequestSpec:
        tokens = self.rng.integers(0, self.vocab, size=context).tolist()
        return RequestSpec(context=context, out_len=out_len, tokens=tokens,
                           first_token=int(self.rng.integers(0, self.vocab)),
                           template=int(self.rng.integers(0,
                                                          self.templates)))

    def next(self) -> RequestSpec:
        """The next request of the loop."""
        if self._pos == len(self._order):
            self._order = self.order.permutation(len(self.prompts))
            self._pos = 0
        i = self._order[self._pos]
        self._pos += 1
        return self._spec(int(self.prompts[i]), int(self.outputs[i]))

    def first(self) -> RequestSpec:
        """A client's first request, met at a uniform age of a request
        picked in proportion to its output length. At least two output
        tokens remain, so a handed-over request decodes at least once."""
        w = self.outputs.astype(np.float64)
        i = int(self.order.choice(len(w), p=w / w.sum()))
        out = int(self.outputs[i])
        age = int(self.order.integers(0, out - 1))
        return self._spec(int(self.prompts[i]) + age, out - age)
