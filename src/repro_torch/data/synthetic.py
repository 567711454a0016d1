"""Synthetic data pipeline: a deterministic Zipfian "language" with enough
local structure (bigram templates) that a model's loss visibly drops, with
sequence packing at document boundaries. Port of
``repro/data/synthetic.py``: the same numpy streams from the same seeds,
so the tokens, labels, masks and the frontend / frames stubs equal the
reference's bit for bit; the batches are torch tensors on ``device``.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch


class SyntheticCorpus:
    """Markov bigram corpus over a Zipf vocabulary."""

    def __init__(self, vocab_size: int, seed: int = 0,
                 branching: int = 8):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # each token deterministically prefers `branching` successors
        self.next_tokens = rng.integers(0, vocab_size,
                                        size=(vocab_size, branching))
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.start_p = p / p.sum()

    def document(self, rng: np.random.Generator, length: int) -> np.ndarray:
        doc = np.empty(length, np.int64)
        doc[0] = rng.choice(self.vocab, p=self.start_p)
        choices = rng.integers(0, self.next_tokens.shape[1], size=length)
        noise = rng.random(length)
        for i in range(1, length):
            if noise[i] < 0.1:  # 10% noise keeps entropy non-trivial
                doc[i] = rng.integers(0, self.vocab)
            else:
                doc[i] = self.next_tokens[doc[i - 1], choices[i]]
        return doc


def packed_batches(vocab_size: int, batch: int, seq_len: int,
                   seed: int = 0, doc_len_range=(64, 512),
                   frontend_shape=None, frames_shape=None,
                   dtype=None, device="cpu") -> Iterator[Dict]:
    """Yields {"tokens" (B, S) int32, "labels" (B, S) int32, "mask" (B, S)
    fp32} batches of packed documents on ``device``; with
    ``frontend_shape`` / ``frames_shape`` also the stub modality inputs
    "frontend" / "frames" (standard normal, in ``dtype``) of the vlm and
    audio paths."""
    corpus = SyntheticCorpus(vocab_size, seed)
    rng = np.random.default_rng(seed + 1)

    def put(a, dt=None):
        t = torch.from_numpy(a)
        return t.to(device=device, dtype=dt or t.dtype)

    while True:
        toks = np.empty((batch, seq_len), np.int32)
        mask = np.ones((batch, seq_len), np.float32)
        for b in range(batch):
            pos = 0
            while pos < seq_len:
                n = int(rng.integers(*doc_len_range))
                doc = corpus.document(rng, n)[: seq_len - pos]
                toks[b, pos:pos + len(doc)] = doc
                pos += len(doc)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1)
        mask[:, -1] = 0.0
        out = {"tokens": put(toks), "labels": put(labels),
               "mask": put(mask)}
        if frontend_shape is not None:
            out["frontend"] = put(rng.standard_normal(frontend_shape), dtype)
        if frames_shape is not None:
            out["frames"] = put(rng.standard_normal(frames_shape), dtype)
        yield out
