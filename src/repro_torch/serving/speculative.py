"""Speculative decoding (paper §8 related work). Port of
``repro/serving/speculative.py``.

The greedy-exact variant: a cheap draft model proposes up to k tokens, one
pass of the target model over the whole sequence verifies them, and the
longest prefix the target's greedy choice agrees with is kept, followed by
the target's own next token. The output equals plain greedy decoding of
the target (held by the tests), with ``target_calls`` about
``tokens / (mean accepted + 1)``. Both models run
``transformer.forward`` on ``device`` (the card unless the caller asks for
the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class SpecStats:
    target_calls: int = 0
    draft_calls: int = 0
    proposed: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_target_call(self) -> float:
        return (self.accepted + self.target_calls) / max(self.target_calls, 1)


def _greedy_next(params, cfg: ModelConfig, seq: List[int],
                 device) -> torch.Tensor:
    """Logits (S, vocab) over the full prefix ``seq`` (a smoke-scale
    verify, as in the reference)."""
    with torch.inference_mode():
        return transformer.forward(params, cfg, {"tokens": [seq]},
                                   device=device)[0][0]


def speculative_generate(target_params, target_cfg: ModelConfig,
                         draft_params, draft_cfg: ModelConfig,
                         prompt: List[int], max_new_tokens: int,
                         k: int = 4, *, device="cuda"
                         ) -> Tuple[List[int], SpecStats]:
    """Greedy speculative decoding. Returns (generated tokens, stats)."""
    stats = SpecStats()
    seq = list(prompt)
    out: List[int] = []
    while len(out) < max_new_tokens:
        # the draft proposes up to k tokens autoregressively
        draft_seq = list(seq)
        proposal: List[int] = []
        for _ in range(min(k, max_new_tokens - len(out))):
            logits = _greedy_next(draft_params, draft_cfg, draft_seq, device)
            stats.draft_calls += 1
            tok = int(logits[-1].argmax())
            proposal.append(tok)
            draft_seq.append(tok)
        stats.proposed += len(proposal)

        # the target verifies the whole proposal in one pass; one host copy
        # of its greedy choices
        logits = _greedy_next(target_params, target_cfg, seq + proposal,
                              device)
        stats.target_calls += 1
        base = len(seq) - 1  # logits[base + i] predicts proposal[i]
        choice = logits[base:].argmax(-1).tolist()
        n_accept = 0
        for i, tok in enumerate(proposal):
            if choice[i] != tok:
                break
            n_accept += 1
        stats.accepted += n_accept
        # the target's own next token (correction, or bonus when all match)
        new_tokens = proposal[:n_accept] + [choice[n_accept]]
        out.extend(new_tokens)
        seq.extend(new_tokens)
    return out[:max_new_tokens], stats


def greedy_generate(params, cfg: ModelConfig, prompt: List[int],
                    max_new_tokens: int, *, device="cuda") -> List[int]:
    """Plain greedy reference."""
    seq = list(prompt)
    out: List[int] = []
    for _ in range(max_new_tokens):
        tok = int(_greedy_next(params, cfg, seq, device)[-1].argmax())
        out.append(tok)
        seq.append(tok)
    return out
