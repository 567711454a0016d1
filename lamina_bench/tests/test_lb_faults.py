"""The check catches a broken timed path: the rest of a run (no look for
a card), at a reduced size on the CPU, with one fault planted in the
program underneath, comes out not correct. The tiny cells' limit, 0.05,
lies above every sound reading of them (at most 0.024 over 16 seeds) and
below each fault's."""
import json
import time

import pytest
import torch

import _tiny
from lamina_bench import bench, spec

LIMIT = 0.05
CELLS = ["tiny-glm.tiny-lamina-decode", "tiny-glm.tiny-chat-azure"]


def state_unchanged(monkeypatch):
    """A decode step that leaves the cache as it was: the new tokens'
    K/V are never written."""
    from repro_torch.serving.kvcache import PagedKVCache
    monkeypatch.setattr(PagedKVCache, "write_tokens",
                        lambda self, *a, **k: None)


def half_batch(monkeypatch):
    """Half of the decode batch left out: its rows take the mean of the
    other half's logits."""
    from repro_torch.serving.llm_engine import LLMEngine
    real = LLMEngine._decode_validated

    def broken(self, *a, **k):
        out = real(self, *a, **k)
        if out is None:
            return out
        logits, updates = out
        h = logits.shape[0] // 2
        if h:
            logits = logits.clone()
            logits[h:] = logits[:h].mean(dim=0, keepdim=True)
        return logits, updates
    monkeypatch.setattr(LLMEngine, "_decode_validated", broken)


def exchange_left_out(monkeypatch):
    """The attention pool's second worker's heads never come back."""
    from repro_torch.serving.worker_pool import AttentionWorkerPool
    real = AttentionWorkerPool.attend_paged

    def broken(self, q, *a, **k):
        out = real(self, q, *a, **k).clone()
        out[:, out.shape[1] // 2:] = 0
        return out
    monkeypatch.setattr(AttentionWorkerPool, "attend_paged", broken)


def token_altered(monkeypatch):
    """Every request's fourth output token is altered where it is
    sampled."""
    from repro_torch.serving.llm_engine import LLMEngine
    real = LLMEngine._sample

    def broken(self, reqs, logits):
        toks = real(self, reqs, logits).clone()
        for i, r in enumerate(reqs):
            if len(r.output) == 3:
                toks[i] = (toks[i] + 1) % logits.shape[-1]
        return toks
    monkeypatch.setattr(LLMEngine, "_sample", broken)


FAULTS = {"state_unchanged": (state_unchanged, CELLS),
          "half_batch": (half_batch, CELLS),
          "exchange_left_out": (exchange_left_out, CELLS[:1]),
          "token_altered": (token_altered, CELLS)}


@pytest.fixture
def tree(tmp_path, monkeypatch):
    _tiny.patch_registry(monkeypatch)
    root = _tiny.make(tmp_path, limit=LIMIT)
    return root, json.loads((root / "BENCHMARK.json").read_text())


def run(tree, name, seed):
    root, b = tree
    cell = spec.load_cell(name, b, root, base=root / "lamina_bench")
    torch.manual_seed(0)
    return bench.run(cell, seed, 1.5, False, "cpu", time.time())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tree, name):
    res, lines = run(tree, name, 31)
    assert res["correct"] is True, lines


@pytest.mark.parametrize("fault,name", [(f, c) for f, (_, cells) in
                                        FAULTS.items() for c in cells])
def test_fault_is_caught(tree, monkeypatch, fault, name):
    FAULTS[fault][0](monkeypatch)
    res, lines = run(tree, name, 31)
    assert res["correct"] is False, lines
    assert res["checks"]["worst_gap"]["value"] > LIMIT
