"""The control fails the check: the reference itself, in float8, in the
program's place, comes out not correct by the verdict that passes the
program's sound runs, on three seeds. At the cells' own size this was read on
the card (PERF.md); here at a size a test run holds, on the CPU, and on
the card with the card's kernels (marked ``gpu``)."""
import json
import time

import pytest
import torch

import _tiny
from lamina_bench import bench, spec

LIMIT = 0.05      # the tiny cells' limit (test_lb_faults.py)
CELLS = ["tiny-glm.tiny-lamina-decode", "tiny-glm.tiny-chat-azure"]
SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


def readings(tmp_path, monkeypatch, name, seed, device, dims):
    _tiny.patch_registry(monkeypatch, dims)
    root = _tiny.make(tmp_path, limit=LIMIT, dims=dims)
    b = json.loads((root / "BENCHMARK.json").read_text())
    cell = spec.load_cell(name, b, root, base=root / "lamina_bench")
    res, lines = bench.run(cell, seed, 2.0, False, device, time.time(),
                           control=True)
    return res, lines


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(tmp_path, monkeypatch,
                                                name, seed):
    res, lines = readings(tmp_path, monkeypatch, name, seed, "cpu",
                          _tiny.TINY)
    assert res["correct"] is True, lines
    ctrl = res["checks"]["control_gap"]
    assert ctrl["limit"] == LIMIT
    assert ctrl["correct"] is False, ctrl


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card(cuda, tmp_path, monkeypatch, name):
    """The tiny cells through the card's kernels and graphs."""
    torch.cuda.reset_peak_memory_stats()
    res, lines = readings(tmp_path, monkeypatch, name, SEEDS[0], cuda,
                          _tiny.TINY_CUDA)
    assert res["correct"] is True, lines
    assert res["device"]["platform"] == "gpu"
    assert res["checks"]["control_gap"]["correct"] is False, lines
