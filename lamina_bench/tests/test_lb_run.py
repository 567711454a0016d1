"""``run.py`` without a card, and in a directory that holds only
``BENCHMARK.json`` and the benchmark's folder: a non-zero exit and no
result line."""
import shutil
import subprocess
import sys

import pytest

from _tiny import BENCH, ROOT


def run(cwd, script):
    return subprocess.run(
        [sys.executable, str(script), "--workload", "glm4-9b.chat-azure",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run(ROOT, BENCH / "run.py")
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "lamina_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path, tmp_path / "lamina_bench" / "run.py")
    assert out.returncode != 0
    assert out.stdout == ""
