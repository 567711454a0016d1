"""One cell's code end to end on the CPU at a reduced size, with its
reference; a cell, a mix, a configuration and a metric added as new
files and entries only; the result line's shape."""
import json
import time

import pytest

import _tiny
from lamina_bench import bench, spec

CELLS = ["tiny-glm.tiny-lamina-decode", "tiny-glm.tiny-chat-azure"]


@pytest.fixture
def tree(tmp_path, monkeypatch):
    _tiny.patch_registry(monkeypatch)
    root = _tiny.make(tmp_path)
    return root, json.loads((root / "BENCHMARK.json").read_text())


def load(tree, name):
    root, b = tree
    return spec.load_cell(name, b, root, base=root / "lamina_bench")


def test_added_files_leave_the_benchmark_as_it_was(tree):
    """The tree's copy of every file the benchmark already had is byte
    for byte the benchmark's own: the tiny cells live in new files."""
    root, _ = tree
    for path in _tiny.BENCH.rglob("*"):
        if path.is_file() and "tests" not in path.parts and \
                "__pycache__" not in path.parts:
            rel = path.relative_to(_tiny.BENCH)
            assert (root / "lamina_bench" / rel).read_bytes() == \
                path.read_bytes(), rel


@pytest.mark.parametrize("name", CELLS)
def test_end_to_end_on_the_cpu(tree, name):
    cell = load(tree, name)
    res, lines = bench.run(cell, 2**31 + 5, 1.5, False, "cpu", time.time())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "host", "checks"]
    assert res["correct"] is True, lines
    assert res["attempted"] > 0 and res["failed"] == 0
    split = ".lamina" if "lamina" in name else ""
    want = {"output_tok_s" + split, "tbt_p95_ms" + split, "setup_s"}
    if "chat" in name:
        want.add("ttft_p90_ms")
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    check = res["checks"]["worst_gap"]
    assert set(check) == {"value", "limit"}
    assert lines[-1] == f"check worst_gap {check['value']} limit " \
                        f"{check['limit']}"
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_layer_metrics(tree, name):
    """With ``--trace 1`` the per-layer metrics come back; on the CPU
    those that read the device trace have nothing to read and are left
    out, and the added metric ``steps_run`` is there."""
    cell = load(tree, name)
    res, _ = bench.run(cell, 77, 1.0, True, "cpu", time.time())
    got = set(res["metrics"])
    split = ".lamina" if "lamina" in name else ""
    assert {m + split for m in ("decode_batch_mean", "step_ms_p50",
                                "graph_captures", "step_mfu")} | \
        {"steps_run"} <= got
    assert not got & {m + s for s in ("", ".lamina") for m in (
        "gemm_ms_per_step", "paged_decode_roofline", "device_idle_share",
        "paged_prefill_roofline")}
    assert ("handoff_wait_ms_p50" in got) == ("lamina" in name)
    assert ("admit_wait_ms_p50" in got) == ("chat" in name)
    assert 0 < res["metrics"]["step_mfu" + split]["value"] < 100


def test_same_seed_same_served_tokens(tree):
    """The program's output depends on the seed alone: two runs of one
    seed judge requests whose first served tokens agree."""
    from lamina_bench.drive import Driver
    cell = load(tree, CELLS[1])
    outs = []
    for _ in range(2):
        drv = Driver(cell, 123, "cpu")
        drv.setup(0)
        outs.append([list(sv.req.output) for sv in drv.clients])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("change", [
    lambda c: c.update(kv_channels=64),
    lambda c: c["as_run"].update(norm_eps=1e-5)], ids=["shape", "as_run"])
def test_config_mismatch_is_refused(tree, monkeypatch, change):
    """A published width, or a value the file says the port runs, that
    the port's registry does not hold is refused."""
    from lamina_bench.drive import ConfigMismatch, Driver
    cell = load(tree, CELLS[0])
    change(cell.config)
    with pytest.raises(ConfigMismatch):
        Driver(cell, 1, "cpu")
