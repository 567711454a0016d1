"""The span readers (``lamina_bench/spans.py`` and its readers under
``metrics/``) on the tiny cells and on synthetic traces: a window the
recorder never ran in records no span, the program-span readers read a
recorded window, the device-trace readers read nothing on the CPU, no
existing reader's value moves, and the device-trace arithmetic on made-up
kineto events."""
import json
import math
from types import SimpleNamespace

import pytest

import _tiny
from lamina_bench import spans, spec
from lamina_bench.drive import Driver
from repro_torch.serving.trace import Span

CELLS = ["tiny-glm.tiny-lamina-decode", "tiny-glm.tiny-chat-azure"]
PROGRAM_SPAN = ("host_busy_ms_per_step", "decode_host_ms_per_step",
                "handoff_host_ms_per_step", "queue_wait_ms_p50")
DEVICE_TRACE = ("handoff_copy_ms_per_step", "idle_outside_step_share")
# every reader the benchmark had before the span readers
EXISTING = ("admit_wait_ms_p50", "decode_batch_mean", "device_idle_share",
            "gemm_ms_per_step", "graph_captures", "handoff_wait_ms_p50",
            "output_tok_s", "paged_decode_roofline",
            "paged_prefill_roofline", "setup_s", "step_mfu", "step_ms_p50",
            "tbt_p95_ms", "ttft_p90_ms")


@pytest.fixture(scope="module")
def engines_by_cell(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    _tiny.patch_registry(mp)
    root = _tiny.make(tmp_path_factory.mktemp("tree"))
    b = json.loads((root / "BENCHMARK.json").read_text())
    out = {}
    for name in CELLS:
        cell = spec.load_cell(name, b, root, base=root / "lamina_bench")
        drv = Driver(cell, 2**31 + 11, "cpu")
        drv.setup(0)
        out[name] = drv
    yield out
    for drv in out.values():
        drv.close()
    mp.undo()


def read(name, w):
    return spec.load_reader(name)(w)


@pytest.mark.parametrize("name", CELLS)
def test_a_window_without_the_recorder_records_no_span(engines_by_cell, name):
    drv = engines_by_cell[name]
    w = drv.window(0.5)
    assert w.steps and not drv.eng.trace.on
    assert drv.eng.trace.stop() == []
    assert not hasattr(w, "spans")
    for m in PROGRAM_SPAN + DEVICE_TRACE:
        assert read(m, w) is None, m


@pytest.mark.parametrize("name", CELLS)
def test_program_span_readers_read_a_recorded_window(engines_by_cell, name):
    drv = engines_by_cell[name]
    w = spans.window(drv, 1.0)
    assert not drv.eng.trace.on and w.spans
    assert sum(s.name == "step" for s in w.spans) == len(w.steps)
    got = {m: read(m, w) for m in PROGRAM_SPAN}
    lamina = "lamina" in name
    want = {"host_busy_ms_per_step", "decode_host_ms_per_step",
            "handoff_host_ms_per_step" if lamina else "queue_wait_ms_p50"}
    assert {m for m, v in got.items() if v is not None} == want, got
    for m in want:
        assert math.isfinite(got[m]) and got[m] > 0, (m, got[m])
    assert got["decode_host_ms_per_step"] < got["host_busy_ms_per_step"] \
        or lamina
    for m in DEVICE_TRACE:                       # no trace on the CPU
        assert read(m, w) is None
    cover = spans.coverage(w.spans)
    assert 0.5 < cover <= 1.0


@pytest.mark.parametrize("name", CELLS)
def test_existing_readers_read_the_same_with_spans_attached(engines_by_cell, name):
    drv = engines_by_cell[name]
    w = spans.window(drv, 0.5)
    w.setup_s = 1.0
    with_spans = {m: read(m, w) for m in EXISTING}
    del w.spans, w.queue_waits_s
    assert {m: read(m, w) for m in EXISTING} == with_spans
    assert with_spans["step_ms_p50"] > 0


# ---------------------------------------------------------------------
# synthetic traces
def _ev(kind, start_us, end_us, corr, name="k", annotation=False):
    from torch.autograd import DeviceType
    dt = DeviceType.CUDA if kind == "dev" else DeviceType.CPU
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: int(start_us * 1e3),
        duration_ns=lambda: int((end_us - start_us) * 1e3),
        device_type=lambda: dt, correlation_id=lambda: corr,
        is_user_annotation=lambda: annotation)


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _spans():
    """Two steps (us): step 1 at [0, 1000] with a transfer [10, 60] and a
    decode run [100, 900] holding its validate wait [300, 900]; step 2 at
    [1100, 2000], its run [1150, 1990] with the wait [1200, 1990]."""
    us = 1000
    rows = [("step", 0, 1000, -1, 1), ("step.handoff", 5, 70, 0, 1),
            ("handoff.transfer", 10, 60, 1, 1),
            ("step.decode", 90, 950, 0, 1), ("decode.run", 100, 900, 3, 1),
            ("wait.validate", 300, 900, 4, 1),
            ("step", 1100, 2000, -1, 2), ("step.decode", 1120, 1995, 6, 2),
            ("decode.run", 1150, 1990, 7, 2),
            ("wait.validate", 1200, 1990, 8, 2)]
    return [Span(n, a * us, b * us, p, st, -1, 0, 0)
            for n, a, b, p, st in rows]


def test_summarize_puts_gaps_copies_and_kernels_down_to_spans():
    events = [
        _ev("cpu", 20, 25, 1, "cudaMemcpyAsync"),   # in handoff.transfer
        _ev("dev", 30, 80, 1, "Memcpy HtoD"),
        _ev("cpu", 200, 210, 2, "cudaGraphLaunch"),  # in decode.run
        _ev("dev", 215, 880, 2),
        _ev("cpu", 1160, 1170, 3, "cudaGraphLaunch"),
        _ev("dev", 1180, 1995, 3),                   # 5 us late
        _ev("dev", 1180, 1190, 9, "annotation", annotation=True),
        _ev("cpu", 1300, 1310, 0, "cudaStreamSynchronize"),  # launches none
        _ev("dev", 40, 50, 0, "Memset"),                     # no launcher
        _ev("cpu", 1155, 1158, 4, "cudaMemcpyAsync"),        # in decode.run
        _ev("dev", 500, 501, 4, "Memcpy HtoD")]     # placed before its call
    out = spans.summarize(_prof(events), _spans())
    # gaps: [80, 215] (innermost at 147.5: decode.run) and [880, 1180]
    # (at 1030: no step open; 100 us of it lies outside both steps)
    assert dict(out["idle_by_span"]) == pytest.approx(
        {"decode.run": 135e-6, spans.OUTSIDE: 300e-6})
    assert out["idle_s"] == pytest.approx(435e-6)
    assert out["idle_outside_step_s"] == pytest.approx(100e-6)
    assert dict(out["call_s_by_span"]) == pytest.approx(
        {"handoff.transfer": 5e-6, "decode.run": 23e-6,
         "wait.validate": 10e-6})
    assert out["handoff_copy_s"] == pytest.approx(50e-6)
    assert out["handoff_spans"] == 1
    clock = out["clock"]
    assert (clock["steps"], clock["within_50us"]) == (2, 2)
    assert clock["worst_miss_us"] == pytest.approx(5.0)
    assert clock["worst"][0][1:] == ["late", "k", "cudaGraphLaunch"]


def test_step_splits_take_the_waits_out():
    steps = spans.step_splits(_spans())
    assert [s["step"] for s in steps] == [1, 2]
    one, two = steps
    assert one["ns"] == 1_000_000 and one["wait_ns"] == 600_000
    assert one["children_ns"] == (65 + 860) * 1000
    assert one["decode_ns"] == (860 - 600) * 1000
    assert one["by_name"]["handoff.transfer"] == 50_000
    assert two["decode_ns"] == (875 - 790) * 1000
    assert spans.host_busy_ms(_spans()) == pytest.approx([0.4, 0.11])
    assert spans.coverage(_spans()) == pytest.approx(
        (925 / 1000 + 875 / 900) / 2)
