"""The engine's host spans (``serving/trace.py``) on the CPU: the span
tree of a chunked-prefill ``LLMEngine`` and of a ``DecodeEngine`` fed
handoffs, its agreement with the event log and the handoff counters, the
recorder's silence when off, and the clock it shares with
``torch.profiler``."""
import time

import numpy as np
import pytest

from repro_torch.configs import registry
from repro_torch.models import transformer
from repro_torch.serving import (DisaggConfig, EngineConfig, LLMEngine,
                                 Request, SamplingParams)
from repro_torch.serving.cluster import DecodeEngine, PrefillEngine
from repro_torch.serving.trace import NAMES, SpanRecorder
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

# events a caller emits between steps (submit, enqueue_handoff)
OUTSIDE_STEP = ("submit", "handoff_recv")


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_smoke_config("llama3-8b")
    return cfg, transformer.init_params(0, cfg, device="cpu")


def _reqs(cfg, n=5, lengths=(21, 9, 30, 5, 17), new=5, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        size=lengths[i % len(lengths)]
                                        ).tolist(),
                    params=SamplingParams(max_new_tokens=new))
            for i in range(n)]


def _chunked(cfg, params):
    return LLMEngine(cfg, params, EngineConfig(
        num_blocks=64, block_size=4, max_batch=3, prefill_chunk_tokens=8),
        device="cpu")


def _serve_chunked(cfg, params, traced=True):
    """A chunked-prefill engine over five requests, submitted in two waves
    (the second mid-run); its spans (None untraced), requests, engine and
    the kv_bytes_transferred delta of each step."""
    eng = _chunked(cfg, params)
    reqs = _reqs(cfg)
    if traced:
        eng.trace.start()
    eng.submit(reqs[:3])
    for _ in range(4):
        eng.step()
    eng.submit(reqs[3:])
    eng.run()
    return (eng.trace.stop() if traced else None), reqs, eng


def _serve_handoffs(cfg, params, traced=True):
    """A prefill engine hands five requests to a decode engine (head
    partition over two workers, two blocks a step on the wire); the decode
    engine's spans, its requests and engine, and each step's
    kv_bytes_transferred delta by step number."""
    econf = EngineConfig(placement="attention_pool", partition="head",
                         attention_workers=2, kv_shards=2, num_blocks=64,
                         block_size=4, max_batch=4)
    pre = PrefillEngine(cfg, params, econf, device="cpu")
    dec = DecodeEngine(cfg, params, econf,
                       DisaggConfig(transfer_blocks_per_step=2),
                       device="cpu")
    pre.on_handoff = dec.enqueue_handoff
    reqs = _reqs(cfg, seed=1)
    pre.submit(reqs)
    if traced:
        dec.trace.start()
    moved = {}
    while pre.has_work() or dec.has_work():
        if pre.has_work():
            pre.step()
        if dec.has_work():
            before = dec.stats.kv_bytes_transferred
            dec.step()
            moved[dec._step_no] = dec.stats.kv_bytes_transferred - before
    return (dec.trace.stop() if traced else None), reqs, dec, moved


@pytest.fixture(scope="module")
def chunked(setup):
    return _serve_chunked(*setup)


@pytest.fixture(scope="module")
def handoffs(setup):
    return _serve_handoffs(*setup)


@pytest.fixture(params=["chunked", "handoffs"])
def traced(request, chunked, handoffs):
    return {"chunked": chunked, "handoffs": handoffs}[request.param]


def test_every_span_name_comes_from_the_table(traced):
    spans = traced[0]
    assert spans and {s.name for s in spans} <= set(NAMES)


def test_chunked_engine_records_its_phases(chunked):
    names = {s.name for s in chunked[0]}
    assert {"step", "step.fault_tick", "step.admit", "step.chunk",
            "step.decode", "decode.prepare", "decode.run", "decode.commit",
            "decode.sample", "decode.account", "step.retire",
            "wait.validate", "wait.sample"} <= names
    assert "step.handoff" not in names


def test_decode_engine_records_the_handoff_import(handoffs):
    names = {s.name for s in handoffs[0]}
    assert {"step.handoff", "handoff.prealloc", "handoff.transfer",
            "handoff.admit"} <= names
    assert "step.chunk" not in names


def test_one_step_root_per_step_and_children_inside_parents(traced):
    spans, _, eng = traced[:3]
    roots = [s for s in spans if s.parent == -1]
    assert all(s.name == "step" for s in roots)
    assert [s.step for s in roots] == list(range(roots[0].step,
                                                 eng._step_no + 1))
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.parent == -1:
            continue
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
        assert s.step == p.step
        if s.name.startswith("step."):
            assert p.name in ("step", "step.admit"), s
        elif not s.name.startswith("wait."):
            assert p.name == "step." + s.name.split(".")[0], s


def test_chunk_span_exactly_in_the_steps_that_emit_a_chunk_event(chunked):
    spans, _, eng = chunked
    first = spans[0].step
    chunk_spans = [(s.step, s.rid, s.a, s.b) for s in spans
                   if s.name == "step.chunk"]
    events = [(e.step, e.rid, e.info["start"], e.info["tokens"])
              for e in eng.event_log if e.kind == "chunk" and e.step >= first]
    assert chunk_spans == events and len(events) >= 5


def test_transfer_bytes_add_up_to_each_steps_kv_bytes_transferred(handoffs):
    spans, reqs, dec, moved = handoffs
    landed = {}
    for s in spans:
        if s.name == "handoff.transfer":
            landed[s.step] = landed.get(s.step, 0) + s.b
    assert {k: v for k, v in moved.items() if v} == landed
    assert sum(landed.values()) == dec.stats.kv_bytes_transferred > 0
    per_rid = {}
    for s in spans:
        if s.name == "handoff.transfer":
            per_rid[s.rid] = per_rid.get(s.rid, 0) + s.a
    assert set(per_rid) == {r.rid for r in reqs}
    assert max(s.a for s in spans if s.name == "handoff.transfer") <= 2


def test_every_event_falls_inside_its_steps_span(traced):
    spans, _, eng = traced[:3]
    step_span = {s.step: s for s in spans if s.name == "step"}
    inside = [e for e in eng.event_log
              if e.kind not in OUTSIDE_STEP and e.step in step_span]
    assert inside
    for e in inside:
        s = step_span[e.step]
        t = int(e.t_s * 1e9)
        # time.time() rounds to a float: a microsecond of slack
        assert s.start_ns - 1000 <= t <= s.end_ns + 1000, (e, s)


def test_a_step_opens_a_fixed_handful_of_spans(traced):
    spans = traced[0]
    per_step = {}
    for s in spans:
        per_step[s.step] = per_step.get(s.step, 0) + 1
    assert max(per_step.values()) <= 20
    decode = [s.step for s in spans if s.name == "decode.run"]
    batch = {s.step: s.a for s in spans if s.name == "decode.run"}
    # a decode-only step opens as many spans at batch 1 as at a full batch
    only = [k for k in decode if not any(
        s.step == k and s.name in ("step.chunk", "handoff.transfer")
        or (s.step == k and s.name == "step.admit" and s.parent != -1
            and spans[s.parent].name == "step.admit") for s in spans)]
    assert only and len({per_step[k] for k in only}) == 1, \
        [(batch[k], per_step[k]) for k in only]


def test_recorder_changes_no_output_and_off_records_nothing(setup, chunked,
                                                           handoffs):
    cfg, params = setup
    _, reqs, eng = _serve_chunked(cfg, params, traced=False)
    assert [r.output for r in reqs] == [r.output for r in chunked[1]]
    assert [e.kind for e in eng.event_log] == \
        [e.kind for e in chunked[2].event_log]
    assert not eng.trace.on and eng.trace.stop() == []
    _, reqs, dec, moved = _serve_handoffs(cfg, params, traced=False)
    assert [r.output for r in reqs] == [r.output for r in handoffs[1]]
    assert [e.kind for e in dec.event_log] == \
        [e.kind for e in handoffs[2].event_log]
    assert moved == handoffs[3]
    assert dec.trace.stop() == []


def test_spans_share_the_profilers_clock(setup):
    cfg, params = setup
    eng = _chunked(cfg, params)
    eng.submit(_reqs(cfg, n=2))
    eng.step()
    eng.trace.start()
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("x"):
            eng.step()
    spans = eng.trace.stop()
    x = next(e for e in prof.profiler.kineto_results.events()
             if e.name() == "x")
    x0, x1 = x.start_ns(), x.start_ns() + x.duration_ns()
    step = spans[0]
    assert step.name == "step"
    assert x0 - 50_000 <= step.start_ns and step.end_ns <= x1 + 50_000, \
        (x0, x1, step)


def test_recorder_grows_and_restarts_a_step_after_a_raise():
    tr = SpanRecorder(capacity=2)
    assert not tr.on
    tr.start()
    tr.open_step(1)
    tr.open("step.admit")          # left open, as a raise would
    tr.open_step(2)
    tr.open("step.decode")
    tr.open("decode.run", a=3)
    tr.close()
    t = time.time_ns()
    tr.close()
    tr.close()
    spans = tr.stop()
    assert [s.name for s in spans] == ["step", "step.admit", "step",
                                       "step.decode", "decode.run"]
    assert [s.parent for s in spans] == [-1, 0, -1, 2, 3]
    assert [s.step for s in spans] == [1, 1, 2, 2, 2]
    assert spans[1].end_ns == 0 and spans[4].a == 3
    assert spans[4].end_ns <= t <= spans[3].end_ns
    assert not tr.on and tr.stop() == []

