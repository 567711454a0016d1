"""The port's serve CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``), both in process at smoke size on the
CPU, in every ``--mode`` (engine, router, prefill, decode; the router over
an int8 pool too): the port prints the reference's summary lines with the
same keys, and every value that is not a time equals the JAX CLI's (the
trace's requests and tokens, handoffs, ``kv_bytes_transferred``, payload
blocks, affinity hits, skipped prefill tokens, pool transfer bytes). The
port's trace generator gives the reference's requests for a seed."""
import re
import sys

import numpy as np
import pytest

from repro.data import traces as jtraces
from repro.launch import serve as jserve
from repro_torch.data import traces
from repro_torch.launch import serve
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

# values that are wall-clock measurements, not counts
TIMED = {"throughput", "mean_tbt", "p50", "p90", "p99"}
COMMON = ["--arch", "llama3-8b", "--smoke", "--prefix-sharing",
          "--requests", "6", "--transfer-blocks-per-step", "4",
          "--kv-shards", "2"]


def _parse(text):
    """Each output line as (its leading word, [(key, value), ...])."""
    rows = []
    for line in text.strip().splitlines():
        pairs = re.findall(r"([A-Za-z_]+)=(\[[^\]]*\]|[^\s,)]+)", line)
        rows.append((line.split()[0], pairs))
    return rows


def _untimed(rows):
    return [(head, [(k, v) for k, v in pairs if k not in TIMED])
            for head, pairs in rows]


def _run_jax(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["repro-serve"] + argv)
    jserve.main()
    return capsys.readouterr().out


def _run_port(argv, capsys):
    serve.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


@pytest.mark.parametrize("mode,extra", [
    ("engine", []), ("router", []), ("prefill", []), ("decode", []),
    ("router", ["--kv-dtype", "int8"])],
    ids=["engine", "router", "prefill", "decode", "router-int8"])
def test_serve_cli_prints_the_reference_lines(mode, extra, capsys,
                                              monkeypatch):
    argv = COMMON + ["--mode", mode] + extra
    jrows = _parse(_run_jax(argv, capsys, monkeypatch))
    trows = _parse(_run_port(argv, capsys))
    assert [h for h, _ in trows] == [h for h, _ in jrows]
    assert [[k for k, _ in p] for _, p in trows] == \
        [[k for k, _ in p] for _, p in jrows]
    assert _untimed(trows) == _untimed(jrows)
    first = dict(trows[0][1])
    if mode != "engine":
        assert first["mode"] == mode
        assert first["requests"] == "6"
    if mode in ("router", "decode"):
        assert first["handoffs"] == "6"


def test_traces_match_the_reference():
    for trace in traces.TRACES:
        got = traces.generate(trace, 5, 1000, scale=0.01, seed=3)
        want = jtraces.generate(trace, 5, 1000, scale=0.01, seed=3)
        assert [(r.prompt, r.params.max_new_tokens) for r in got] == \
            [(r.prompt, r.params.max_new_tokens) for r in want]
        assert traces.stats(trace, 0.5) == jtraces.stats(trace, 0.5)
    lens = [len(r.prompt) for r in traces.generate("azure-code", 64,
                                                   max_prompt=40)]
    assert max(lens) <= 40 and min(lens) >= 2
    assert np.mean(lens) > 20


def test_serve_cli_refuses_what_the_port_lacks(capsys):
    # moe_offload on a dense arch: the placement's error, as the reference
    with pytest.raises(ValueError, match="MoE"):
        serve.main(COMMON + ["--placement", "moe_offload", "--device",
                             "cpu"])
    with pytest.raises(SystemExit):        # no --backend knob
        serve.main(COMMON + ["--backend", "pallas", "--device", "cpu"])
    capsys.readouterr()


@pytest.mark.parametrize("extra", [["--engine", "vllm"],
                                   ["--engine", "lamina", "--kv-dtype",
                                    "int8"]], ids=["vllm", "lamina-int8"])
def test_serve_cli_glm4_9b_prints_the_reference_lines(extra, capsys,
                                                      monkeypatch):
    """``--arch glm4-9b --smoke``, one of the archs this slice adds to the
    port's registry, line for line against the JAX CLI."""
    argv = ["--arch", "glm4-9b", "--smoke", "--requests", "4"] + extra
    jrows = _parse(_run_jax(argv, capsys, monkeypatch))
    trows = _parse(_run_port(argv, capsys))
    assert [h for h, _ in trows] == [h for h, _ in jrows]
    assert _untimed(trows) == _untimed(jrows)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "rwkv6-7b"])
def test_serve_cli_exits_with_the_family_error(arch, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert exc.value.code == 2
    assert "is ported for the families ('dense', 'vlm', 'moe')" in \
        capsys.readouterr().err


@pytest.mark.parametrize("extra", [["--engine", "vllm"],
                                   ["--placement", "moe_offload",
                                    "--kv-dtype", "int8"]],
                         ids=["vllm", "moe_offload-int8"])
def test_serve_cli_qwen3_moe_prints_the_reference_lines(extra, capsys,
                                                        monkeypatch):
    """``--arch qwen3-moe-30b-a3b --smoke`` line for line against the JAX
    CLI; ``moe_offload`` adds the expert pool's transfer line."""
    argv = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--requests", "4"] + \
        extra
    jrows = _parse(_run_jax(argv, capsys, monkeypatch))
    trows = _parse(_run_port(argv, capsys))
    assert [h for h, _ in trows] == [h for h, _ in jrows]
    assert _untimed(trows) == _untimed(jrows)
    heads = [h for h, _ in trows]
    assert ("expert" in heads) == ("moe_offload" in extra)
