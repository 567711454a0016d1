"""A copy of the benchmark's data beside a tiny cell of each mix, in a
temporary directory, for the CPU tests: a cell, a mix, a configuration
and a metric are added there as new files and entries only."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY = dict(num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
            head_dim=32, d_ff=256, vocab_size=512)


# the card's kernels take heads of 128 lanes
TINY_CUDA = dict(TINY, num_heads=8, head_dim=128, d_model=256, d_ff=512)


def tiny_model_config(dims=TINY):
    """The port's glm4-9b config cut to ``dims`` (bf16, as served)."""
    from repro_torch.configs import registry
    return registry.get_config("glm4-9b").replace(name="tiny-glm", **dims)


def patch_registry(monkeypatch, dims=TINY):
    """``registry.get_config("tiny-glm")`` gives the tiny config."""
    from repro_torch.configs import registry
    real = registry.get_config

    def get_config(arch, variant=None):
        if arch == "tiny-glm":
            return tiny_model_config(dims)
        return real(arch, variant)
    monkeypatch.setattr(registry, "get_config", get_config)


def make(tmp: Path, limit: float = 1.0, dims=TINY) -> Path:
    """A checkout-like tree at ``tmp``: the benchmark's folder copied, and
    new files and entries for the tiny configuration, two tiny mixes,
    their cells and one extra metric. Returns its root."""
    dst = tmp / "lamina_bench"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((BENCH / "configs" / "glm4-9b.json").read_text())
    conf = dict(base, arch="tiny-glm", num_layers=dims["num_layers"],
                hidden_size=dims["d_model"], ffn_hidden_size=dims["d_ff"],
                kv_channels=dims["head_dim"],
                num_attention_heads=dims["num_heads"],
                multi_query_group_num=dims["num_kv_heads"],
                padded_vocab_size=dims["vocab_size"])
    (dst / "configs" / "tiny-glm.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny-glm", "source": "test",
                             "file": "lamina_bench/configs/tiny-glm.json",
                             "reduced": [], "why": "CPU test"})
    for mix in ("lamina-decode", "chat-azure"):
        m = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
        m.update(name=f"tiny-{mix}", set_size=64,
                 prompt=dict(m["prompt"], mean=40, max=120),
                 output=dict(m["output"], mean=16, max=32))
        (dst / "traffic" / f"tiny-{mix}.json").write_text(json.dumps(m))
        cell = json.loads((BENCH / "cells" /
                           f"glm4-9b.{mix}.json").read_text())
        cell.update(clients=6, max_batch=6, num_blocks=96, warmup_steps=0,
                    judge={"requests": 4, "max_gap": limit})
        if cell["prefill_chunk_tokens"]:
            cell["prefill_chunk_tokens"] = 64
        else:
            cell["transfer_blocks_per_step"] = 4
        name = f"tiny-glm.tiny-{mix}"
        (dst / "cells" / f"{name}.json").write_text(json.dumps(cell))
        bench["workloads"].append({"name": name, "config": "tiny-glm",
                                   "traffic": f"tiny-{mix}", "chips": 1,
                                   "why": "CPU test"})
    (dst / "metrics" / "steps_run.py").write_text(
        "def read(w):\n    return float(len(w.steps))\n")
    bench["per_layer"].append({"name": "steps_run", "unit": "steps",
                               "better": "higher", "source": "program_span",
                               "layer": "serving/llm_engine.py engine loop",
                               "moves": "output_tok_s"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "lamina-decode" if any("lamina" in c for c in
                                          m["workloads"]) else "chat-azure"
            m["workloads"].append(f"tiny-glm.tiny-{kind}")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp
