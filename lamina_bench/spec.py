"""Find a cell's files by the names ``BENCHMARK.json`` gives.

Nothing here knows a configuration, a mix or a metric by name: a later
cell, mix, configuration or per-layer metric is new files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: Dict          # configs/<config>.json
    traffic: Dict         # traffic/<traffic>.json
    settings: Dict        # cells/<workload>.json
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str, base: Path = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``, or for a split ``<base>.<split>``
    without a reader of its own, of ``metrics/<base>.py`` (a name may
    hold dots, so the module is loaded from its path)."""
    path = base / "metrics" / f"{name}.py"
    if not path.exists():
        path = base / "metrics" / f"{name.split('.')[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    spec = importlib.util.spec_from_file_location(
        "lamina_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _metrics(entries: List[Dict], cell: str, base: Path) -> List[Metric]:
    return [Metric(m["name"], m["unit"], load_reader(m["name"], base))
            for m in entries if cell in m.get("workloads", [cell])]


def load_cell(workload: str, bench: Dict, root: Path,
              base: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``bench`` (the parsed ``BENCHMARK.json``
    at ``root``); ``base`` is the benchmark's folder (this one)."""
    base = base or HERE
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    return Cell(
        name=workload, config_name=w["config"],
        config=load_json(root / conf["file"]),
        traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
        settings=load_json(base / "cells" / f"{workload}.json"),
        chips=int(w["chips"]),
        end_to_end=_metrics(bench["end_to_end"], workload, base),
        per_layer=_metrics(bench["per_layer"], workload, base))


def model_dims(config: Dict) -> Dict:
    """The port's ``ModelConfig`` fields of the configuration file: the
    published shape, read under the source's own keys by the file's
    ``port_fields`` map, and the values the port runs where it departs
    from the source (``as_run``: ``norm_eps``, ``rope_theta``; each
    departure named in ``departures``)."""
    dims = {field: config[key] for field, key in
            config["port_fields"].items()}
    dims.update(config["as_run"])
    return dims
