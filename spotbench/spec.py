"""``BENCHMARK.json`` and the files it names, found by name.

A cell is a workload entry: its configuration file (``configs[].file``),
its traffic file (``traffic/<traffic>.json``), the end-to-end metrics it
reports and the per-layer metrics that list it (or list no cells), each
read by ``metrics/<metric>.py``.  Adding a cell, a traffic mix or a metric
is adding files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its files read."""
    bench = load() if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=name, chips=w["chips"], config_name=w["config"], config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def reader(metric: str):
    """The module of ``metrics/<metric>.py``: ``UNIT`` and ``read(run)``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "spotbench_metric_" + metric.replace(".", "_").replace("-", "_")
    loaded = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module
