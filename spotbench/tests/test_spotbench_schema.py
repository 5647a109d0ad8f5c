"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from spotbench import gen, judge, spec  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORK_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
PL_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
BUDGET_S = 43200
# the keys of a configuration file that the harness reads, and those that
# only document it; of a traffic file and its kinds, those ``gen`` reads
CONFIG_READ = {"window", "lam", "weight", "precision", "bucket_sizes",
               "t3_nodes", "regions", "categories", "sizes", "spot_discount",
               "region_price_spread", "limits"}
CONFIG_DOC = {"name", "source", "deployment", "assumed", "reduced",
              "guarantees"}
TRAFFIC_KEYS = {"requests_per_call", "kinds"}
KIND_KEYS = {"axis", "filters", "max_types"}


@pytest.fixture(scope="module")
def bench():
    path = ROOT / "BENCHMARK.json"
    assert path.stat().st_size <= 64 * 1024
    return spec.load(path)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
    n = bench["run_seconds"]
    assert isinstance(n, int) and 1 <= n <= 51
    # a full regression check of 24 cells fits in 12 hours at this length
    assert (2 + 14 * 24) * (n + 60) + 24 * 2 * 90 + 1200 <= BUDGET_S


def test_entries(bench):
    names = set()
    for group, keys in (("configs", CONFIG_KEYS), ("workloads", WORK_KEYS)):
        assert 1 <= len(bench[group]) <= 24
        for e in bench[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert _line(e["why"])
    for c in bench["configs"]:
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert (ROOT / c["file"]).is_file()
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    used = {w["config"] for w in bench["workloads"]}
    assert used == configs


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    seen = set()
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    for group, keys in (("end_to_end", E2E_KEYS), ("per_layer", PL_KEYS)):
        for m in bench[group]:
            assert set(m) - {"workloads"} == keys, m
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert set(m.get("workloads", cells)) <= cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
    for cell in cells:
        c = spec.cell(cell, bench)
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            # what a per-layer metric moves, every cell it lists reports
            assert m["moves"] in e2e


def test_files_found_by_name(bench):
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert set(judge.NUMBERS) <= set(cell.config["limits"])
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == {
            c["name"]: c for c in bench["configs"]}[w["config"]]["reduced"]
        assert set(cell.config) == CONFIG_READ | CONFIG_DOC
        assert set(cell.traffic) == TRAFFIC_KEYS
        for kind in cell.traffic["kinds"]:
            assert set(kind) <= KIND_KEYS and kind["axis"] in ("cpus",
                                                              "memory")
            assert set(kind.get("filters", ())) <= set(gen.FILTERS)
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = spec.reader(m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)


def test_files_are_named_from_name_characters():
    for f in (ROOT / "spotbench").rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


def test_limits_are_numbers():
    for f in (ROOT / "spotbench" / "configs").glob("*.json"):
        limits = json.loads(f.read_text())["limits"]
        assert all(isinstance(v, float) and v > 0 for v in limits.values())
