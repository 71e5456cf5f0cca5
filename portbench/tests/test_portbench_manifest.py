"""BENCHMARK.json and the benchmark's files agree, and keep to the contract's
limits; every module the harness would load by name loads."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # 24 cells at this length must fit the check's 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert {"n", "d", "guarantees", "assumed"} <= set(data)
        assert c["reduced"] == []


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_agree(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert entry["chips"] == 1 and _line(entry["why"])
    files = harness.cell_files(cell)
    wl = files["workload"]
    for k in ("config", "traffic", "chips", "why"):
        assert wl[k] == entry[k], k
    assert NAME.match(entry["traffic"]) and wl["checks"]
    assert all(v == 0 for v in wl["checks"].values())  # exact comparisons
    traffic = files["traffic"]
    assert traffic["loop"] in ("closed", "open")
    assert (harness.PKG / "ops" / f"{traffic['op']}.py").is_file()
    e2e = harness.cell_metrics(BENCH, cell, trace=False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, trace=True)


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        layers.add(m["layer"])
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in CELLS and cell in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    perf = (harness.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf, layer
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(harness.load("metrics", m["name"]).read)


def test_every_file_of_a_cell_is_there():
    """Registered or not (a cell measured and left out stays ready to be
    registered), every workload file names a configuration, a mix and an op
    that exist, and every manifest metric has its reader."""
    for path in (harness.PKG / "workloads").glob("*.json"):
        files = harness.cell_files(path.stem)
        assert files["config"]["name"] == files["workload"]["config"]
        assert (harness.PKG / "ops" / f"{files['traffic']['op']}.py").is_file()
    metrics = {p.stem for p in (harness.PKG / "metrics").glob("*.py")}
    assert {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]} <= metrics
