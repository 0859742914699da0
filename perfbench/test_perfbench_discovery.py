"""Every configuration, mix, driver and metric reader that BENCHMARK.json
names is found by its name, and the file keeps to the benchmark's contract."""
import json
import re

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for kind in ("end_to_end", "per_layer") for m in BENCH[kind]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_found_by_name(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("perfbench/configs/")
    cfg = spec.config(BENCH, name)
    assert cfg["name"] == name and cfg["reduced"] == entry["reduced"]
    for key in ("family", "n", "k", "r", "alpha", "sub_bytes", "generator",
                "repair_read_blocks", "source", "assumed", "guarantees"):
        assert key in cfg, key
    assert cfg["alpha"] * cfg["sub_bytes"] >= cfg["block_bytes"]
    assert cfg["n"] % cfg["r"] == 0 and cfg["nodes_per_rack"] == cfg["n"] // cfg["r"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    entry = spec.cell(BENCH, cell)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] in (1, 4) and 1 <= len(entry["why"]) <= 200
    mix = spec.mix(entry["traffic"])
    assert mix["name"] == entry["traffic"]
    assert hasattr(spec.driver(mix["entry"]), "Driver")
    e2e = [m["name"] for m in spec.metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.metrics_of(BENCH, cell, "per_layer")


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    reader = spec.metric_reader(metric)
    assert callable(reader.read)
    kind = "end_to_end" if any(m["name"] == metric for m in BENCH["end_to_end"]) else "per_layer"
    m = next(x for x in BENCH[kind] if x["name"] == metric)
    assert NAME.match(metric) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    if kind == "end_to_end":
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    else:
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)


def test_names_are_unique_and_files_are_named_from_names():
    assert len(METRICS) == len(set(METRICS))
    assert len(CELLS) == len(set(CELLS))
    for path in (spec.HERE / "metrics").glob("*.py"):
        assert NAME.match(path.stem), path
    for path in (spec.HERE / "mixes").glob("*.json"):
        assert json.loads(path.read_text())["name"] == path.stem


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no_such.cell")
    with pytest.raises(ValueError):
        spec.mix("../configs/drc_9_6_3")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
