"""BENCHMARK.json, the configurations, mixes, cells and readers agree."""

import json
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and all(w["chips"] == 1 for w in BENCH["workloads"])


def test_names_units_and_uniqueness():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_parse_and_agree(cell):
    c, config = harness.load_cell(BENCH, cell)
    (entry,) = [e for e in BENCH["configs"] if e["name"] == c["config"]]
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
    assert config["dtype"] == "float32" and config["allow_tf32"] is False
    assert (harness.HERE / "drivers" / f"{c['driver']}.py").exists()
    assert set(c["limits"]) and all(v >= 0 for v in c["limits"].values())
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(BENCH, cell, "per_layer")


def test_every_config_is_used_and_every_bound_in_range():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    readers = {p.name[:-3] for p in (harness.HERE / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH["per_layer"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader_and_its_cells_report_what_it_moves(metric):
    (m,) = [x for x in BENCH["per_layer"] if x["name"] == metric]
    assert callable(harness.reader(metric))
    for cell in m["workloads"]:
        assert m["moves"] in {e["name"] for e in harness.metrics_of(BENCH, cell, "end_to_end")}
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert all("\n" not in x for x in layers)
