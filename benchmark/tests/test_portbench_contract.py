"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds it by."""

from __future__ import annotations

import os
import re

import pytest

from benchmark import harness
from benchmark.run import cell_metrics

BENCH = harness.load_json(os.path.join(harness.CHECKOUT, "BENCHMARK.json"))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert os.path.getsize(os.path.join(harness.CHECKOUT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for entry in BENCH[section]:
        assert NAME.fullmatch(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.fullmatch(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in entry:
                text = entry[key]
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.isfile(
            os.path.join(harness.CHECKOUT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        e2e = {m["name"] for m in cell_metrics(BENCH, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell_metrics(BENCH, cell, "per_layer")


def test_moves_names_a_metric_each_listed_cell_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


def test_every_name_has_its_file():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        spec = harness.load_json(harness.find(harness.CHECKOUT, "workloads", w["name"], ".json"))
        assert spec["config"] == w["config"] and spec["why"] == w["why"]
        harness.find(harness.CHECKOUT, "drivers", spec["driver"], ".py")
        assert spec["limits"]
    for m in BENCH["per_layer"]:
        harness.find(harness.CHECKOUT, "metrics", m["name"], ".py")


@pytest.mark.parametrize("cell", CELLS)
def test_training_cells_state_each_value_once(cell):
    spec = harness.load_json(harness.find(harness.CHECKOUT, "workloads", cell, ".json"))
    if spec["driver"] != "train_loop":
        return
    config = harness.load_json(harness.find(harness.CHECKOUT, "configs", spec["config"], ".json"))
    # the shape and the optimizer are the program's flags alone
    assert set(spec["traffic"]) == {"scenes"}
    shape = harness.training(config, spec)
    # the Trainer's own epoch, one pass of the set, is whole dispatches
    per_epoch = spec["traffic"]["scenes"] // shape["batch_size"]
    assert per_epoch % shape["steps_per_dispatch"] == 0


def test_configs_reduce_nothing_and_name_their_source():
    for c in BENCH["configs"]:
        spec = harness.load_json(os.path.join(harness.CHECKOUT, c["file"]))
        assert spec["reduced"] == c["reduced"] == []
        assert spec["source"] == c["source"]
        assert spec["compute_dtype"] == spec["flags"]["model.compute_dtype"]


def test_a_full_check_fits_its_time_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)
