"""On the card's host (``python -m pytest benchmark/tests -m cuda``): the
command end to end on each cell for a short window, and the control (and,
training, the half batch) at the cells' own sizes on three seeds."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.load_json(os.path.join(harness.CHECKOUT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_command_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "0"],
                         cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "benchmark.calibrate", "--workload", cell,
                          "--seeds", "11,12,13", "--seconds", "0.3"],
                         cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-2000:]
    from benchmark.compare import verdict
    limits = harness.load_json(harness.find(harness.CHECKOUT, "workloads", cell, ".json"))["limits"]
    for line in out.stdout.strip().splitlines():
        reading = json.loads(line)
        assert verdict(reading["program"], limits)
        assert not verdict(reading["control"], limits)
        if "fault_half_batch" in reading:
            assert not verdict(reading["fault_half_batch"], limits)
