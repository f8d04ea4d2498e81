"""Each driver end to end at a toy size on the CPU, through the ``device``
argument that the command never passes; a cell added as files is found
by its name; the command refuses a machine without the card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, run
from benchmark.tests.conftest import TOY

SEED = 2 ** 31 + 12345      # larger than 32 signed bits hold


def toy_run(root, cell, trace=0, seconds=0.5):
    return run.main(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
                     "--trace", str(trace)], device="cpu", root=root)


@pytest.mark.parametrize("cell", sorted(TOY))
def test_driver_at_toy_size(toy_root, cell, two_threads, capsys):
    line = toy_run(toy_root, cell)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    bench = harness.load_json(os.path.join(toy_root, "BENCHMARK.json"))
    want = {m["name"] for m in run.cell_metrics(bench, cell, "end_to_end")}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(harness.load_json(
        harness.find(toy_root, "workloads", cell, ".json"))["limits"])


def test_traced_run_reads_its_layers(toy_root, two_threads):
    line = toy_run(toy_root, "unet-train-b64", trace=1)
    # no device on the CPU: the device readings are left out, never 0
    assert "train_input_wait_ms" in line["metrics"]
    assert "lovasz_logits_roofline" not in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_cell_added_as_files_is_found(tmp_path, two_threads):
    root = str(tmp_path)
    shutil.copytree(os.path.join(harness.CHECKOUT, "benchmark", "configs"),
                    os.path.join(root, "benchmark", "configs"))
    bench = harness.load_json(os.path.join(harness.CHECKOUT, "BENCHMARK.json"))
    spec = harness.load_json(harness.find(harness.CHECKOUT, "workloads",
                                          "unet-serve-720p-b16", ".json"))
    spec.update(name="unet-serve-new", why="a cell added as files")
    spec["traffic"].update(TOY["unet-serve-720p-b16"])
    os.makedirs(os.path.join(root, "benchmark", "workloads"))
    with open(os.path.join(root, "benchmark", "workloads", "unet-serve-new.json"), "w") as f:
        json.dump(spec, f)
    bench["workloads"].append({"name": "unet-serve-new", "config": "mnv2-unet",
                               "traffic": "unet-serve-new", "chips": 1,
                               "why": "a cell added as files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "unet-serve-720p-b16" in m.get("workloads", []):
            m["workloads"].append("unet-serve-new")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    line = toy_run(root, "unet-serve-new")
    assert {"serve_frames_per_s", "setup_s"} == set(line["metrics"])


def test_command_refuses_without_a_card():
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from benchmark import run\n"
            "run.main(['--workload', 'unet-train-b64', '--seed', '1', '--seconds', '1'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.CHECKOUT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ""


def test_command_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(harness.CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.PACKAGE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from benchmark import run\n"
            "run.main(['--workload', 'unet-train-b64', '--seed', '1', '--seconds', '1'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
