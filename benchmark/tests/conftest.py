"""Shared fixtures of the benchmark's own tests, which import no JAX.

Run them from the checkout's root:

    python -m pytest benchmark/tests -q              # CPU: the card's tests skip
    python -m pytest benchmark/tests -q -m cuda      # on the card's host

``toy_root`` is a tree like the checkout's (``BENCHMARK.json`` and the
workload files) whose cells run at a tiny size on the CPU, through the
``device`` argument of ``benchmark.run.main`` that the command never passes.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import harness

TOY_TRAIN = {"train.batch_size": 2, "data.height": 64, "data.width": 64,
             "train.steps_per_dispatch": 2}
# each cell's toy size: program flags (the keys with a dot) and traffic
TOY = {
    "unet-train-b64": {**TOY_TRAIN, "scenes": 16},
    "deeplab-train-c66": {**TOY_TRAIN, "scenes": 8},
    "unet-serve-720p-b16": {"batch_size": 2, "frame_hw": [72, 128], "model_hw": [64, 128],
                            "pool_batches": 2, "sample_batches": 2},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


def write_toy_root(root: str, compute_dtype: str = "bfloat16") -> str:
    """The checkout's cells at the toy sizes above, under ``root``."""
    os.makedirs(os.path.join(root, "benchmark", "workloads"), exist_ok=True)
    os.makedirs(os.path.join(root, "benchmark", "configs"), exist_ok=True)
    bench = harness.load_json(os.path.join(harness.CHECKOUT, "BENCHMARK.json"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for cell in bench["workloads"]:
        w = harness.load_json(harness.find(harness.CHECKOUT, "workloads", cell["name"], ".json"))
        for key, value in TOY[cell["name"]].items():
            w["flags" if "." in key else "traffic"][key] = value
        with open(os.path.join(root, "benchmark", "workloads", cell["name"] + ".json"), "w") as f:
            json.dump(w, f)
    for cfg in bench["configs"]:
        c = harness.load_json(os.path.join(harness.CHECKOUT, cfg["file"]))
        c["flags"]["model.compute_dtype"] = c["compute_dtype"] = compute_dtype
        with open(os.path.join(root, "benchmark", "configs", cfg["name"] + ".json"), "w") as f:
            json.dump(c, f)
    return root


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory):
    return write_toy_root(str(tmp_path_factory.mktemp("toy")))


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """Skip unless a CUDA card is here (decided in the test, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
