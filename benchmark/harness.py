"""What every cell shares: finding a cell's files by name, the context a
driver runs in, the check for JAX, and the program's flags.

A cell is found by its name alone: ``BENCHMARK.json`` at the root lists it,
``benchmark/workloads/<cell>.json`` holds its traffic and its limits,
``benchmark/configs/<config>.json`` its configuration,
``benchmark/drivers/<driver>.py`` the loop that drives it and
``benchmark/metrics/<metric>.py`` each per-layer metric's reader and
``benchmark/reference/families/<family>.py`` the reference of a model family
that ``reference/models.py`` does not hold. Each is looked up under the root
given (a test's temporary tree) and then in this package, so a new cell,
configuration, metric or family is a new file.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

PACKAGE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(PACKAGE)
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpuseg")


def find(root: str, kind: str, name: str, suffix: str) -> str:
    """The path of ``<kind>/<name><suffix>`` under ``root``'s benchmark
    folder, else under this package."""
    paths = [os.path.join(base, kind, name + suffix)
             for base in (os.path.join(root, "benchmark"), PACKAGE)]
    for path in paths:
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no {kind}/{name}{suffix}: neither {paths[0]} nor {paths[1]}")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A driver or metric reader, imported from its file."""
    name = "benchmark_file_" + os.path.relpath(path, CHECKOUT).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``tpuseg_torch`` is not ``tpuseg``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def cache_environment(checkout: str) -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = os.path.join(checkout, "build")
    return {"TRITON_CACHE_DIR": os.path.join(build, "triton-cache"),
            "TORCH_EXTENSIONS_DIR": os.path.join(build, "torch-extensions"),
            "CUDA_CACHE_PATH": os.path.join(build, "cuda-cache")}


def build_kernels() -> None:
    """The program's CUDA libraries, built into the checkout's
    ``build/kernels`` unless a build is there already: a set-up phase of
    its own, so that a checkout's first run shows what it compiled."""
    try:
        from tpuseg_torch.ops import _build
        build = _build.build
    except (ImportError, AttributeError):
        return
    build()


def program_flags(config: Dict, workload: Dict) -> List[str]:
    """The program's ``--section.key=value`` flags: the configuration's,
    then the cell's."""
    flags = dict(config.get("flags", {}))
    flags.update(workload.get("flags", {}))
    return [f"--{k}={v}" for k, v in flags.items()]


def training(config: Dict, workload: Dict) -> Dict[str, Any]:
    """A training cell's shape and optimizer, read from the program flags
    it runs with: the one copy that the program, the data and the
    reference all follow."""
    f = dict(config.get("flags", {}))
    f.update(workload.get("flags", {}))
    return {"batch_size": int(f["train.batch_size"]), "height": int(f["data.height"]),
            "width": int(f["data.width"]),
            "steps_per_dispatch": int(f["train.steps_per_dispatch"]),
            "loss": str(f["train.loss"]), "lr": float(f["train.lr"]),
            # the program's weight of the surrogate in a ce+ mix
            "lovasz_weight": float(f.get("train.dice_weight", 0.5))}


@dataclass
class Context:
    """One run of one cell."""

    name: str
    workload: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any                       # torch.device
    chips: int
    t0: float                         # process start, perf_counter
    root: str = CHECKOUT
    setup_done: Optional[float] = None
    notes: Dict[str, Any] = field(default_factory=dict)
    phases: List = field(default_factory=list)

    def phase(self, name: str) -> None:
        """Close a named part of the set-up (printed to standard error)."""
        self.phases.append((name, time.perf_counter() - self.t0))

    def end_setup(self) -> float:
        """Mark the first timed step; refuse a process that loaded JAX."""
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f"after set-up sys.modules holds {bad}: no run may load JAX "
                             "or the JAX package")
        self.setup_done = time.perf_counter()
        return self.setup_done - self.t0
