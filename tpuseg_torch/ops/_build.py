"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source in ``tpuseg_torch/csrc`` is compiled on its own, for Hopper
(``sm_90a``), into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The libraries go to ``build/kernels/`` at the repository root (git-ignored),
named by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused. ``build`` starts one nvcc per source, all
at once, and waits for them together. Nothing here runs at import: the
first kernel call (or ``build``) compiles.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("argmax_colorize", "upsample2x_argmax", "upconcat_conv",
           "lovasz_histograms", "lovasz_lookup", "mbconv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    name: str
    path: Path
    seconds: float      # nvcc wall time; 0.0 when an earlier build was reused
    ptxas: str          # what -Xptxas -v reported (registers, smem, spills)


def nvcc_path() -> str:
    """The nvcc to use: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels build on the "
        "machine with the card"
    )


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Built]:
    """Compile every source in ``names`` whose library is missing, one nvcc
    per source, all in parallel. Raises RuntimeError with nvcc's output if
    any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Built] = {}
    running = {}
    for name in names:
        dst = lib_path(name)
        log = dst.with_suffix(".log")
        if dst.exists():
            out[name] = Built(name, dst, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = dst.with_name(f"{dst.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        logf = open(log, "w")
        running[name] = (subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT),
                         logf, tmp, dst, log, time.perf_counter())
    failed = []
    for name, (proc, logf, tmp, dst, log, t0) in running.items():
        rc = proc.wait()
        seconds = time.perf_counter() - t0
        logf.close()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n{log.read_text()}")
            continue
        os.replace(tmp, dst)
        out[name] = Built(name, dst, seconds, log.read_text())
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


_LIBS: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, building all sources
    first when its library is missing."""
    if name not in _LIBS:
        path = lib_path(name)
        if not path.exists():
            build()
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
