"""The port's own training checkpoints: one ``torch.save`` file per step.

The JAX package checkpoints with Orbax, which needs JAX; the port writes
its own format instead and does not read Orbax directories (ROADMAP.md
A4). ``CheckpointManager(directory, max_to_keep)`` keeps
``<directory>/step_<step>.pt`` files, each a dict of tensors and plain
Python values (loadable with ``weights_only=True``). A save writes a
temporary file and renames it, so a reader never sees half a file; it
replaces an existing file of the same step, and then deletes the oldest
steps beyond ``max_to_keep``.

Over a mesh of ranks (``mesh``) rank 0 alone writes, every rank calls
``save``, and a barrier after the write holds the others until the file
is there; every rank reads it on ``restore``.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Union

import torch

from tpuseg_torch.core.mesh import barrier

_NAME = re.compile(r"step_(\d+)\.pt")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m[1]) for f in os.listdir(self.directory)
                      if (m := _NAME.fullmatch(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, payload: Any) -> None:
        if self.mesh is None or self.mesh.rank == 0:
            dst = self.path(step)
            tmp = f"{dst}.{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, dst)
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        barrier(self.mesh)

    def restore(self, step: Optional[int] = None,
                map_location: Union[str, torch.device] = "cpu") -> Any:
        """The payload of ``step`` (default: the latest)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location, weights_only=True)
