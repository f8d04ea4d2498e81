"""Dtype policy and device resolution.

Parameters are always fp32. This slice computes in fp32 only (the parity
configuration); ``compute_dtype="bfloat16"`` is queued in ROADMAP.md (A15).

``resolve_device`` is the one place an entry point picks its device: the
card unless the caller asks for the CPU, and an error — never a quiet CPU
run — when no card is there.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def torch_dtype(compute_dtype: str) -> torch.dtype:
    """Map a ModelConfig.compute_dtype string to the torch compute dtype."""
    if compute_dtype == "float32":
        return torch.float32
    if compute_dtype == "bfloat16":
        raise NotImplementedError(
            "compute_dtype='bfloat16' is not ported yet (ROADMAP.md, A15: "
            "bf16)"
        )
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """None -> the CUDA card; "cpu" only when asked for explicitly.

    Raises RuntimeError when a CUDA device is wanted and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s} (cuda or cpu)")
    return dev
