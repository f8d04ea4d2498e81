"""Dtype policy and device resolution.

The port of ``tpuseg/core/dtypes.py``. Parameters, BatchNorm statistics
and the loss stay fp32 whatever ``ModelConfig.compute_dtype`` says;
``"bfloat16"`` computes the activations in bf16, rounding exactly where
the JAX package's flax modules round (their ``dtype=`` fields). The port
carries the compute dtype the same way, explicitly, on the modules that
round (``set_compute_dtype``), and not through ``torch.autocast``, whose
op lists round at other places. ``None`` means "compute in the
parameters' dtype": fp32, and float64 where a parity test calls
``.double()``.

``resolve_device`` is the one place an entry point picks its device: the
card unless the caller asks for the CPU, and an error — never a quiet CPU
run — when no card is there.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(compute_dtype: str) -> torch.dtype:
    """Map a ModelConfig.compute_dtype string to the torch compute dtype."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype {compute_dtype!r} (float32 | bfloat16)")
    return COMPUTE_DTYPES[compute_dtype]


def set_compute_dtype(model: nn.Module, compute_dtype: str) -> nn.Module:
    """Give every module of ``model`` that rounds to the compute dtype (it
    has a ``compute_dtype`` attribute: the convolutions, BatchNorms and
    heads of ``tpuseg_torch.models``) the dtype of ``compute_dtype``; fp32
    sets None, the parameters' own dtype."""
    dt = torch_dtype(compute_dtype)
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = None if dt == torch.float32 else dt
    return model


def cast_to_output(x: torch.Tensor) -> torch.Tensor:
    """Logits in at least float32 (``DTypePolicy.cast_to_output``; float64
    stays float64)."""
    return x.to(torch.promote_types(torch.float32, x.dtype))


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
