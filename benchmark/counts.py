"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the work a cell asks for, worked out from its
shapes and never read from the program.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s bf16, 67 TFLOP/s
float32 off the tensor cores, 495 TF32, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark import harness

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}

# operations per (pixel, class) of the Lovász region from logits to their
# gradient: softmax 5 (max, subtract, exp, sum, divide), the error 2
# (subtract, absolute), the bin 2 (scale, truncate), the three histogram
# sums 3, the closed-form gradient 4 (sign times weight, times p, the
# class sum, subtract)
LOVASZ_OPS_PER_ELEMENT = 16


def model_flops(arch: Dict, batch: int, height: int, width: int, train: bool,
                root: str = harness.CHECKOUT) -> int:
    """FLOPs of the reference model's forward at these shapes, and with
    ``train`` of the step: ``FlopCounterMode`` over the frozen reference on
    the meta device, so the count is the model's whatever implements it. A
    training step counts three forwards (the backward's input and weight
    gradients one each): the counter's own rule for a convolution's
    backward counts a grouped one as if it were dense, 32 to 960 times too
    much for the depthwise layers. A family of its own file is looked up
    under ``root``, the run's checkout (``reference.models.build``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.models import build

    with torch.device("meta"):
        model = build(arch, root)
        x = torch.empty(batch, 3, height, width)
    model.train(train)
    with FlopCounterMode(display=False) as counter:
        model(x)
    return int(counter.get_total_flops()) * (3 if train else 1)


def lovasz_region(pixels: int, classes: int, logits_bytes: int = 4,
                  target_bytes: int = 8) -> Dict[str, float]:
    """Operations, bytes and the least time of the Lovász region over
    ``pixels`` pixels: the logits as handed to the loss read once, the
    targets read once, the logits' gradient written once; the operations
    at the float32 peak."""
    elements = pixels * classes
    nbytes = elements * logits_bytes * 2 + pixels * target_bytes
    ops = elements * LOVASZ_OPS_PER_ELEMENT
    return {"ops": ops, "bytes": nbytes,
            "bound_s": max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS["float32"])}
