"""Seeded weights, made on the device in one draw and handed to both the
program and the reference.

Every floating tensor of a state dict is cut from one normal draw and one
uniform draw of the generator: every weight of two or more dimensions
(convolutions, linear layers) He-normal (variance 2 / fan-in, the product
of all its dimensions but the first), their biases N(0, 0.01^2), the
one-dimensional weights (BatchNorm and LayerNorm scales) U(0.5, 1.5),
BatchNorm shifts N(0, 0.1^2), running means U(-0.2, 0.2) and variances
U(0.5, 1.5); the batch counters are 0. A leaf that none of these rules
knows is drawn by the model class's ``SEEDED_RULES``, a dict from the
leaf's name to a function of its normal and uniform draws, or raises. The
state dict's shapes and key order come from the reference model, whose
keys are the program's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn


def seeded_state(model: nn.Module, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A state dict for ``model``'s keys, drawn on ``device`` from ``gen``."""
    rules = getattr(type(model), "SEEDED_RULES", {})
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    floating = [k for k, v in model.state_dict().items() if v.is_floating_point()]
    total = sum(math.prod(shapes[k]) for k in floating)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for key, value in model.state_dict().items():
        if not value.is_floating_point():
            out[key] = torch.zeros(shapes[key], dtype=value.dtype, device=device)
            continue
        n = math.prod(shapes[key])
        z, u = normal[at:at + n].view(shapes[key]), uniform[at:at + n].view(shapes[key])
        at += n
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shapes[key]) >= 2:
            fan_in = math.prod(shapes[key][1:])
            out[key] = z * math.sqrt(2.0 / fan_in)
        elif leaf == "weight":                # BatchNorm or LayerNorm scale
            out[key] = 0.5 + u
        elif leaf == "bias" and key.rsplit(".", 1)[0] + ".running_mean" in shapes:
            out[key] = 0.1 * z                # BatchNorm shift
        elif leaf == "bias":
            out[key] = 0.01 * z
        elif leaf == "running_mean":
            out[key] = 0.4 * u - 0.2
        elif leaf == "running_var":
            out[key] = 0.5 + u
        elif leaf in rules:
            out[key] = rules[leaf](z, u)
        else:
            raise KeyError(f"no seeded rule for {key!r}")
    return out
