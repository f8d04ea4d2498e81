"""The reference's precision: where it rounds, and to what.

The configurations compute in bfloat16 with float32 parameters, as the
JAX package's ``ConvBNAct`` rounds: each convolution's and linear layer's
input, weight and bias in the compute type and its output rounded to it,
each BatchNorm's and LayerNorm's output, each activation and each residual
sum in it; the loss, the parameters and the optimizer in float32.
``rounding(model, kind)`` makes the float32 reference round at exactly
those places, forward and backward (a rounded tensor's gradient is rounded
the same way, as autograd through a cast gives it). The output of every
module of the types in ``ROUNDED_OUTPUTS`` rounds, and of those that the
model class names in a ``ROUNDED_OUTPUTS`` of its own (a family's
attention core, its residual blocks). The kinds:

- ``"bfloat16"``: the configuration's own precision, at which the served
  class maps are held (through some sixty layers, bfloat16 rounding moves
  a served pixel's class as often as a float32 computation would differ
  from it, so the reference computes the class maps as the configuration
  states them);
- ``"float32"``: no rounding;
- ``"fp8"``: the control, one precision below: float8 e4m3 forward and
  e5m2 backward, each tensor under its own scale (its largest magnitude
  onto the format's largest value), as fp8 training recipes round.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.models import InvertedResidual


def _scaled(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(t.dtype) * scale


ROUND = {
    "bfloat16": (lambda t: t.to(torch.bfloat16).to(t.dtype),) * 2,
    "fp8": (lambda t: _scaled(t, torch.float8_e4m3fn), lambda t: _scaled(t, torch.float8_e5m2)),
}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return ROUND[kind][0](x)

    @staticmethod
    def backward(ctx, grad):
        return ROUND[ctx.kind][1](grad), None


def round_to(t: torch.Tensor, kind: str) -> torch.Tensor:
    return _Round.apply(t, kind)


def _conv(kind):
    def forward(self: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        y = round_to(F.conv2d(round_to(x, kind), round_to(self.weight, kind), None,
                              self.stride, self.padding, self.dilation, self.groups), kind)
        if self.bias is None:
            return y
        return round_to(y + round_to(self.bias, kind).view(-1, 1, 1), kind)
    return forward


def _linear(kind):
    def forward(self: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        y = round_to(F.linear(round_to(x, kind), round_to(self.weight, kind)), kind)
        if self.bias is None:
            return y
        return round_to(y + round_to(self.bias, kind), kind)
    return forward


ROUNDED_OUTPUTS = (nn.BatchNorm2d, nn.LayerNorm, nn.ReLU, nn.ReLU6, nn.GELU, InvertedResidual)


@contextlib.contextmanager
def rounding(model: nn.Module, kind: str):
    """``model`` rounding to ``kind`` where the configuration rounds, in the
    block."""
    if kind == "float32":
        yield model
        return
    rounded = ROUNDED_OUTPUTS + tuple(getattr(type(model), "ROUNDED_OUTPUTS", ()))
    layers = [m for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    hooks = [m.register_forward_hook(lambda mod, args, out: round_to(out, kind))
             for m in model.modules() if isinstance(m, rounded)]
    for m in layers:
        m.forward = (_conv if isinstance(m, nn.Conv2d) else _linear)(kind).__get__(m)
    try:
        yield model
    finally:
        for m in layers:
            del m.forward
        for h in hooks:
            h.remove()
