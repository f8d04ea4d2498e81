"""Quantization-aware training (QAT): int8 fake quantization.

The port of ``tpuseg/ops/fake_quant.py``. With ``--train.qat`` every conv
of a JAX ``ConvBNAct`` scope runs fake-quantized in training: its input
and kernel are rounded to the symmetric int8 grids the deployed int8 graph
uses, and the gradient passes straight through. Nothing is added to the
parameters or buffers, so the state_dict is that of a run without QAT;
eval is never quantized.

- ``fake_quant_act``: per-tensor, scale = max(absmax, 1e-8) / 127, so
  nothing clips. Over a mesh (``mesh``, its data axis; the whole mesh with
  ``spatial``, where each rank holds an H-slab) the absmax is the global
  batch's, one MAX all_reduce, as under the JAX package's sharded jit.
- ``fake_quant_kernel``: per output channel (dim 0 of an OIHW weight, the
  last axis of JAX's HWIO one); an all-zero channel gets scale 1.0.

Both round in float32 whatever the input's dtype (bf16 widened, float64
narrowed, as ``astype(jnp.float32)`` does under x64) and return the
input's dtype. The scale is the one the JAX train step computes: its
``absmax / 127.0`` is compiled by XLA into ``absmax * float32(1/127)`` (a
division by a constant becomes a multiplication by its reciprocal), which
is one float32 step off the division for some absmax values; op by op,
outside ``jax.jit``, JAX divides (ROADMAP.md C15). The straight-through
estimator is the JAX expression ``xf + stop_gradient(q - xf)`` written as
``xf + (q - xf).detach()``: in floating point it is not always ``q``, so
``q`` alone would not be bit-equal. ``torch.round`` and ``jnp.round`` both
round half to even.

The marker set (``build_qat_markers`` there) is every conv followed by a
BatchNorm: in the port, a ``Conv2d`` whose next sibling in its
``nn.Sequential`` is a ``BatchNorm2d`` (``ConvBNAct``, ``DoubleConv``,
``OutConv``'s first conv, and the inverted residual's bare project conv,
which is a ``ConvBNAct`` named ``project`` in the JAX package). The bare
logits convs stay unquantized, as there.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from tpuseg_torch.core.mesh import all_reduce_

# float32(1/127): the compiled JAX step's reciprocal of the grid's 127 levels
INV_LEVELS = 1.0 / 127.0


def act_scale(xf: torch.Tensor, mesh=None, spatial: bool = False) -> torch.Tensor:
    """The int8 step of the float32 activation ``xf``: max(absmax, 1e-8) *
    float32(1/127), its absmax the global batch's over ``mesh``'s data axis
    (the whole mesh with ``spatial``)."""
    absmax = xf.detach().abs().amax() if xf.numel() else xf.new_zeros(())
    if mesh is not None and mesh.axis_group(spatial) is not None:
        all_reduce_(absmax, mesh, mesh.axis_group(spatial), dist.ReduceOp.MAX)
    return torch.clamp(absmax, min=1e-8) * INV_LEVELS


def fake_quant_act(x: torch.Tensor, mesh=None, spatial: bool = False) -> torch.Tensor:
    """Per-tensor symmetric int8 fake-quant with the absmax range (of the
    global batch over ``mesh``'s data axis, or the whole mesh with
    ``spatial``)."""
    xf = x.to(torch.float32)
    scale = act_scale(xf, mesh, spatial)
    q = torch.round(xf / scale) * scale
    return (xf + (q - xf).detach()).to(x.dtype)


def fake_quant_kernel(weight: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric int8 fake-quant of a conv weight
    (output channels on dim 0)."""
    kf = weight.to(torch.float32)
    absmax = kf.detach().abs().amax(dim=tuple(range(1, kf.ndim)))
    scale = torch.where(absmax > 0, absmax * INV_LEVELS, 1.0).view(-1, *(1,) * (kf.ndim - 1))
    q = torch.clamp(torch.round(kf / scale), -127, 127) * scale
    return (kf + (q - kf).detach()).to(weight.dtype)


def qat_convs(model: nn.Module) -> List[Tuple[str, nn.Conv2d]]:
    """(name, conv) of every conv that QAT quantizes (see the module)."""
    from tpuseg_torch.models.blocks import BatchNorm2d, Conv2d

    out = []
    for name, seq in model.named_modules():
        if not isinstance(seq, nn.Sequential):
            continue
        layers = list(seq.named_children())
        for (key, m), (_, nxt) in zip(layers, layers[1:]):
            if isinstance(m, Conv2d) and isinstance(nxt, BatchNorm2d):
                out.append((f"{name}.{key}" if name else key, m))
    return out


def set_qat(model: nn.Module, on: bool = True) -> int:
    """Mark (or unmark) ``qat_convs(model)``: in train mode they run
    fake-quantized. Returns how many there are (``count_qat_markers``)."""
    convs = qat_convs(model)
    if not convs:
        raise ValueError("the model contains no conv+BatchNorm pairs to QAT")
    for _, conv in convs:
        conv.qat = on
    return len(convs)
