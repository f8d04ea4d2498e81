"""Full int8 inference: activation calibration, then int8 x int8 -> int32 convs.

The port of ``tpuseg/export/int8_full.py``. A calibration pass records
the largest absolute input of every conv followed by a BatchNorm (the
JAX package's ``ConvBNAct``; ``ops/fake_quant.py::qat_convs``, the convs
QAT trains for); then each of them runs as an exact int8 x int8 -> int32
conv (``ops/int8_conv.py``) with a per-tensor activation scale and
per-output-channel kernel scales, while BatchNorm, the activations and
the residual adds stay float (conv-only int8, as there):

    quant = calibrate(model, state_dict, batches)
    bind_quant(model, quant)           # model.eval(): the int8 route
    logits = model(x)

``quant`` maps each conv's module name to ``kernel_q`` (int8 OIHW),
``kernel_scale`` (float32 [Cout]), ``act_scale`` (float32, 0-d) and, for a
biased conv, ``bias``; ``save_quantized`` writes it beside the weights in
a checkpoint of the port, which ``Predictor`` serves in int8.

Speed on the H100 is measured by ``chip_smoke.py``'s export phase
(``PERF.md``); the JAX docstring's TPU numbers say nothing of it.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn

from tpuseg_torch.export.quantize import quantize_weight
from tpuseg_torch.ops.fake_quant import qat_convs

Quant = Dict[str, Dict[str, torch.Tensor]]


def calibrate(model: nn.Module, state_dict: Dict[str, torch.Tensor],
              batches: Iterable[torch.Tensor], percentile_headroom: float = 1.0) -> Quant:
    """Run the calibration ``batches`` (normalized NHWC float images, on the
    model's device) and return the ``quant`` data of every marked conv.

    The model runs in eval with ``state_dict`` loaded, no int8 bound, and
    ``use_pallas`` and ``up_subpixel`` off for the pass, so that every
    marked conv sees its input. Each batch's absmaxes are reduced on the
    device and fetched in one transfer; a conv's is the max over batches.
    ``act_scale = max(absmax * percentile_headroom, 1e-8) / 127``, taken in
    Python floats and rounded to float32 once."""
    model.load_state_dict(state_dict)
    bind_quant(model, None)
    convs = qat_convs(model)
    flags = {k: getattr(model, k) for k in ("use_pallas", "up_subpixel") if hasattr(model, k)}
    seen: Dict[str, torch.Tensor] = {}

    def hook(name):
        def record(module, args):
            seen[name] = args[0].detach().to(torch.float32).abs().amax()
        return record

    absmax: Dict[str, float] = {}
    hooks = [conv.register_forward_pre_hook(hook(name)) for name, conv in convs]
    was_training = model.training
    try:
        for k in flags:
            setattr(model, k, False)
        model.eval()
        with torch.no_grad():
            for x in batches:
                seen.clear()
                model(x.permute(0, 3, 1, 2))
                if seen:
                    names = list(seen)
                    values = torch.stack([seen[n] for n in names]).cpu().tolist()
                    for n, v in zip(names, values):
                        absmax[n] = max(absmax.get(n, 0.0), v)
    finally:
        for h in hooks:
            h.remove()
        for k, v in flags.items():
            setattr(model, k, v)
        model.train(was_training)
    if not absmax:
        raise ValueError("calibration captured no conv inputs")
    quant: Quant = {}
    for name, _ in convs:
        if name not in absmax:
            continue
        kernel_q, kernel_scale = quantize_weight(state_dict[f"{name}.weight"].cpu())
        node = {"kernel_q": kernel_q, "kernel_scale": kernel_scale,
                "act_scale": torch.tensor(np.float32(
                    max(absmax[name] * percentile_headroom, 1e-8) / 127.0))}
        if f"{name}.bias" in state_dict:
            node["bias"] = state_dict[f"{name}.bias"].cpu().to(torch.float32)
        quant[name] = node
    return quant


def bind_quant(model: nn.Module, quant: Optional[Quant]) -> nn.Module:
    """Give each conv named in ``quant`` its int8 data on the conv's device
    (the int8 route of ``models/blocks.py::Conv2d`` in eval), every other
    conv none; ``quant=None`` unbinds them all. KeyError for a name that
    is no conv of ``model``."""
    from tpuseg_torch.models.blocks import Conv2d

    convs = {name: m for name, m in model.named_modules() if isinstance(m, Conv2d)}
    missing = set(quant or {}) - set(convs)
    if missing:
        raise KeyError(f"quant names convs the model lacks: {sorted(missing)[:4]}")
    for name, conv in convs.items():
        q = (quant or {}).get(name)
        if q is None:
            conv.int8 = None
            continue
        dev = conv.weight.device
        act = q["act_scale"].to(dev, torch.float32).reshape(())
        conv.int8 = {"kernel_q": q["kernel_q"].to(dev),
                     "act_scale": act,
                     # the product formed first, in float32, as the JAX conv does
                     "scale": act * q["kernel_scale"].to(dev, torch.float32)}
        if "bias" in q:
            conv.int8["bias"] = q["bias"].to(dev, torch.float32)
    return model


def quantized_apply_fn(model: nn.Module, state_dict: Dict[str, torch.Tensor],
                       quant: Quant) -> Callable[[torch.Tensor], torch.Tensor]:
    """The int8 forward: normalized NHWC images -> NHWC logits (``model``
    left in eval with ``state_dict`` loaded and ``quant`` bound)."""
    model.load_state_dict(state_dict)
    bind_quant(model, quant).eval()

    def fn(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    return fn


def save_quantized(path: str, state_dict: Dict[str, torch.Tensor], quant: Quant) -> None:
    """Write a calibrated int8 model as step 0 of a checkpoint directory of
    the port (``{"model", "quant", "step"}``); ``Predictor`` serves it in
    int8."""
    from tpuseg_torch.core.checkpoint import CheckpointManager

    CheckpointManager(path, max_to_keep=1).save(
        0, {"model": {k: v.detach().cpu() for k, v in state_dict.items()},
            "quant": {n: {k: t.cpu() for k, t in q.items()} for n, q in quant.items()},
            "step": 0})


def count_quantized_convs(quant: Quant) -> int:
    return len(quant)
