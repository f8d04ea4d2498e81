"""Weights: seeded init, the Flax -> PyTorch bridge and reference ``.pth`` loading.

The port's ``state_dict`` uses the reference's key names (torchvision's
``backbone.features.N.conv.M.*``, the decoder's ``upK.conv.conv.{0,1,3,4}.*``
and ``outc.conv.{0,1,3}.*``), so a reference checkpoint loads with
``load_state_dict(strict=True)``.

``state_dict_from_flax`` is the inverse of the JAX package's
``tpuseg/core/torch_import.py``, written afresh: HWIO kernels become OIHW
(depthwise ``[3,3,1,C]`` -> ``[C,1,3,3]``), BatchNorm ``scale``/``bias``
become ``weight``/``bias`` and ``mean``/``var`` become
``running_mean``/``running_var``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def init_weights(model: nn.Module, generator: torch.Generator,
                 random_bn: bool = False) -> None:
    """Seeded in-place init of every conv and BatchNorm of ``model``.

    Convs: He-uniform (variance 2/fan_in, which keeps activations alive
    through the 50-odd ReLU layers), biases U(+-1/sqrt(fan_in)).
    BatchNorm: identity (weight 1, bias 0, running mean 0, var 1), or with
    ``random_bn`` non-trivial affine and running statistics, so that a
    smoke run exercises the running-stat path."""
    g = generator
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                bound = math.sqrt(6.0 / fan_in)
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    b = 1.0 / math.sqrt(fan_in)
                    m.bias.uniform_(-b, b, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                if random_bn:
                    m.weight.uniform_(0.5, 1.5, generator=g)
                    m.bias.uniform_(-0.2, 0.2, generator=g)
                    m.running_mean.uniform_(-0.2, 0.2, generator=g)
                    m.running_var.uniform_(0.5, 1.5, generator=g)
                else:
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _oihw(kernel) -> torch.Tensor:
    return _t(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def _bn(out: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(s["mean"])
    out[f"{prefix}.running_var"] = _t(s["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _conv(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _oihw(p["kernel"])
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _convbn(out: dict, conv: str, bn: str, p: Mapping, s: Mapping) -> None:
    _conv(out, conv, p["conv"])
    _bn(out, bn, p["bn"], s["bn"])


def state_dict_from_flax(variables: Mapping,
                         dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params", "batch_stats"}`` tree of a
    MobileNetV2UNet (numpy or JAX arrays) -> the port's state_dict, its
    floating tensors in ``dtype`` (float64 keeps an f64 tree exact)."""
    if "quant" in variables:
        raise NotImplementedError(
            "int8 'quant' variables are not ported yet (ROADMAP.md, queue "
            "B: int8/QAT)"
        )
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    enc_p, enc_s = params["backbone"], stats["backbone"]
    n_feats = len(enc_p)
    for i in range(n_feats):
        p, s = enc_p[f"features_{i}"], enc_s[f"features_{i}"]
        base = f"backbone.features.{i}"
        if i in (0, n_feats - 1):  # stem and last 1x1: ConvBNAct
            _convbn(out, f"{base}.0", f"{base}.1", p, s)
            continue
        j = 0
        if "expand" in p:
            _convbn(out, f"{base}.conv.0.0", f"{base}.conv.0.1",
                    p["expand"], s["expand"])
            j = 1
        _convbn(out, f"{base}.conv.{j}.0", f"{base}.conv.{j}.1",
                p["depthwise"], s["depthwise"])
        _conv(out, f"{base}.conv.{j + 1}", p["project"]["conv"])
        _bn(out, f"{base}.conv.{j + 2}", p["project"]["bn"], s["project"]["bn"])
    for k in ("up1", "up2", "up3", "up4"):
        p, s = params[k]["conv"], stats[k]["conv"]
        base = f"{k}.conv.conv"
        _convbn(out, f"{base}.0", f"{base}.1", p["conv1"], s["conv1"])
        _convbn(out, f"{base}.3", f"{base}.4", p["conv2"], s["conv2"])
    p, s = params["outc"], stats["outc"]
    _convbn(out, "outc.conv.0", "outc.conv.1", p["conv1"], s["conv1"])
    _conv(out, "outc.conv.3", p["conv2"])
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in out.items()}


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference MobileNetV2UNet ``.pth`` state_dict for the port.

    The reference registers the encoder slices twice, as ``down1..down5``
    (``features[2:4]`` and so on; a slice of a Sequential keeps the feature
    indices, so ``downK.N.*`` is ``backbone.features.N.*``). Those duplicate
    keys are checked to equal their originals and dropped."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in raw.items():
        m = re.fullmatch(r"down[1-5]\.(\d+\..+)", k)
        if m is None:
            out[k] = v
            continue
        orig = f"backbone.features.{m[1]}"
        if orig not in raw or not torch.equal(raw[orig], v):
            raise ValueError(
                f"{path}: duplicate key {k!r} does not equal {orig!r}"
            )
    return out
