"""Weights: seeded init, the Flax -> PyTorch bridge and reference ``.pth`` loading.

The port's ``state_dict`` uses the reference's key names (torchvision's
``backbone.features.N.conv.M.*``, the decoder's ``upK.conv.conv.{0,1,3,4}.*``
and ``outc.conv.{0,1,3}.*``; the UNet's ``inc``, ``downK.mpconv.1`` and
``sem_out``), so a reference checkpoint loads with
``load_state_dict(strict=True)``. FPN and DeepLab, which have no reference
checkpoint, take flax's module names (``lat5.0``, ``aspp.aspp_rate2.0``).

``state_dict_from_flax`` is the inverse of the JAX package's
``tpuseg/core/torch_import.py``, written afresh: HWIO kernels become OIHW
(depthwise ``[3,3,1,C]`` -> ``[C,1,3,3]``), BatchNorm ``scale``/``bias``
become ``weight``/``bias`` and ``mean``/``var`` become
``running_mean``/``running_var``. ``quant_from_flax`` maps a calibrated
int8 ``quant`` tree onto the port's conv names by the same mapping.

The mapping runs backwards too: ``flax_names`` reads it off
``state_dict_from_flax`` applied to a tree whose leaves are tags, and
``flax_variables`` uses it, on ``flax_template(model)`` (the flax tree
structure of a port model), to give a port state_dict the JAX package's
tree and scope names (the ONNX exporter's initializer names).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping, Tuple

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


def _double_conv(out: dict, base: str, p: Mapping, s: Mapping) -> None:
    _convbn(out, f"{base}.0", f"{base}.1", p["conv1"], s["conv1"])
    _convbn(out, f"{base}.3", f"{base}.4", p["conv2"], s["conv2"])


def _out_conv(out: dict, base: str, p: Mapping, s: Mapping) -> None:
    _convbn(out, f"{base}.0", f"{base}.1", p["conv1"], s["conv1"])
    _conv(out, f"{base}.3", p["conv2"])


def _encoder(out: dict, enc_p: Mapping, enc_s: Mapping) -> None:
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


def _by_name(out: dict, prefix: str, p: Mapping, s: Mapping) -> None:
    """A flax subtree whose module names are the port's: a ``ConvBNAct``
    (``conv`` + ``bn``) -> ``{prefix}.0``/``.1``, an ``nn.Conv`` ->
    ``{prefix}``, anything else recursed into."""
    if "kernel" in p:
        _conv(out, prefix, p)
    elif "conv" in p and "bn" in p:
        _convbn(out, f"{prefix}.0", f"{prefix}.1", p, s)
    else:
        for k in p:
            _by_name(out, f"{prefix}.{k}", p[k], s.get(k, {}))


def state_dict_from_flax(variables: Mapping,
                         dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{"params", "batch_stats"}`` tree of any registry
    family (numpy or JAX arrays) -> the port's state_dict, its floating
    tensors in ``dtype`` (float64 keeps an f64 tree exact).

    The family is read from the tree: ``inc`` is a UNet (a LightUNet nests
    it under ``unet``), ``up4`` the MobileNetV2UNet, and anything else
    (FPN, DeepLab) maps flax's module names one to one. ``stem_s2d`` uses
    the stem's own kernel, so it needs nothing here. A ``quant`` tree
    beside them is not part of the state_dict: ``quant_from_flax`` maps it."""
    params, stats = variables["params"], variables["batch_stats"]
    if "unet" in params:                      # LightUNet
        params, stats = params["unet"], stats["unet"]
    out: Dict[str, torch.Tensor] = {}
    if "inc" in params:                       # UNet: the reference's names
        _double_conv(out, "inc.conv.conv", params["inc"], stats["inc"])
        for k in ("down1", "down2", "down3"):
            _double_conv(out, f"{k}.mpconv.1.conv", params[k]["conv"], stats[k]["conv"])
        for k in ("up1", "up2", "up3"):
            _double_conv(out, f"{k}.conv.conv", params[k]["conv"], stats[k]["conv"])
        _out_conv(out, "sem_out.conv", params["sem_out"], stats["sem_out"])
    else:
        _encoder(out, params["backbone"], stats["backbone"])
        if "up4" in params:                   # MobileNetV2UNet
            for k in ("up1", "up2", "up3", "up4"):
                _double_conv(out, f"{k}.conv.conv", params[k]["conv"], stats[k]["conv"])
            _out_conv(out, "outc.conv", params["outc"], stats["outc"])
        else:                                 # FPN, DeepLab
            for k in params:
                if k != "backbone":
                    _by_name(out, k, params[k], stats.get(k, {}))
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in out.items()}


FlaxPath = Tuple[str, ...]


def _tagged(tree: Mapping, tags: list, path: FlaxPath = ()) -> dict:
    """``tree`` with each leaf replaced by a tag array: its index in
    ``tags`` (which records the leaf's path) plus one, 4-D for a kernel
    (``_oihw`` transposes it) and 1-D otherwise."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _tagged(v, tags, path + (k,))
        else:
            tags.append(path + (k,))
            out[k] = np.full((1, 1, 1, 1) if k == "kernel" else (1,), float(len(tags)))
    return out


def flax_names(variables: Mapping) -> Dict[str, Tuple[str, FlaxPath]]:
    """port state_dict key -> (collection, path) of the leaf of the flax
    ``{"params", "batch_stats"}`` tree ``variables`` that
    ``state_dict_from_flax`` maps there (``num_batches_tracked``, which no
    leaf holds, left out). Only the tree's structure is read."""
    tags: list = []
    tagged = {c: _tagged(variables.get(c, {}), tags, (c,)) for c in ("params", "batch_stats")}
    out = {}
    for key, value in state_dict_from_flax(tagged, dtype=torch.float64).items():
        if not key.endswith(".num_batches_tracked"):
            path = tags[int(value.reshape(-1)[0]) - 1]
            out[key] = (path[0], path[1:])
    return out


def quant_from_flax(variables: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's calibrated int8 ``quant`` tree (a node of
    ``kernel_q`` HWIO int8, ``kernel_scale``, ``act_scale`` and maybe
    ``bias`` per ``ConvBNAct``) -> the port's, keyed by conv module name
    (the node's ``conv`` kernel's key in ``state_dict_from_flax``), with
    ``kernel_q`` OIHW and the scales as they are."""
    by_path = {path[:-2]: key[: -len(".weight")]
               for key, (col, path) in flax_names(variables).items()
               if col == "params" and path[-2:] == ("conv", "kernel")}
    out: Dict[str, Dict[str, torch.Tensor]] = {}

    def walk(node: Mapping, path: FlaxPath) -> None:
        if "kernel_q" in node:
            if path not in by_path:
                raise KeyError(f"quant node {'/'.join(path)} has no conv in the params")
            q = {"kernel_q": _oihw(node["kernel_q"]),
                 "kernel_scale": _t(np.asarray(node["kernel_scale"], np.float32)),
                 "act_scale": _t(np.asarray(node["act_scale"], np.float32).reshape(()))}
            if "bias" in node:
                q["bias"] = _t(np.asarray(node["bias"], np.float32))
            out[by_path[path]] = q
            return
        for k, v in node.items():
            if not isinstance(v, Mapping):
                raise ValueError(f"quant leaf {'/'.join(path + (k,))} outside a conv's node")
            walk(v, path + (k,))

    walk(variables["quant"], ())
    return out


def flax_template(model: nn.Module) -> Dict[str, Any]:
    """The flax ``{"params", "batch_stats"}`` tree structure of the port's
    ``model`` (any registry family): the module names and leaves the JAX
    package's model of the same configuration has, every leaf None."""
    from tpuseg_torch.models.blocks import (Conv2d, ConvBNAct, DoubleConv, Down, InConv,
                                            OutConv, Up)
    from tpuseg_torch.models.mobilenetv2 import InvertedResidual, MobileNetV2Encoder
    from tpuseg_torch.models.unet import LightUNet

    def conv(m):
        return {"kernel": None, **({"bias": None} if m.bias is not None else {})}, {}

    def convbn(m):
        return ({"conv": conv(m)[0], "bn": {"scale": None, "bias": None}},
                {"bn": {"mean": None, "var": None}})

    def node(named):
        params, stats = {}, {}
        for name, (p, s) in named:
            params[name] = p
            if s:
                stats[name] = s
        return params, stats

    def walk(m):
        if isinstance(m, Conv2d):
            return conv(m)
        if isinstance(m, ConvBNAct):
            return convbn(m[0])
        if isinstance(m, DoubleConv):
            return node([("conv1", convbn(m.conv[0])), ("conv2", convbn(m.conv[3]))])
        if isinstance(m, InConv):
            return walk(m.conv)
        if isinstance(m, (Down, Up)):
            return node([("conv", walk(m.mpconv[1] if isinstance(m, Down) else m.conv))])
        if isinstance(m, OutConv):
            return node([("conv1", convbn(m.conv[0])), ("conv2", conv(m.conv[3]))])
        if isinstance(m, InvertedResidual):
            layers = list(m.conv)
            named = [("expand", convbn(layers[0][0]))] if len(layers) == 4 else []
            return node(named + [("depthwise", convbn(layers[-3][0])),
                                 ("project", convbn(layers[-2]))])
        if isinstance(m, MobileNetV2Encoder):
            return node([(f"features_{i}", walk(f)) for i, f in enumerate(m.features)])
        return node([(name, walk(c)) for name, c in m.named_children()])

    params, stats = walk(model)
    if isinstance(model, LightUNet):
        params, stats = {"unet": params}, {"unet": stats}
    return {"params": params, "batch_stats": stats}


def flax_variables(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``state_dict`` of the port's ``model`` as the JAX package's flax tree
    of numpy arrays (HWIO kernels): ``state_dict_from_flax``'s inverse."""
    names = flax_names(flax_template(model))
    if set(names) != {k for k in state_dict if not k.endswith(".num_batches_tracked")}:
        raise KeyError(f"the state_dict's keys are not {type(model).__name__}'s")
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, (col, path) in names.items():
        value = state_dict[key].detach().cpu().numpy()
        if path[-1] == "kernel":
            value = np.ascontiguousarray(value.transpose(2, 3, 1, 0))
        node = out[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return out


def drop_encoder_slices(raw: Mapping[str, torch.Tensor],
                        where: str = "state_dict") -> Dict[str, torch.Tensor]:
    """``raw`` without the reference's duplicate encoder keys.

    The reference registers the encoder slices twice, as ``down1..down5``
    (``features[2:4]`` and so on; a slice of a Sequential keeps the feature
    indices, so ``downK.N.*`` is ``backbone.features.N.*``). Those keys are
    checked to equal their originals and dropped (ValueError naming
    ``where`` otherwise)."""
    out = {}
    for k, v in raw.items():
        m = re.fullmatch(r"down[1-5]\.(\d+\..+)", k)
        if m is None:
            out[k] = v
            continue
        orig = f"backbone.features.{m[1]}"
        if orig not in raw or not torch.equal(raw[orig], v):
            raise ValueError(
                f"{where}: duplicate key {k!r} does not equal {orig!r}"
            )
    return out


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` state_dict (any family) for the port, its
    duplicate encoder keys dropped (``drop_encoder_slices``)."""
    return drop_encoder_slices(torch.load(path, map_location="cpu", weights_only=True), path)
