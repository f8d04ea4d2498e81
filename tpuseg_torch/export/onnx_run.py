"""Execute an exported ONNX file with torch ops — the round-trip self-check.

The port of ``tpuseg/export/onnx_run.py``. Neither ``onnx`` nor
``onnxruntime`` is needed: the serialized protobuf is parsed back
(``onnx_proto.parse_model``) and the graph executed by this minimal
interpreter, on the CPU or the card. It implements exactly the op set the
exporter emits — Conv / BatchNormalization / Relu / Clip / Add / Concat /
MaxPool / GlobalAveragePool / Resize (linear + nearest) / Identity — from
the ONNX operator spec (opset 12), independently of the port's modules, so
agreement with the live model validates the wire encoding and the emitted
graph. Each op computes as the JAX interpreter does: BatchNormalization's
per-channel factor ``scale * (1 / sqrt(var + eps))`` in float64, rounded to
float32 once; Resize from the spec's coordinate formulas (its indices and
fractions made on the host in float64, the fractions rounded to float32),
the two taps blended in float32; the conv bias added after the conv.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.export.onnx_proto import parse_model

Feed = Union[np.ndarray, torch.Tensor]


def _conv(x, w, b, attrs):
    pads = attrs.get("pads", [0, 0, 0, 0])
    if pads[0] != pads[2] or pads[1] != pads[3]:
        x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
        pads = [0, 0, 0, 0]
    y = F.conv2d(x, w, None, stride=tuple(attrs.get("strides", [1, 1])),
                 padding=(pads[0], pads[1]), dilation=tuple(attrs.get("dilations", [1, 1])),
                 groups=int(attrs.get("group", 1)))
    return y if b is None else y + b.view(1, -1, 1, 1)


def _batch_norm(x, scale, bias, mean, var, attrs):
    eps = attrs.get("epsilon", 1e-5)
    factor = scale.double() * (1.0 / torch.sqrt(var.double() + eps))
    shape = (1, -1, 1, 1)
    return (x - mean.view(shape)) * factor.to(torch.float32).view(shape) + bias.view(shape)


def _linear_coords(out_size: int, in_size: int, scale: float, mode: str):
    """ONNX Resize coordinate transform -> (idx0, idx1, frac) arrays."""
    i = np.arange(out_size, dtype=np.float64)
    if mode == "align_corners":
        x = i * (in_size - 1) / max(out_size - 1, 1)
    elif mode in ("pytorch_half_pixel", "half_pixel"):
        if mode == "pytorch_half_pixel" and out_size <= 1:
            x = np.zeros_like(i)
        else:
            x = (i + 0.5) / scale - 0.5
    elif mode == "asymmetric":
        x = i / scale
    else:
        raise NotImplementedError(f"coordinate mode {mode!r}")
    x0 = np.floor(x)
    frac = (x - x0).astype(np.float32)
    i0 = np.clip(x0, 0, in_size - 1).astype(np.int64)
    i1 = np.clip(x0 + 1, 0, in_size - 1).astype(np.int64)
    return i0, i1, frac


def _resize(x, scales, attrs):
    if not (scales[0] == scales[1] == 1.0):
        raise NotImplementedError("batch/channel Resize scales must be 1")
    coord = attrs.get("coordinate_transformation_mode", "half_pixel")
    n, c, h, w = x.shape
    oh, ow = int(round(h * scales[2])), int(round(w * scales[3]))
    mode = attrs.get("mode", "nearest")
    dev = x.device
    if mode == "nearest":
        # the exporter emits asymmetric+floor only (a repeat for integer
        # upscales; a broadcast from a 1x1 input)
        if coord != "asymmetric" or attrs.get("nearest_mode") != "floor":
            raise NotImplementedError("only asymmetric/floor nearest Resize is emitted")
        r = np.clip(np.floor(np.arange(oh) / scales[2]), 0, h - 1).astype(np.int64)
        cc = np.clip(np.floor(np.arange(ow) / scales[3]), 0, w - 1).astype(np.int64)
        return x[:, :, torch.from_numpy(r).to(dev)][:, :, :, torch.from_numpy(cc).to(dev)]
    if mode != "linear":
        raise NotImplementedError(f"Resize mode {mode!r}")
    # separable bilinear: rows then columns
    r0, r1, rf = _linear_coords(oh, h, scales[2], coord)
    rf = torch.from_numpy(rf).to(dev).view(1, 1, -1, 1)
    x = (x[:, :, torch.from_numpy(r0).to(dev)] * (1.0 - rf)
         + x[:, :, torch.from_numpy(r1).to(dev)] * rf)
    c0, c1, cf = _linear_coords(ow, w, scales[3], coord)
    cf = torch.from_numpy(cf).to(dev).view(1, 1, 1, -1)
    return (x[:, :, :, torch.from_numpy(c0).to(dev)] * (1.0 - cf)
            + x[:, :, :, torch.from_numpy(c1).to(dev)] * cf)


def run_model(model: Union[bytes, Dict[str, Any]], feeds: Dict[str, Feed],
              device: Optional[Union[str, torch.device]] = None) -> Dict[str, np.ndarray]:
    """Execute a parsed (or serialized) model on ``device`` (None: the
    device of the first tensor fed, the CPU for numpy feeds); returns
    {output_name: numpy value}."""
    if isinstance(model, (bytes, bytearray)):
        model = parse_model(bytes(model))
    if device is None:
        device = next((f.device for f in feeds.values() if isinstance(f, torch.Tensor)), "cpu")
    graph = model["graph"]
    env: Dict[str, torch.Tensor] = {k: torch.from_numpy(np.array(v)).to(device)
                                    for k, v in graph["initializers"].items()}
    for vi in graph["inputs"]:
        name = vi["name"]
        if name not in feeds:
            raise KeyError(f"missing graph input {name!r}")
        env[name] = torch.as_tensor(feeds[name]).to(device, torch.float32)

    with torch.no_grad():
        for node in graph["nodes"]:
            op_type = node["op_type"]
            # "" marks an omitted optional input (Resize's roi slot)
            ins = [env[i] if i else None for i in node["input"]]
            attrs = node["attrs"]
            if op_type == "Conv":
                out = _conv(ins[0], ins[1], ins[2] if len(ins) > 2 else None, attrs)
            elif op_type == "BatchNormalization":
                out = _batch_norm(ins[0], ins[1], ins[2], ins[3], ins[4], attrs)
            elif op_type == "Relu":
                out = torch.clamp(ins[0], min=0.0)
            elif op_type == "Clip":
                out = torch.clamp(ins[0], ins[1], ins[2])
            elif op_type == "Add":
                out = ins[0] + ins[1]
            elif op_type == "Concat":
                out = torch.cat(ins, dim=attrs["axis"])
            elif op_type == "MaxPool":
                out = F.max_pool2d(ins[0], attrs["kernel_shape"],
                                   attrs.get("strides", attrs["kernel_shape"]))
            elif op_type == "GlobalAveragePool":
                out = ins[0].double().mean(dim=(2, 3), keepdim=True).to(torch.float32)
            elif op_type == "Resize":
                out = _resize(ins[0], ins[2].cpu().double().tolist(), attrs)
            elif op_type == "Identity":
                out = ins[0]
            else:
                raise NotImplementedError(f"op {op_type!r}")
            env[node["output"][0]] = out

    return {vi["name"]: env[vi["name"]].cpu().numpy() for vi in graph["outputs"]}


def check_model(model: Union[bytes, Dict[str, Any]]) -> List[str]:
    """Structural validation (the onnx.checker analogue): every node input
    resolves to a prior value, nodes are topologically ordered, the graph
    outputs are produced, and an opset is declared. Returns a list of
    problems (empty == valid)."""
    if isinstance(model, (bytes, bytearray)):
        model = parse_model(bytes(model))
    problems: List[str] = []
    graph = model["graph"]
    known = set(graph["initializers"]) | {v["name"] for v in graph["inputs"]}
    for node in graph["nodes"]:
        for i in node["input"]:
            if i and i not in known:
                problems.append(
                    f"node {node['name'] or node['op_type']}: "
                    f"unresolved input {i!r}"
                )
        for o in node["output"]:
            known.add(o)
    for vi in graph["outputs"]:
        if vi["name"] not in known:
            problems.append(f"graph output {vi['name']!r} never produced")
    if not model.get("opset_import"):
        problems.append("missing opset_import")
    return problems
