"""ONNX export of the port's models — the same bytes as the JAX package's.

The port of ``tpuseg/export/onnx_export.py``: an ONNX opset-12 graph with a
dynamic (or static) batch axis, input "input" [batch, 3, H, W] and output
"output" (logits), written with the copied protobuf codec
(``onnx_proto``), no ``onnx`` package needed. ``export_onnx(model,
state_dict, ...)`` gives the state_dict the JAX package's flax tree and
scope names (``core/weights.py::flax_variables``, the inverse of
``state_dict_from_flax``) and walks it with the JAX emitters, copied here
unchanged: the same node order, node names, attributes and initializer
names (``backbone.features_0.weight``, ``up1.conv1.bn.scale``), so for the
same weights both packages write the same bytes.

    Conv(incl. dilated) / BatchNormalization / Relu / Clip(0,6) / Add /
    Concat / MaxPool / GlobalAveragePool /
    Resize(linear, pytorch_half_pixel | align_corners; nearest, asymmetric)

All five registry families export. BatchNorm is exported as it is
(running stats, eps 1e-5), not folded. ``onnx_run`` executes the file back
as the self-check (``python -m tpuseg_torch.convert --export.format=onnx``).
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from tpuseg_torch.export import onnx_proto as op
from tpuseg_torch.models.mobilenetv2 import INVERTED_RESIDUAL_SETTINGS, STAGE_TAPS, make_divisible


class GraphBuilder:
    """Accumulates nodes + initializers; one method per emitted op type."""

    def __init__(self) -> None:
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self._init_names: set = set()
        self._counter = 0

    def _fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def add_initializer(self, name: str, array: np.ndarray) -> str:
        if name in self._init_names:
            raise ValueError(f"duplicate initializer {name!r}")
        self._init_names.add(name)
        self.initializers.append(op.tensor_proto(name, array))
        return name

    def conv(
        self,
        x: str,
        scope: str,
        kernel: np.ndarray,
        bias: Optional[np.ndarray],
        strides: Sequence[int] = (1, 1),
        pads: Sequence[int] = (0, 0, 0, 0),
        group: int = 1,
        dilations: Sequence[int] = (1, 1),
    ) -> str:
        """kernel is Flax HWIO (kh, kw, cin/group, cout) -> OIHW."""
        w = np.ascontiguousarray(
            np.asarray(kernel, np.float32).transpose(3, 2, 0, 1)
        )
        inputs = [x, self.add_initializer(f"{scope}.weight", w)]
        if bias is not None:
            inputs.append(
                self.add_initializer(
                    f"{scope}.bias", np.asarray(bias, np.float32)
                )
            )
        out = self._fresh(scope)
        self.nodes.append(
            op.node_proto(
                "Conv",
                inputs,
                [out],
                name=scope,
                dilations=[int(d) for d in dilations],
                group=int(group),
                kernel_shape=[int(w.shape[2]), int(w.shape[3])],
                pads=[int(p) for p in pads],
                strides=[int(s) for s in strides],
            )
        )
        return out

    def batch_norm(self, x: str, scope: str, bn_params, bn_stats) -> str:
        """Inference-mode BatchNormalization from a ConvBNAct's bn leaves."""
        inputs = [
            x,
            self.add_initializer(
                f"{scope}.scale", np.asarray(bn_params["scale"], np.float32)
            ),
            self.add_initializer(
                f"{scope}.B", np.asarray(bn_params["bias"], np.float32)
            ),
            self.add_initializer(
                f"{scope}.mean", np.asarray(bn_stats["mean"], np.float32)
            ),
            self.add_initializer(
                f"{scope}.var", np.asarray(bn_stats["var"], np.float32)
            ),
        ]
        out = self._fresh(scope)
        self.nodes.append(
            op.node_proto(
                "BatchNormalization", inputs, [out], name=scope, epsilon=1e-5
            )
        )
        return out

    def relu(self, x: str) -> str:
        out = self._fresh("relu")
        self.nodes.append(op.node_proto("Relu", [x], [out]))
        return out

    def relu6(self, x: str) -> str:
        """Clip(0, 6) — opset 11+ takes min/max as inputs, not attributes."""
        if "clip_min" not in self._init_names:
            self.add_initializer("clip_min", np.float32(0.0))
            self.add_initializer("clip_max", np.float32(6.0))
        out = self._fresh("relu6")
        self.nodes.append(
            op.node_proto("Clip", [x, "clip_min", "clip_max"], [out])
        )
        return out

    def add(self, a: str, b: str) -> str:
        out = self._fresh("add")
        self.nodes.append(op.node_proto("Add", [a, b], [out]))
        return out

    def concat(self, xs: Sequence[str]) -> str:
        out = self._fresh("concat")
        self.nodes.append(op.node_proto("Concat", list(xs), [out], axis=1))
        return out

    def max_pool2(self, x: str) -> str:
        out = self._fresh("pool")
        self.nodes.append(
            op.node_proto(
                "MaxPool",
                [x],
                [out],
                kernel_shape=[2, 2],
                pads=[0, 0, 0, 0],
                strides=[2, 2],
            )
        )
        return out

    def resize2x(self, x: str, align_corners: bool) -> str:
        """Bilinear x2. align_corners=False maps to the reference decoder's
        nn.Upsample default (src/unet.py:97 -> 'pytorch_half_pixel', the
        string torch.onnx itself emits); True maps to the final upsample
        (src/unet.py:30 -> 'align_corners')."""
        if "resize_scales" not in self._init_names:
            self.add_initializer(
                "resize_scales", np.asarray([1.0, 1.0, 2.0, 2.0], np.float32)
            )
        out = self._fresh("resize")
        mode = "align_corners" if align_corners else "pytorch_half_pixel"
        self.nodes.append(
            op.node_proto(
                "Resize",
                [x, "", "resize_scales"],  # roi is the empty optional input
                [out],
                coordinate_transformation_mode=mode,
                mode="linear",
            )
        )
        return out

    def resize_nearest(self, x: str, sh: float, sw: float) -> str:
        """Nearest resize by (sh, sw) — asymmetric + floor == jnp.repeat
        for integer 2x (FPN top-down), and a pure spatial broadcast when the
        input is 1x1 (the ASPP image-pooling branch)."""
        name = f"nearest_scales_{sh:g}x{sw:g}"
        if name not in self._init_names:
            self.add_initializer(
                name, np.asarray([1.0, 1.0, sh, sw], np.float32)
            )
        out = self._fresh("resize_nearest")
        self.nodes.append(
            op.node_proto(
                "Resize",
                [x, "", name],
                [out],
                coordinate_transformation_mode="asymmetric",
                mode="nearest",
                nearest_mode="floor",
            )
        )
        return out

    def global_avg_pool(self, x: str) -> str:
        out = self._fresh("gap")
        self.nodes.append(op.node_proto("GlobalAveragePool", [x], [out]))
        return out

    # ---- composite emitters over the Flax param tree ----------------------

    def conv_bn_act(
        self,
        x: str,
        scope: str,
        params: Dict[str, Any],
        stats: Dict[str, Any],
        act: Optional[str] = "relu",
        strides: Sequence[int] = (1, 1),
        pads: Sequence[int] = (1, 1, 1, 1),
        group: int = 1,
        dilations: Sequence[int] = (1, 1),
    ) -> str:
        """One ConvBNAct module (the JAX package's ConvBNAct)."""
        conv = params["conv"]
        x = self.conv(
            x,
            scope,
            conv["kernel"],
            conv.get("bias"),
            strides=strides,
            pads=pads,
            group=group,
            dilations=dilations,
        )
        x = self.batch_norm(x, f"{scope}.bn", params["bn"], stats["bn"])
        if act == "relu":
            return self.relu(x)
        if act == "relu6":
            return self.relu6(x)
        return x

    def double_conv(self, x: str, scope: str, params, stats) -> str:
        """DoubleConv: (Conv3x3 -> BN -> ReLU) x 2 (reference src/unet.py:53-68)."""
        x = self.conv_bn_act(
            x, f"{scope}.conv1", params["conv1"], stats["conv1"]
        )
        return self.conv_bn_act(
            x, f"{scope}.conv2", params["conv2"], stats["conv2"]
        )

    def up(self, x: str, skip: str, scope: str, params, stats) -> str:
        """Up block: bilinear x2 (ac=False), concat [skip, up], DoubleConv
        (reference src/unet.py:94-105; skip is the FIRST concat operand)."""
        x = self.resize2x(x, align_corners=False)
        x = self.concat([skip, x])
        return self.double_conv(x, scope, params["conv"], stats["conv"])

    def out_conv(self, x: str, scope: str, params, stats) -> str:
        """OutConv head: Conv1x1 -> BN -> ReLU -> Conv1x1 (src/unet.py:108-121)."""
        x = self.conv_bn_act(
            x,
            f"{scope}.conv1",
            params["conv1"],
            stats["conv1"],
            pads=(0, 0, 0, 0),
        )
        conv2 = params["conv2"]
        return self.conv(
            x, f"{scope}.conv2", conv2["kernel"], conv2.get("bias"),
            pads=(0, 0, 0, 0),
        )


# ---------------------------------------------------------------------------
# Per-model graph emitters


def _emit_mobilenetv2_encoder(
    g: GraphBuilder, x: str, params, stats, width_mult: float = 1.0
) -> List[str]:
    """MobileNetV2 features_0..18, returning the five UNet skip taps
    (torchvision graph per the JAX package's mobilenetv2; reference
    src/unet.py:15-19)."""
    taps: List[str] = []
    x = g.conv_bn_act(
        x, "backbone.features_0", params["features_0"], stats["features_0"],
        act="relu6", strides=(2, 2),
    )
    idx = 1
    cin = make_divisible(32 * width_mult)
    for t, c, n, s in INVERTED_RESIDUAL_SETTINGS:
        cout = make_divisible(c * width_mult)
        for i in range(n):
            stride = s if i == 0 else 1
            scope = f"backbone.features_{idx}"
            p, st = params[f"features_{idx}"], stats[f"features_{idx}"]
            hidden = cin * t
            y = x
            if t != 1:
                y = g.conv_bn_act(
                    y, f"{scope}.expand", p["expand"], st["expand"],
                    act="relu6", pads=(0, 0, 0, 0),
                )
            y = g.conv_bn_act(
                y, f"{scope}.depthwise", p["depthwise"], st["depthwise"],
                act="relu6", strides=(stride, stride), group=hidden,
            )
            y = g.conv_bn_act(
                y, f"{scope}.project", p["project"], st["project"],
                act=None, pads=(0, 0, 0, 0),
            )
            x = g.add(x, y) if stride == 1 and cin == cout else y
            cin = cout
            if idx in STAGE_TAPS:
                taps.append(x)
            idx += 1
    x = g.conv_bn_act(
        x, "backbone.features_18", params["features_18"],
        stats["features_18"], act="relu6", pads=(0, 0, 0, 0),
    )
    taps.append(x)
    return taps


def _emit_mobilenetv2_unet(g: GraphBuilder, x: str, variables, spec) -> str:
    params, stats = variables["params"], variables["batch_stats"]
    x1, x2, x3, x4, x5 = _emit_mobilenetv2_encoder(
        g, x, params["backbone"], stats["backbone"],
        width_mult=spec.width_mult,
    )
    y = g.up(x5, x4, "up1", params["up1"], stats["up1"])
    y = g.up(y, x3, "up2", params["up2"], stats["up2"])
    y = g.up(y, x2, "up3", params["up3"], stats["up3"])
    y = g.up(y, x1, "up4", params["up4"], stats["up4"])
    y = g.out_conv(y, "outc", params["outc"], stats["outc"])
    if not spec.upsample_head:
        # serving config that fuses the final upsample into the consumer
        # (the fused upsample2x_argmax head): logits at H/2
        return y
    # final x2 with align_corners=True (reference src/unet.py:30)
    return g.resize2x(y, align_corners=True)


def _emit_unet(g: GraphBuilder, x: str, variables) -> str:
    params, stats = variables["params"], variables["batch_stats"]
    x1 = g.double_conv(x, "inc", params["inc"], stats["inc"])
    x2 = g.max_pool2(x1)
    x2 = g.double_conv(
        x2, "down1", params["down1"]["conv"], stats["down1"]["conv"]
    )
    x3 = g.max_pool2(x2)
    x3 = g.double_conv(
        x3, "down2", params["down2"]["conv"], stats["down2"]["conv"]
    )
    x4 = g.max_pool2(x3)
    x4 = g.double_conv(
        x4, "down3", params["down3"]["conv"], stats["down3"]["conv"]
    )
    y = g.up(x4, x3, "up1", params["up1"], stats["up1"])
    y = g.up(y, x2, "up2", params["up2"], stats["up2"])
    y = g.up(y, x1, "up3", params["up3"], stats["up3"])
    return g.out_conv(y, "sem_out", params["sem_out"], stats["sem_out"])


def _emit_fpn(g: GraphBuilder, x: str, variables, spec) -> str:
    """MobileNetV2FPN : lateral 1x1s, nearest-2x
    top-down adds, per-level heads cascaded-2x'd to 1/4 and summed, 1x1
    classifier, x4. Cascaded linear Resize(pytorch_half_pixel) IS the
    family's definition of Nx bilinear (ops.resize.up_pow2_bilinear)."""
    params, stats = variables["params"], variables["batch_stats"]
    _, c2, c3, c4, c5 = _emit_mobilenetv2_encoder(
        g, x, params["backbone"], stats["backbone"],
        width_mult=spec.width_mult,
    )

    def lat(name, tap):
        return g.conv_bn_act(
            tap, name, params[name], stats[name], act=None, pads=(0, 0, 0, 0)
        )

    p5 = lat("lat5", c5)
    p4 = g.add(lat("lat4", c4), g.resize_nearest(p5, 2.0, 2.0))
    p3 = g.add(lat("lat3", c3), g.resize_nearest(p4, 2.0, 2.0))
    p2 = g.add(lat("lat2", c2), g.resize_nearest(p3, 2.0, 2.0))
    y = None
    for steps, (smooth, head, p) in enumerate(
        (("smooth2", "head2", p2), ("smooth3", "head3", p3),
         ("smooth4", "head4", p4), ("smooth5", "head5", p5))
    ):
        h = g.conv_bn_act(p, smooth, params[smooth], stats[smooth])
        h = g.conv_bn_act(h, head, params[head], stats[head])
        for _ in range(steps):
            h = g.resize2x(h, align_corners=False)
        y = h if y is None else g.add(y, h)
    cls = params["classifier"]
    y = g.conv(
        y, "classifier", cls["kernel"], cls.get("bias"), pads=(0, 0, 0, 0)
    )
    y = g.resize2x(y, align_corners=False)
    return g.resize2x(y, align_corners=False)


def _emit_deeplab(g: GraphBuilder, x: str, variables, spec, height, width) -> str:
    """MobileNetV2DeepLab : ASPP at 1/32 (1x1 +
    dilated 3x3s + image pooling broadcast), x8 cascaded-2x, one low-level
    1/4 skip, two refines, classifier, x4."""
    params, stats = variables["params"], variables["batch_stats"]
    _, c2, _, _, c5 = _emit_mobilenetv2_encoder(
        g, x, params["backbone"], stats["backbone"],
        width_mult=spec.width_mult,
    )
    ap, ast = params["aspp"], stats["aspp"]
    branches = [
        g.conv_bn_act(
            c5, "aspp.conv1x1", ap["aspp_conv1x1"], ast["aspp_conv1x1"],
            pads=(0, 0, 0, 0),
        )
    ]
    for r in spec.aspp_rates:
        branches.append(
            g.conv_bn_act(
                c5, f"aspp.rate{r}", ap[f"aspp_rate{r}"], ast[f"aspp_rate{r}"],
                pads=(r, r, r, r), dilations=(r, r),
            )
        )
    pooled = g.global_avg_pool(c5)
    pooled = g.conv_bn_act(
        pooled, "aspp.pool", ap["aspp_pool"], ast["aspp_pool"],
        pads=(0, 0, 0, 0),
    )
    # broadcast the 1x1 pooled branch back to the c5 grid
    branches.append(
        g.resize_nearest(pooled, float(height // 32), float(width // 32))
    )
    y = g.concat(branches)
    y = g.conv_bn_act(
        y, "aspp.project", ap["project"], ast["project"], pads=(0, 0, 0, 0)
    )
    for _ in range(3):  # 1/32 -> 1/4
        y = g.resize2x(y, align_corners=False)
    low = g.conv_bn_act(
        c2, "low_project", params["low_project"], stats["low_project"],
        pads=(0, 0, 0, 0),
    )
    y = g.concat([low, y])
    y = g.conv_bn_act(y, "refine1", params["refine1"], stats["refine1"])
    y = g.conv_bn_act(y, "refine2", params["refine2"], stats["refine2"])
    cls = params["classifier"]
    y = g.conv(
        y, "classifier", cls["kernel"], cls.get("bias"), pads=(0, 0, 0, 0)
    )
    y = g.resize2x(y, align_corners=False)
    return g.resize2x(y, align_corners=False)


def export_onnx(
    model,
    state_dict: Mapping[str, torch.Tensor],
    height: int,
    width: int,
    path: str = "",
    batch: int = -1,
) -> bytes:
    """Serialize the port's ``model`` with ``state_dict`` to ONNX opset-12 bytes.

    batch=-1 emits a symbolic 'batch' dim_param on input and output; the
    graph input is NCHW ``[batch, 3, height, width]`` float32 named "input"
    and the output is logits named "output". A MobileNetV2UNet with
    ``upsample_head=False`` ends at the half-resolution logits. ValueError
    when height or width is not a multiple of the family's 32 (MobileNetV2
    encoders) or 8 (UNets), as the JAX exporter checks."""
    from tpuseg_torch.core import weights
    from tpuseg_torch.models.deeplab import MobileNetV2DeepLab
    from tpuseg_torch.models.fpn import MobileNetV2FPN
    from tpuseg_torch.models.mobilenetv2_unet import MobileNetV2UNet
    from tpuseg_torch.models.unet import LightUNet, UNet

    # the emitted cascaded 2x resizes (and deeplab's pooled-branch
    # broadcast, which scales by height // 32) must land on the encoder
    # grids: fail here, not inside the downstream ONNX consumer
    if isinstance(model, (MobileNetV2UNet, MobileNetV2FPN, MobileNetV2DeepLab)):
        down = 32
    elif isinstance(model, UNet):
        down = 8
    else:
        down = 1
    if height % down or width % down:
        raise ValueError(
            f"{type(model).__name__} ONNX export requires height and width "
            f"to be multiples of {down}; got {height}x{width}"
        )

    variables = weights.flax_variables(model, state_dict)
    g = GraphBuilder()
    if isinstance(model, (MobileNetV2UNet, MobileNetV2FPN, MobileNetV2DeepLab)):
        spec = SimpleNamespace(width_mult=model.backbone.width_mult,
                               upsample_head=getattr(model, "upsample_head", True),
                               aspp_rates=getattr(getattr(model, "aspp", None), "rates", ()))
    if isinstance(model, MobileNetV2UNet):
        out = _emit_mobilenetv2_unet(g, "input", variables, spec)
        scale = 1 if model.upsample_head else 2
        out_h, out_w = height // scale, width // scale
        classes = model.outc.conv[3].out_channels
    elif isinstance(model, MobileNetV2FPN):
        out = _emit_fpn(g, "input", variables, spec)
        out_h, out_w, classes = height, width, model.classifier.out_channels
    elif isinstance(model, MobileNetV2DeepLab):
        out = _emit_deeplab(g, "input", variables, spec, height, width)
        out_h, out_w, classes = height, width, model.classifier.out_channels
    elif isinstance(model, LightUNet):
        inner = {
            "params": variables["params"]["unet"],
            "batch_stats": variables["batch_stats"]["unet"],
        }
        out = _emit_unet(g, "input", inner)
        out_h, out_w, classes = height, width, 1
    elif isinstance(model, UNet):
        out = _emit_unet(g, "input", variables)
        out_h, out_w, classes = height, width, model.sem_out.conv[3].out_channels
    else:
        raise TypeError(f"ONNX export does not support {type(model).__name__}")

    # rename the graph's last value to the contract name "output"
    g.nodes.append(op.node_proto("Identity", [out], ["output"]))

    bdim: Union[int, str] = "batch" if batch == -1 else batch
    graph = op.graph_proto(
        g.nodes,
        name=type(model).__name__,
        inputs=[op.value_info_proto("input", op.FLOAT, [bdim, 3, height, width])],
        outputs=[
            op.value_info_proto(
                "output", op.FLOAT, [bdim, classes, out_h, out_w]
            )
        ],
        initializers=g.initializers,
    )
    data = op.model_proto(graph, opset_version=12)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    return data
