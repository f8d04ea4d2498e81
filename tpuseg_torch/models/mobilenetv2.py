"""MobileNetV2 encoder (torchvision graph and key names) in PyTorch.

The port of ``tpuseg/models/mobilenetv2.py``. The reference slices
torchvision's ``mobilenet_v2().features`` into five stages by index:

    features[:2]    -> 16 ch   @ 1/2      (stem s2 + t1 block)
    features[2:4]   -> 24 ch   @ 1/4
    features[4:7]   -> 32 ch   @ 1/8
    features[7:11]  -> 64 ch   @ 1/16
    features[11:19] -> 1280 ch @ 1/32

``MobileNetV2Encoder.features`` is that Sequential, with torchvision's key
names (``features.N.conv.M...``), and ``forward`` returns the five taps.
``stem_s2d`` is accepted and runs the plain stem conv: in the JAX package
it selects an exact rewrite of the same 3x3 stride-2 conv (a 2x2 conv over
a space-to-depth input, a TPU layout choice), so the function, the weights
and the keys are the same either way.

``inverted_residual_shapes`` reads the 17 blocks' shapes off an encoder,
for the checks of the fused block kernel (``tpuseg_torch.ops.mbconv``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch
import torch.nn as nn

from tpuseg_torch.models.blocks import BN_EPS, BN_MOMENTUM, BatchNorm2d, Conv2d, ConvBNAct

# (expand_ratio t, out_channels c, repeats n, first_stride s)
INVERTED_RESIDUAL_SETTINGS: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# feature indices after which the UNet taps skip connections
STAGE_TAPS = (1, 3, 6, 10, 18)


def make_divisible(v: float, divisor: int = 8) -> int:
    """Channel rounding used by the MobileNet family (channels % 8 == 0)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class InvertedResidual(nn.Module):
    """expand 1x1 -> depthwise 3x3 -> project 1x1 (+residual when s=1,
    cin=cout; in the compute dtype, as the JAX block adds it)."""

    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_res = stride == 1 and cin == cout
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNAct(cin, hidden, 1))
        layers += [
            ConvBNAct(hidden, hidden, 3, stride, groups=hidden),
            Conv2d(hidden, cout, 1, bias=False),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2Encoder(nn.Module):
    """The 19-layer feature extractor, returning the 5 UNet skip taps (NCHW)."""

    def __init__(self, width_mult: float = 1.0, stem_s2d: bool = False):
        super().__init__()
        self.width_mult = width_mult
        c_stem = make_divisible(32 * width_mult)
        del stem_s2d        # the same conv either way (module docstring)
        feats: List[nn.Module] = [ConvBNAct(3, c_stem, 3, 2)]
        cin = c_stem
        taps = []
        for t, c, n, s in INVERTED_RESIDUAL_SETTINGS:
            cout = make_divisible(c * width_mult)
            for i in range(n):
                feats.append(InvertedResidual(cin, cout, s if i == 0 else 1, t))
                cin = cout
                if len(feats) - 1 in STAGE_TAPS:
                    taps.append(cout)
        c_last = make_divisible(1280 * max(1.0, width_mult))
        feats.append(ConvBNAct(cin, c_last, 1))
        self.features = nn.Sequential(*feats)
        self.tap_channels: Tuple[int, ...] = (*taps, c_last)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in STAGE_TAPS:
                taps.append(x)
        return taps


class BlockShape(NamedTuple):
    """One InvertedResidual: channels, stride, residual, whether it has an
    expand conv, and the H x W of its input."""
    cin: int
    hidden: int
    cout: int
    stride: int
    use_res: bool
    expand: bool
    h: int
    w: int


def inverted_residual_shapes(encoder: MobileNetV2Encoder, h: int,
                             w: int) -> List[BlockShape]:
    """The shape of each InvertedResidual of ``encoder.features`` when the
    encoder's input is ``h`` x ``w``."""
    out = []
    for layer in encoder.features:
        if isinstance(layer, InvertedResidual):
            expand = len(layer.conv) == 4
            conv = layer.conv[-3][0]                     # the depthwise 3x3
            out.append(BlockShape(layer.conv[0][0].in_channels, conv.in_channels,
                                  layer.conv[-2].out_channels, conv.stride[0],
                                  layer.use_res, expand, h, w))
        else:
            conv = layer[0]
        (kh, kw), (ph, pw), (sh, sw) = conv.kernel_size, conv.padding, conv.stride
        h, w = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    return out
