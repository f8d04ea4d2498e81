"""MobileNetV2FPN — the semantic-FPN family, in PyTorch.

The port of ``tpuseg/models/fpn.py``. Lateral 1x1s (BN, no activation)
project the encoder's 1/4..1/32 taps to ``fpn_channels``; a top-down pass
adds each level to the exact 2x nearest upsample of the one above; 3x3
``smooth`` and ``head`` convs (BN, ReLU) follow, each head is brought to 1/4
by the cascaded 2x bilinear upsample and the four are summed; a biased
1x1 classifier gives logits at 1/4, upsampled x4 the same way. Every conv
of the decoder is biased, as the JAX package's ``ConvBNAct`` default.

Module names follow flax's (``lat5``, ``smooth2``, ``head3``,
``classifier``), so ``state_dict_from_flax`` maps names mechanically; the
encoder keeps ``backbone.features.N``. Takes NCHW, returns NCHW float32
logits at the input resolution.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpuseg_torch.core.dtypes import cast_to_output
from tpuseg_torch.models.blocks import Conv2d, ConvBNAct, nchw
from tpuseg_torch.models.mobilenetv2 import MobileNetV2Encoder
from tpuseg_torch.ops.resize import up_pow2_bilinear


def up_pow2(x: torch.Tensor, times: int) -> torch.Tensor:
    """``up_pow2_bilinear`` on an NCHW tensor (through its NHWC view)."""
    return nchw(up_pow2_bilinear(x.permute(0, 2, 3, 1), times)) if times else x


def up2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest upsample of NCHW features: each pixel repeated."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class MobileNetV2FPN(nn.Module):
    def __init__(self, output_channels: int = 10, width_mult: float = 1.0,
                 fpn_channels: int = 128, stem_s2d: bool = False):
        super().__init__()
        d = fpn_channels
        self.backbone = MobileNetV2Encoder(width_mult, stem_s2d=stem_s2d)
        _, c2, c3, c4, c5 = self.backbone.tap_channels
        for k, c in (("5", c5), ("4", c4), ("3", c3), ("2", c2)):
            self.add_module(f"lat{k}", ConvBNAct(c, d, 1, bias=True, act=None))
        for name in ("smooth", "head"):
            for k in "2345":
                self.add_module(f"{name}{k}", ConvBNAct(d, d, 3, bias=True, act=nn.ReLU))
        self.classifier = Conv2d(d, output_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, c2, c3, c4, c5 = self.backbone(x)
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + up2x_nearest(p5)
        p3 = self.lat3(c3) + up2x_nearest(p4)
        p2 = self.lat2(c2) + up2x_nearest(p3)
        levels = (self.smooth2(p2), self.smooth3(p3), self.smooth4(p4), self.smooth5(p5))
        y = None
        for steps, (head, p) in enumerate(zip(
                (self.head2, self.head3, self.head4, self.head5), levels)):
            h = up_pow2(head(p), steps)       # to 1/4 resolution
            y = h if y is None else y + h
        logits = self.classifier(y)
        return up_pow2(cast_to_output(logits), 2)
