"""MobileNetV2DeepLab — the DeepLabV3+ (ASPP) family, in PyTorch.

The port of ``tpuseg/models/deeplab.py``. The ASPP reads the 1/32 tap with
a 1x1, three dilated 3x3s (rates 2, 4, 6, padding equal to the rate) and an
image-level branch (fp32 global mean, 1x1, broadcast), concatenated and
projected by a 1x1. The decoder upsamples that x8 (cascaded 2x bilinear),
concatenates ``[low, up]`` with the 1/4 tap projected to 64 channels, runs
two 3x3 refines and a biased 1x1 classifier, and upsamples x4. Every
``ConvBNAct`` is biased with ReLU, as the JAX package's defaults.

Module names follow flax's (``aspp.aspp_rate2``, ``aspp.project``,
``low_project``, ``refine1``, ``classifier``); the encoder keeps
``backbone.features.N``. Takes NCHW, returns NCHW float32 logits at the
input resolution.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from tpuseg_torch.core.dtypes import cast_to_output
from tpuseg_torch.models.blocks import Conv2d, ConvBNAct
from tpuseg_torch.models.fpn import up_pow2
from tpuseg_torch.models.mobilenetv2 import MobileNetV2Encoder


class ASPP(nn.Module):
    """1x1 + dilated 3x3s + image pooling, concatenated and projected back
    to ``features`` with a 1x1."""

    def __init__(self, cin: int, features: int, rates: Tuple[int, ...] = (2, 4, 6)):
        super().__init__()
        d = features
        self.rates = tuple(rates)
        self.aspp_conv1x1 = ConvBNAct(cin, d, 1, bias=True, act=nn.ReLU)
        for r in self.rates:
            self.add_module(f"aspp_rate{r}",
                            ConvBNAct(cin, d, 3, bias=True, act=nn.ReLU, dilation=r))
        self.aspp_pool = ConvBNAct(cin, d, 1, bias=True, act=nn.ReLU)
        self.project = ConvBNAct(d * (len(self.rates) + 2), d, 1, bias=True, act=nn.ReLU)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [self.aspp_conv1x1(x)]
        branches += [getattr(self, f"aspp_rate{r}")(x) for r in self.rates]
        pooled = x.to(torch.promote_types(torch.float32, x.dtype)).mean(
            dim=(2, 3), keepdim=True).to(x.dtype)
        pooled = self.aspp_pool(pooled)
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.project(torch.cat(branches, dim=1))


class MobileNetV2DeepLab(nn.Module):
    def __init__(self, output_channels: int = 10, width_mult: float = 1.0,
                 aspp_channels: int = 256, low_level_channels: int = 64,
                 aspp_rates: Tuple[int, ...] = (2, 4, 6), stem_s2d: bool = False):
        super().__init__()
        d = aspp_channels
        self.backbone = MobileNetV2Encoder(width_mult, stem_s2d=stem_s2d)
        _, c2, _, _, c5 = self.backbone.tap_channels
        self.aspp = ASPP(c5, d, aspp_rates)
        self.low_project = ConvBNAct(c2, low_level_channels, 1, bias=True, act=nn.ReLU)
        self.refine1 = ConvBNAct(low_level_channels + d, d, 3, bias=True, act=nn.ReLU)
        self.refine2 = ConvBNAct(d, d, 3, bias=True, act=nn.ReLU)
        self.classifier = Conv2d(d, output_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, c2, _, _, c5 = self.backbone(x)
        y = up_pow2(self.aspp(c5), 3)                     # 1/32 -> 1/4
        y = torch.cat([self.low_project(c2), y], dim=1)
        y = self.refine2(self.refine1(y))
        logits = self.classifier(y)
        return up_pow2(cast_to_output(logits), 2)
