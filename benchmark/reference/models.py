"""Plain float32 PyTorch models: the benchmark's reference of the two
families that its first configurations run; ``build`` finds any other
family in a file of its own (``reference/families/<family>.py``).

Written from the published descriptions and the layouts the configurations
name, with the same module nesting and so the same ``state_dict`` keys as
the program's models, so that one seeded state dict loads into both. No
kernel, no capture, no compute-dtype rounding: ``nn.Conv2d``,
``nn.BatchNorm2d`` and ``F.interpolate``. Imports nothing of the program.

- ``MobileNetV2UNet``: the MobileNetV2 encoder (arXiv:1801.04381, width
  1.0, torchvision's ``features`` layout) tapped after features 1, 3, 6,
  10 and 18 (16, 24, 32, 64 and 1280 channels), four up blocks (bilinear x2 with
  ``align_corners=False``, ``cat([skip, up])``, two 3x3 conv+BN+ReLU), a
  1x1-BN-ReLU-1x1 head and a final x2 bilinear upsample with
  ``align_corners=True`` (SEAME-pt/Team02-ObjectDetection ``src/unet.py``).
- ``MobileNetV2DeepLab``: DeepLabv3+ (arXiv:1802.02611) on the same
  encoder: an ASPP of a 1x1, three dilated 3x3s and an image-pooling
  branch, projected by a 1x1; the 1/32 features upsampled x8 as three
  bilinear x2 steps, concatenated after a 1x1 projection of the 1/4 tap,
  two 3x3 refines, a biased 1x1 classifier and x4 (two x2 steps).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark import harness

BN_EPS = 1e-5

# (expand ratio, out channels, repeats, first stride): MobileNetV2 Table 2
SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
TAPS = (1, 3, 6, 10, 18)


def conv_bn_act(cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1,
                bias: bool = False, act=nn.ReLU6, dilation: int = 1) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, k, stride, dilation * (k - 1) // 2, dilation=dilation,
                        groups=groups, bias=bias),
              nn.BatchNorm2d(cout, eps=BN_EPS)]
    if act is not None:
        layers.append(act())
    return nn.Sequential(*layers)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, t: int):
        super().__init__()
        hidden = cin * t
        self.use_res = stride == 1 and cin == cout
        layers = [conv_bn_act(cin, hidden)] if t != 1 else []
        layers += [conv_bn_act(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, cout, 1, bias=False), nn.BatchNorm2d(cout, eps=BN_EPS)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.conv(x) if self.use_res else self.conv(x)


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        feats: List[nn.Module] = [conv_bn_act(3, 32, 3, 2)]
        cin, self.taps = 32, []
        for t, c, n, s in SETTINGS:
            for i in range(n):
                feats.append(InvertedResidual(cin, c, s if i == 0 else 1, t))
                cin = c
                if len(feats) - 1 in TAPS:
                    self.taps.append(c)
        feats.append(conv_bn_act(cin, 1280))
        self.taps.append(1280)
        self.features = nn.Sequential(*feats)

    def forward(self, x) -> List[torch.Tensor]:
        out = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in TAPS:
                out.append(x)
        return out


def up2(x, align_corners: bool = False):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=align_corners)


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout, eps=BN_EPS), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout, eps=BN_EPS), nn.ReLU())


class Up(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x, skip):
        return self.conv.conv(torch.cat([skip, up2(x)], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin: int, classes: int):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(cin, cin // 2, 1), nn.BatchNorm2d(cin // 2, eps=BN_EPS),
                                  nn.ReLU(), nn.Conv2d(cin // 2, classes, 1))


class MobileNetV2UNet(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.backbone = Encoder()
        c1, c2, c3, c4, c5 = self.backbone.taps
        self.up1, self.up2 = Up(c5 + c4, 256), Up(256 + c3, 128)
        self.up3, self.up4 = Up(128 + c2, 64), Up(64 + c1, 32)
        self.outc = OutConv(32, num_classes)

    def forward(self, x):
        x1, x2, x3, x4, x5 = self.backbone(x)
        y = self.up4(self.up3(self.up2(self.up1(x5, x4), x3), x2), x1)
        return up2(self.outc.conv(y), align_corners=True)


class ASPP(nn.Module):
    def __init__(self, cin: int, d: int, rates: Sequence[int]):
        super().__init__()
        self.rates = tuple(rates)
        self.aspp_conv1x1 = conv_bn_act(cin, d, bias=True, act=nn.ReLU)
        for r in self.rates:
            self.add_module(f"aspp_rate{r}",
                            conv_bn_act(cin, d, 3, bias=True, act=nn.ReLU, dilation=r))
        self.aspp_pool = conv_bn_act(cin, d, bias=True, act=nn.ReLU)
        self.project = conv_bn_act(d * (len(self.rates) + 2), d, bias=True, act=nn.ReLU)

    def forward(self, x):
        branches = [self.aspp_conv1x1(x)] + [getattr(self, f"aspp_rate{r}")(x)
                                             for r in self.rates]
        pooled = self.aspp_pool(x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.project(torch.cat(branches, dim=1))


class MobileNetV2DeepLab(nn.Module):
    def __init__(self, num_classes: int, aspp_channels: int, low_level_channels: int,
                 rates: Sequence[int]):
        super().__init__()
        d = aspp_channels
        self.backbone = Encoder()
        _, c2, _, _, c5 = self.backbone.taps
        self.aspp = ASPP(c5, d, rates)
        self.low_project = conv_bn_act(c2, low_level_channels, bias=True, act=nn.ReLU)
        self.refine1 = conv_bn_act(low_level_channels + d, d, 3, bias=True, act=nn.ReLU)
        self.refine2 = conv_bn_act(d, d, 3, bias=True, act=nn.ReLU)
        self.classifier = nn.Conv2d(d, num_classes, 1)

    def forward(self, x):
        _, c2, _, _, c5 = self.backbone(x)
        y = up2(up2(up2(self.aspp(c5))))
        y = self.refine2(self.refine1(torch.cat([self.low_project(c2), y], dim=1)))
        return up2(up2(self.classifier(y)))


def build(arch: dict, root: str = harness.CHECKOUT) -> nn.Module:
    """The reference model of a configuration's ``reference`` block: one of
    the two families above, or what ``build(arch)`` of
    ``reference/families/<family>.py`` returns, that file looked up under
    ``root``'s benchmark folder and then in this package."""
    family = arch["family"]
    if family == "mobilenetv2_unet":
        return MobileNetV2UNet(arch["num_classes"])
    if family == "mobilenetv2_deeplab":
        return MobileNetV2DeepLab(arch["num_classes"], arch["aspp_channels"],
                                  arch["low_level_channels"], arch["aspp_rates"])
    try:
        path = harness.find(root, os.path.join("reference", "families"), family, ".py")
    except FileNotFoundError as e:
        raise KeyError(f"no reference for family {family!r}: {e}") from None
    return harness.load_module(path).build(arch)
