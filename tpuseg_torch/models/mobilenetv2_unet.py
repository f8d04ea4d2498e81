"""MobileNetV2UNet — the production model, in PyTorch.

The port of ``tpuseg/models/mobilenetv2_unet.py``. Encoder = MobileNetV2
feature stages tapped at 16/24/32/64/1280 channels (1/2..1/32 resolution);
decoder = four ``Up`` blocks with skip concats

    up1: cat(64, 1280) -> 256     up2: cat(32, 256) -> 128
    up3: cat(24, 128)  -> 64      up4: cat(16, 64)  -> 32

then ``OutConv(32 -> classes)`` and a final x2 bilinear upsample with
``align_corners=True``. ``forward`` takes NCHW float images and returns NCHW
float32 logits, as the reference torch model does; under channels_last
memory format the logits' NHWC view is contiguous.

``use_pallas``, ``up_subpixel``, ``upsample_head`` and ``head_fp32`` are
plain attributes read at every call: they change the path, never the
state_dict. ``head_fp32`` has no effect while compute is fp32 (the only
compute dtype the port runs; float64, which the parity tests use, stays
float64 as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpuseg_torch.models.blocks import OutConv, Up
from tpuseg_torch.models.mobilenetv2 import MobileNetV2Encoder
from tpuseg_torch.ops.resize import upsample2x_bilinear


class MobileNetV2UNet(nn.Module):
    def __init__(self, output_channels: int = 10, width_mult: float = 1.0,
                 use_pallas: bool = False, stem_s2d: bool = False,
                 up_subpixel: bool = True, upsample_head: bool = True,
                 head_fp32: bool = True):
        super().__init__()
        self.use_pallas = use_pallas
        self.up_subpixel = up_subpixel
        self.upsample_head = upsample_head
        self.head_fp32 = head_fp32
        self.backbone = MobileNetV2Encoder(width_mult, stem_s2d=stem_s2d)
        c1, c2, c3, c4, c5 = self.backbone.tap_channels
        self.up1 = Up(c5 + c4, 256)
        self.up2 = Up(256 + c3, 128)
        self.up3 = Up(128 + c2, 64)
        self.up4 = Up(64 + c1, 32)
        self.outc = OutConv(32, output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3, x4, x5 = self.backbone(x)
        flags = dict(use_pallas=self.use_pallas, subpixel=self.up_subpixel)
        y = self.up1(x5, x4, **flags)
        y = self.up2(y, x3, **flags)
        y = self.up3(y, x2, **flags)
        y = self.up4(y, x1, **flags)
        y = self.outc(y)
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        if not self.upsample_head:
            return y
        # final x2, align_corners=True, on the NHWC view
        up = upsample2x_bilinear(y.permute(0, 2, 3, 1), align_corners=True)
        return up.permute(0, 3, 1, 2)
