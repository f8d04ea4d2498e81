"""Vanilla UNet and LightUNet in PyTorch.

The port of ``tpuseg/models/unet.py`` (base_filters = F):

    inc   : DoubleConv(3 -> F)
    down1 : MaxPool + DoubleConv(F -> 2F)
    down2 : MaxPool + DoubleConv(2F -> 4F)
    down3 : MaxPool + DoubleConv(4F -> 4F)     # keeps 4F
    up1   : cat(4F skip, 4F up) -> 2F
    up2   : cat(2F, 2F) -> F
    up3   : cat(F, F)  -> F
    head  : OutConv(F -> classes)              # output at input resolution

The ``Up`` blocks take the materialized upsample + concat, as the JAX
UNet's do (it never sets ``use_pallas``). The state_dict keys are the
reference's (``inc.conv.conv.*``, ``downK.mpconv.1.conv.*``,
``upK.conv.conv.*``, ``sem_out.conv.*``), so a reference ``.pth`` loads
directly. LightUNet is the same graph with F=32 and one output channel
whatever ``num_classes`` says, under the same keys.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpuseg_torch.core.dtypes import cast_to_output
from tpuseg_torch.models.blocks import Down, InConv, OutConv, Up


class UNet(nn.Module):
    def __init__(self, output_channels: int = 1, base_filters: int = 64):
        super().__init__()
        f = base_filters
        self.inc = InConv(3, f)
        self.down1 = Down(f, f * 2)
        self.down2 = Down(f * 2, f * 4)
        self.down3 = Down(f * 4, f * 4)
        self.up1 = Up(f * 8, f * 2)
        self.up2 = Up(f * 4, f)
        self.up3 = Up(f * 2, f)
        self.sem_out = OutConv(f, output_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.up1(x4, x3)
        y = self.up2(y, x2)
        y = self.up3(y, x1)
        return cast_to_output(self.sem_out(y))


class LightUNet(UNet):
    def __init__(self, base_filters: int = 32):
        super().__init__(output_channels=1, base_filters=base_filters)
