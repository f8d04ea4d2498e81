"""UNet building blocks as PyTorch modules (NCHW, torch idiom).

The port of ``tpuseg/models/blocks.py``. Module and ``state_dict`` layout
follow the reference and torchvision, so a reference ``.pth`` loads
directly:

- ``ConvBNAct`` is torchvision's ConvBNActivation, ``Sequential(Conv2d,
  BatchNorm2d, act)`` with keys ``0.*``/``1.*``;
- ``DoubleConv.conv`` is the reference's flat ``Sequential(Conv, BN, ReLU,
  Conv, BN, ReLU)`` (keys ``0,1,3,4``);
- ``Up`` concatenates the skip FIRST, then the upsampled input
  (bilinear x2, ``align_corners=False``);
- ``OutConv.conv`` is ``Sequential(Conv1x1, BN, ReLU, Conv1x1)`` (keys
  ``0,1,3``);
- ``InConv.conv`` and ``Down.mpconv.1`` hold the UNet's DoubleConvs, as the
  reference's ``inconv`` and ``down`` do.

BatchNorm eps is 1e-5 and momentum 0.1 (torch's defaults, the same
statistics as the JAX package's flax decay 0.9). Every BatchNorm is
``BatchNorm2d`` below, which follows flax in train mode: the running
variance takes the biased batch variance, where ``nn.BatchNorm2d`` takes
the unbiased n/(n-1) one.

``upconcat_conv`` keeps the JAX routing of an up block's first conv
(``ConvBNAct.upconcat_impl`` there): ``"subpixel"`` in train and eval;
``"pallas"`` -> the CUDA kernel ``fused_upsample_concat_conv`` in eval only;
the materialized upsample+concat otherwise.
"""

from __future__ import annotations

from typing import Optional, Tuple, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.ops.resize import upsample2x_bilinear

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode running statistics.

    Train mode normalizes with the batch mean and biased variance, as
    torch does, and moves ``running_mean``/``running_var`` by ``momentum``
    towards the batch mean and the *biased* batch variance, as flax's
    ``nn.BatchNorm`` does (torch moves the variance towards the unbiased
    one). Eval mode is ``nn.BatchNorm2d``'s, unchanged; so is the
    state_dict.

    The batch statistics are computed once, by ``F.batch_norm``, which
    also moves the running buffers; the running variance's move is then
    scaled by (n-1)/n, from the unbiased variance to the biased one."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * (1.0 - self.momentum)
            moved = self.running_var.clone()    # the backward keeps it: not edited after
            self.num_batches_tracked.add_(1)
        y = F.batch_norm(x, self.running_mean, moved, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_((moved - kept) * ((n - 1) / n) + kept)
        return y


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> contiguous NHWC (free when it is channels_last)."""
    return t.permute(0, 2, 3, 1).contiguous()


def nchw(t: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels_last strides)."""
    return t.permute(0, 3, 1, 2)


def hwio(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> contiguous HWIO (the JAX kernel layout)."""
    return weight.permute(2, 3, 1, 0).contiguous()


class ConvBNAct(nn.Sequential):
    """Conv -> BatchNorm -> activation (torchvision's ConvBNActivation).

    ``dilation`` pads by ``dilation * (kernel - 1) // 2`` (the ASPP's
    explicit padding ``r`` for a 3x3 at rate ``r``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, bias: bool = False,
                 act: Optional[Type[nn.Module]] = nn.ReLU6, dilation: int = 1):
        layers = [
            nn.Conv2d(cin, cout, kernel, stride, dilation * (kernel - 1) // 2,
                      dilation=dilation, groups=groups, bias=bias),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
        ]
        if act is not None:
            layers.append(act())
        super().__init__(*layers)


def upconcat_conv(conv: nn.Conv2d, skip: torch.Tensor, x: torch.Tensor,
                  impl: str, training: bool) -> torch.Tensor:
    """``conv(cat([skip, up2x(x)]))`` (NCHW in, NCHW out, before BN).

    impl "subpixel": exact composite-kernel rewrite (train and eval);
    "pallas": the fused CUDA kernel in eval (its plain version for CPU
    tensors); otherwise, or "pallas" in training, the materialized
    upsample + concat + conv."""
    if impl == "subpixel":
        from tpuseg_torch.ops.subpixel import up_concat_conv_subpixel

        return nchw(up_concat_conv_subpixel(
            nhwc(skip), nhwc(x), hwio(conv.weight), conv.bias))
    if impl == "pallas" and not training:
        from tpuseg_torch.ops.kernels import fused_upsample_concat_conv

        return nchw(fused_upsample_concat_conv(
            nhwc(skip), nhwc(x), hwio(conv.weight), conv.bias))
    if impl not in ("pallas", "materialize"):
        raise ValueError(f"unknown upconcat_impl {impl!r}")
    up = nchw(upsample2x_bilinear(x.permute(0, 2, 3, 1), align_corners=False))
    return conv(torch.cat([skip, up], dim=1))


class DoubleConv(nn.Module):
    """(Conv3x3 -> BN -> ReLU) x 2 — the reference double_conv.

    ``upconcat_pair=(skip, x)`` routes the first conv through
    ``upconcat_conv`` (state_dict unchanged)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1),
            BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU(),
        )

    def forward(self, x: Optional[torch.Tensor],
                upconcat_pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                upconcat_impl: str = "pallas") -> torch.Tensor:
        if upconcat_pair is None:
            return self.conv(x)
        skip, up_in = upconcat_pair
        y = upconcat_conv(self.conv[0], skip, up_in, upconcat_impl,
                          self.training)
        for layer in self.conv[1:]:
            y = layer(y)
        return y


class InConv(nn.Module):
    """The reference inconv: a DoubleConv under ``.conv`` (keys
    ``inc.conv.conv.*``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Down(nn.Module):
    """MaxPool(2) then DoubleConv — the reference down, whose
    ``mpconv = Sequential(MaxPool2d, double_conv)`` gives the keys
    ``downK.mpconv.1.conv.*``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mpconv(x)


class Up(nn.Module):
    """Bilinear x2 (align_corners=False), concat [skip, upsampled], DoubleConv.

    ``subpixel`` takes precedence over ``use_pallas``, as in the JAX
    package; both are chosen per call, so they never change the
    state_dict."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                use_pallas: bool = False, subpixel: bool = False) -> torch.Tensor:
        impl = "subpixel" if subpixel else "pallas" if use_pallas else "materialize"
        return self.conv(None, upconcat_pair=(skip, x), upconcat_impl=impl)


class OutConv(nn.Module):
    """Head: Conv1x1(in->in/2) -> BN -> ReLU -> Conv1x1(in/2->classes)."""

    def __init__(self, cin: int, classes: int):
        super().__init__()
        half = cin // 2
        self.conv = nn.Sequential(
            nn.Conv2d(cin, half, 1),
            BatchNorm2d(half, eps=BN_EPS, momentum=BN_MOMENTUM),
            nn.ReLU(),
            nn.Conv2d(half, classes, 1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)
