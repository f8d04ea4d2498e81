"""int8 x int8 -> int32 convolution: the int8 route of ``ConvBNAct``.

The port of the conv inside ``tpuseg/models/blocks.py::ConvBNAct._quantized_conv``
(``lax.conv_general_dilated`` of int8 operands with
``preferred_element_type=int32``, XLA's conv, not a Pallas kernel). Every
sum it returns is exact: bit-equal to the same sum taken in int64.

Two traps rule out the obvious calls. ``F.conv2d`` on int8 tensors
returns int8 and wraps (100 * 100 * 36 comes out 64 on the CPU). A float32
conv of the integer values is exact only while every partial sum is an
integer below 2^24, that is while K * 127^2 < 2^24, K <= 1040 terms; the
flagship's ``up1`` conv sums K = 9 * (64 + 1280) = 12,096.

Dispatch goes by the tensor's device: a CPU tensor takes the plain
version, a float64 conv of the integer values (exact: every sum lies below
2^53), cast to int32. On a CUDA tensor the route is chosen by the conv's
shape, by ``card_route``, and nothing falls back from one route to another:

- ``"int_mm"``, every dense conv (groups 1): an int8 im2col in channels-last
  order (none for a 1x1 at stride 1) times the OIHW kernel reshaped to
  [K, Cout], by ``torch._int_mm`` (cuBLASLt's int8 GEMM, int32
  accumulators). Its shape rules (M > 16, K and N multiples of 8) are met
  by padding with zero rows and columns, which add nothing to any sum.
- ``"fp32"``, every depthwise conv (one input channel per group, K = 9):
  a float32 conv of the integer values, exact by the bound above. Every
  product is an integer below 2^14 and every partial sum one below 2^18,
  so any summation order and TF32's 11-bit operands give the same value.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# the largest K whose float32 sums of int8 x int8 products stay exact:
# K * 127^2 < 2^24
MAX_EXACT_FP32_K = (1 << 24) // (127 * 127)


def quantize_act(x: torch.Tensor, act_scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / act_scale), -127, 127)`` as int8, in float32.

    ``act_scale`` is a tensor on ``x``'s device, so the quotient is a true
    division: PyTorch's CUDA kernels multiply by the reciprocal when the
    divisor is a host scalar (ROADMAP.md C17)."""
    q = torch.round(x.to(torch.float32) / act_scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def card_route(kernel_shape: Sequence[int], groups: int) -> str:
    """The card's route for an OIHW int8 kernel of ``kernel_shape`` (see
    the module); ValueError for a grouped conv that is not depthwise."""
    cout, cin_g, kh, kw = kernel_shape
    if groups == 1:
        return "int_mm"
    if cin_g == 1 and cout == groups and kh * kw <= MAX_EXACT_FP32_K:
        return "fp32"
    raise ValueError(f"no exact int8 route for a conv with groups={groups} and "
                     f"kernel {tuple(kernel_shape)}")


def int8_conv_plain(xq: torch.Tensor, kq: torch.Tensor, stride=1, padding=0,
                    dilation=1, groups: int = 1) -> torch.Tensor:
    """The plain version: a float64 conv of the integer values, rounded and
    cast to int32 (NCHW in and out; the card's float64 conv too)."""
    y = F.conv2d(xq.to(torch.float64), kq.to(torch.float64), None, stride, padding,
                 dilation, groups)
    return torch.round(y).to(torch.int32)


def im2col_nhwc(xq: torch.Tensor, kh: int, kw: int, stride, padding,
                dilation) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """NCHW int8 ``xq`` -> ([B*Ho*Wo, kh*kw*C] rows, (B, Ho, Wo)): each
    output pixel's receptive field in (ky, kx, c) order, read off the
    channels-last view (no copy at all for a 1x1 at stride 1 of a
    channels_last tensor)."""
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    b, c, h, w = xq.shape
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = xq.permute(0, 2, 3, 1)
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        return x.reshape(b * h * w, c), (b, h, w)
    x = F.pad(x, (0, 0, pw, pw, ph, ph))
    taps = [x[:, ky * dh: ky * dh + (ho - 1) * sh + 1: sh,
              kx * dw: kx * dw + (wo - 1) * sw + 1: sw] for ky in range(kh) for kx in range(kw)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c), (b, ho, wo)


def int_mm_conv(xq: torch.Tensor, kq: torch.Tensor, stride=1, padding=0,
                dilation=1) -> torch.Tensor:
    """The ``"int_mm"`` route: im2col rows times the kernel by
    ``torch._int_mm``, padded to its shape rules; int32 NCHW out (a view of
    a channels-last result)."""
    cout, cin, kh, kw = kq.shape
    rows, (b, ho, wo) = im2col_nhwc(xq, kh, kw, stride, padding, dilation)
    m, k = rows.shape
    k8, n8 = -(-k // 8) * 8, -(-cout // 8) * 8
    if (k8, m) != (k, max(m, 17)):
        rows = F.pad(rows, (0, k8 - k, 0, max(m, 17) - m))
    # [Cout, K] in (ky, kx, c) order, then transposed: a column-major B
    cols = kq.permute(0, 2, 3, 1).reshape(cout, k)
    if (n8, k8) != (cout, k):
        cols = F.pad(cols, (0, k8 - k, 0, n8 - cout))
    y = torch._int_mm(rows.contiguous(), cols.t())
    return y[:m, :cout].reshape(b, ho, wo, cout).permute(0, 3, 1, 2)


def int8_conv(xq: torch.Tensor, kq: torch.Tensor, stride=1, padding=0, dilation=1,
              groups: int = 1) -> torch.Tensor:
    """Exact int32 sums of the int8 NCHW ``xq`` convolved with the int8
    OIHW ``kq`` (see the module for the routes)."""
    if xq.dtype != torch.int8 or kq.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 operands, got {xq.dtype} and {kq.dtype}")
    if xq.device != kq.device:
        raise ValueError(f"operands on different devices: {xq.device} and {kq.device}")
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, kq, stride, padding, dilation, groups)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv runs on cuda or cpu, not {xq.device}")
    if card_route(kq.shape, groups) == "int_mm":
        return int_mm_conv(xq, kq, stride, padding, dilation)
    y = F.conv2d(xq.to(torch.float32), kq.to(torch.float32), None, stride, padding,
                 dilation, groups)
    return y.to(torch.int32)
