"""Subpixel (depth-to-space) formulation of conv3x3(upsample2x(x)), in PyTorch.

The port of ``tpuseg/ops/subpixel.py``. The decoder's ``up`` block computes
``conv3x3(cat([skip, up2x(x)]))``; by the split identity
``conv(cat(a,b)) = conv_a(a) + conv_b(b)`` its x branch is rewritten exactly
as

    conv3x3(up2x_half_pixel(x), K)  ==  d2s( conv3x3(x, K_comp) )

where ``K_comp[3,3,Cin,4*Cout]`` folds the fixed 0.25/0.75 bilinear weights
into the kernel, one output-channel group per subpixel phase (a, b). The
border rows and columns, where the conv's zero padding over the upsampled
tensor differs from the composite's edge pad, are recomputed from 2-row and
2-col slices and stitched in. Public functions keep the JAX layout (NHWC
activations, HWIO kernels); the convolutions themselves are ``F.conv2d``.
This is plain PyTorch, not a kernel: the JAX version has no Pallas call.

In the spatial mode (``tpuseg_torch/parallel/spatial.py``) x and skip are
a rank's H-slabs and the result is its owned rows of the output layer: the
composite conv reads the pair rows' input rows fetched with the edge clamp
(the replicate padding, at the frame's edges only), the columns' and the
skip's convs fetch one row each side, and only the owners of the frame's
first and last rows stitch them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.ops.resize import upsample2x_bilinear, upsample2x_rows
from tpuseg_torch.parallel import spatial

# W[a, dy, r]: weight with which kernel tap dy (0..2) reads input offset
# r-1 (-1..1) when producing output subpixel phase a. Output row 2i+a, tap
# dy reads u[2i + a + dy - 1]; u[2k] = 0.25 x[k-1] + 0.75 x[k],
# u[2k+1] = 0.75 x[k] + 0.25 x[k+1].
_W = np.zeros((2, 3, 3), np.float64)
for _a in range(2):
    for _dy in range(3):
        _k, _c = divmod(_a + _dy - 1, 2)
        taps = ((-1, 0.25), (0, 0.75)) if _c == 0 else ((0, 0.75), (1, 0.25))
        for _m, _w in taps:
            _W[_a, _dy, _k + _m + 1] += _w


@functools.lru_cache(maxsize=None)
def _w_tensor(device: torch.device) -> torch.Tensor:
    """``_W`` in float32 on ``device``, copied there once (a captured step
    cannot copy from pageable host memory)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_W.astype(np.float32)).to(device)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The dtype the rewrite computes in: float32, float64 kept."""
    return torch.promote_types(torch.float32, dtype)


def compose_up2x_conv_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """[3,3,Cin,Cout] -> [3,3,Cin,4*Cout] composite kernel (float32, or
    float64 for a float64 kernel).

    Output channel group (a*2+b) holds phase (a, b)."""
    k = kernel.to(_acc(kernel.dtype))
    w = _w_tensor(k.device).to(k.dtype)
    comp = torch.einsum("yxio,ays,bxt->stiabo", k, w, w)
    s, t, ci, _, _, co = comp.shape
    return comp.reshape(s, t, ci, 4 * co)


def depth_to_space2(y: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 4C] (phase-major groups) -> [B, 2H, 2W, C]."""
    b, h, w, c4 = y.shape
    c = c4 // 4
    y = y.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * h, 2 * w, c)


def _conv(x: torch.Tensor, k: torch.Tensor, padding) -> torch.Tensor:
    """NHWC x HWIO conv, stride 1, symmetric per-axis ``padding`` (ph, pw).
    The weight goes channels_last, the input's layout: as a bare permuted
    view it is in neither layout, and on the spatial step's slabs of few
    rows cuDNN then picks backward algorithms whose workspace raised a
    rank's step peak from 434 to 518 MB (the flagship at batch 8 on an
    H100, TF32 off)."""
    w = k.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=padding)
    return y.permute(0, 2, 3, 1).to(_acc(x.dtype))


def _halo_conv(frame, x: torch.Tensor, h: int, k: torch.Tensor, pw: int) -> torch.Tensor:
    """``_conv(x, k, (1, pw))`` of this rank's slab of a layer ``h`` rows
    high: its owned rows, from one fetched row on each side."""
    x, start, stop = spatial.fetch_window(frame, x, h, h, lambda s, e: (s - 1, e + 1), dim=1)
    if stop == start:
        return spatial.empty_rows(x, (x.shape[0], 0, x.shape[2] + 2 * pw - 2, k.shape[-1]),
                                  _acc(x.dtype))
    return _conv(x, k, (0, pw))


def _conv3x3_up2x_rows(frame, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``conv3x3_up2x`` of this rank's slab ``x``: its owned rows of the
    output (see the module)."""
    h = spatial.layer_height(frame, x.shape[2])
    start, stop = spatial.owned_rows(frame, 2 * h)
    # the composite conv makes output rows in pairs: pair i from x[i-1..i+1]
    xp, _, _ = spatial.fetch_window(frame, x, h, 2 * h,
                                    lambda s, e: (s // 2 - 1, (e - 1) // 2 + 2), dim=1,
                                    clamp=True)
    u_lr = upsample2x_rows(frame, torch.cat([x[:, :, :2], x[:, :, -2:]], dim=2), h)
    u_lr, _, _ = spatial.fetch_window(frame, u_lr, 2 * h, 2 * h,
                                      lambda s, e: (s - 1, e + 1), dim=1)
    b, _, w, _ = x.shape
    if stop == start:
        return spatial.empty_rows((xp, u_lr), (b, 0, 2 * w, kernel.shape[-1]), _acc(x.dtype))
    kc = compose_up2x_conv_kernel(kernel)
    xw = F.pad(xp.permute(0, 3, 1, 2), (1, 1, 0, 0), mode="replicate")
    y = depth_to_space2(_conv(xw.permute(0, 2, 3, 1), kc, (0, 0)))
    first = 2 * (start // 2)
    y = y[:, start - first:stop - first]

    kf = kernel.to(_acc(kernel.dtype))
    zcol = torch.zeros_like(u_lr[:, :, :1])
    y[:, :, :1] = _conv(torch.cat([zcol, u_lr[:, :, :2]], dim=2), kf, (0, 0))
    y[:, :, -1:] = _conv(torch.cat([u_lr[:, :, -2:], zcol], dim=2), kf, (0, 0))
    # the frame's first and last rows, from its first and last two input
    # rows (xp's row p is the global row start // 2 - 1 + p, clamped)
    with spatial.replicated():
        if start == 0:
            u_top = upsample2x_bilinear(xp[:, 1:1 + min(2, h)])[:, :2]
            u_top = torch.cat([torch.zeros_like(u_top[:, :1]), u_top], dim=1)
            y[:, :1] = _conv(u_top, kf, (0, 1))
        if stop == 2 * h:
            at = h - start // 2          # the row h - 1
            u_bot = upsample2x_bilinear(xp[:, at - min(1, h - 1):at + 1])[:, -2:]
            u_bot = torch.cat([u_bot, torch.zeros_like(u_bot[:, :1])], dim=1)
            y[:, -1:] = _conv(u_bot, kf, (0, 1))
    return y


def conv3x3_up2x(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Exact conv3x3(pad=1, zeros)(up2x_half_pixel(x), kernel), no bias.

    x [B,H,W,Cin], kernel [3,3,Cin,Cout] -> [B,2H,2W,Cout] float32 (float64
    for float64 inputs). In the
    spatial mode, x is an H-slab (see the module)."""
    frame = spatial.active()
    if frame is not None:
        return _conv3x3_up2x_rows(frame, x, kernel)
    kc = compose_up2x_conv_kernel(kernel)
    # interior (+ bilinear edge clamp): edge-pad x, VALID composite conv
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    y = depth_to_space2(_conv(xp.permute(0, 2, 3, 1), kc, (0, 0)))

    kf = kernel.to(_acc(kernel.dtype))
    zrow = torch.zeros_like

    # top/bottom rows: u rows {-1,0,1} with u[-1]=0 -> a zero row in front
    u_top = upsample2x_bilinear(x[:, :2])[:, :2]
    u_top = torch.cat([zrow(u_top[:, :1]), u_top], dim=1)
    row0 = _conv(u_top, kf, (0, 1))                      # [B,1,2W,Cout]
    u_bot = upsample2x_bilinear(x[:, -2:])[:, -2:]
    u_bot = torch.cat([u_bot, zrow(u_bot[:, :1])], dim=1)
    rowl = _conv(u_bot, kf, (0, 1))
    # left/right cols over the full height
    u_lr = upsample2x_bilinear(torch.cat([x[:, :, :2], x[:, :, -2:]], dim=2))
    u_l = torch.cat([zrow(u_lr[:, :, :1]), u_lr[:, :, :2]], dim=2)
    col0 = _conv(u_l, kf, (1, 0))                        # [B,2H,1,Cout]
    u_r = torch.cat([u_lr[:, :, -2:], zrow(u_lr[:, :, :1])], dim=2)
    coll = _conv(u_r, kf, (1, 0))

    y[:, :, :1] = col0
    y[:, :, -1:] = coll
    y[:, :1] = row0
    y[:, -1:] = rowl
    return y


def up_concat_conv_subpixel(skip: torch.Tensor, x: torch.Tensor,
                            kernel: torch.Tensor, bias=None) -> torch.Tensor:
    """conv3x3(cat([skip, up2x(x)]), kernel) + bias via the split-kernel
    identity: a plain conv on skip plus the subpixel composite on x.

    skip [B,2H,2W,Cs], x [B,H,W,Cx], kernel [3,3,Cs+Cx,Cout] -> fp32 NHWC."""
    cs = skip.shape[-1]
    frame = spatial.active()
    if frame is None:
        y = _conv(skip, kernel[:, :, :cs], (1, 1))
    else:
        h = spatial.layer_height(frame, skip.shape[2])
        y = _halo_conv(frame, skip, h, kernel[:, :, :cs], 1)
    y = y + conv3x3_up2x(x, kernel[:, :, cs:])
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
