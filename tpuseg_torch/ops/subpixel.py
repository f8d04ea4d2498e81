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
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.ops.resize import upsample2x_bilinear

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


def compose_up2x_conv_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """[3,3,Cin,Cout] -> [3,3,Cin,4*Cout] composite kernel (float32).

    Output channel group (a*2+b) holds phase (a, b)."""
    k = kernel.to(torch.float32)
    w = _w_tensor(k.device)
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
    """NHWC x HWIO conv, stride 1, symmetric per-axis ``padding`` (ph, pw)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(x.dtype).permute(3, 2, 0, 1),
                 padding=padding)
    return y.permute(0, 2, 3, 1).to(torch.float32)


def conv3x3_up2x(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Exact conv3x3(pad=1, zeros)(up2x_half_pixel(x), kernel), no bias.

    x [B,H,W,Cin], kernel [3,3,Cin,Cout] -> [B,2H,2W,Cout] float32."""
    kc = compose_up2x_conv_kernel(kernel)
    # interior (+ bilinear edge clamp): edge-pad x, VALID composite conv
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    y = depth_to_space2(_conv(xp.permute(0, 2, 3, 1), kc, (0, 0)))

    kf = kernel.to(torch.float32)
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
    y = _conv(skip, kernel[:, :, :cs], (1, 1))
    y = y + conv3x3_up2x(x, kernel[:, :, cs:])
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y
