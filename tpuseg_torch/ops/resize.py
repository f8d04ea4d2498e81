"""Exact-semantics image resizing as 2-tap interpolation, in PyTorch.

The port of ``tpuseg/ops/resize.py``, with its layout: NHWC (or HWC)
tensors, the interpolated axes being the ones before the channels. The
reference model mixes two bilinear conventions:

- decoder ``up`` blocks: ``align_corners=False`` (half-pixel);
- the final x2 upsample: ``align_corners=True``.

Conventions implemented (the same formulas as the JAX package):

- ``align_corners=False``: src = (i + 0.5) * n/m - 0.5, clamped to [0, n-1]
  (cv2 INTER_LINEAR, torch/ONNX half_pixel);
- ``align_corners=True``: src = i * (n-1)/(m-1);
- nearest: src = floor(i * n/m) (cv2 INTER_NEAREST), for class maps.

Every path is two ``index_select`` gathers and a lerp per axis. The taps are
computed in float64 with numpy and rounded to float32, as in the JAX
package's ``_bilinear_taps``. No ``F.interpolate``: torch derives its source index
from the scale factor, which for odd ratios is not the size ratio.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """[n_out, n_in] row-stochastic interpolation matrix, float32."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    lo, hi, frac = _taps64(n_in, n_out, align_corners)
    a = np.zeros((n_out, n_in), dtype=np.float64)
    a[np.arange(n_out), lo] += 1.0 - frac
    a[np.arange(n_out), hi] += frac
    return a.astype(np.float32)


def _taps64(n_in: int, n_out: int, align_corners: bool):
    """(lo, hi, frac) with frac in float64: the source of every weight."""
    i = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = np.zeros_like(i) if n_out == 1 else i * (n_in - 1) / (n_out - 1)
    else:
        src = np.clip((i + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, src - lo


@functools.lru_cache(maxsize=None)
def _bilinear_taps(n_in: int, n_out: int, align_corners: bool):
    """(lo_idx, hi_idx, frac) int32/float32 arrays for 2-tap interpolation."""
    lo, hi, frac = _taps64(n_in, n_out, align_corners)
    return lo.astype(np.int32), hi.astype(np.int32), frac.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tap_tensors(n_in: int, n_out: int, align_corners: bool,
                 device: torch.device, dtype: torch.dtype):
    """(lo, hi, 1 - frac, frac) 1-D tensors on ``device``, made once per
    shape: the taps' host-to-device copies stay out of every later call.
    Made as normal tensors even under ``inference_mode``, since a later
    training step saves the weights for its backward."""
    lo, hi, frac = _bilinear_taps(n_in, n_out, align_corners)
    with torch.inference_mode(False):
        idx = [torch.from_numpy(a.astype(np.int64)).to(device) for a in (lo, hi)]
        wts = [torch.from_numpy(a).to(device, dtype) for a in (np.float32(1.0) - frac, frac)]
    return (*idx, *wts)


def _interp_axis(x: torch.Tensor, axis: int, n_out: int,
                 align_corners: bool) -> torch.Tensor:
    """2-tap gather interpolation along one axis: x[lo]*(1-frac) + x[hi]*frac."""
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    lo, hi, w_lo, w_hi = _tap_tensors(n_in, n_out, align_corners, x.device, x.dtype)
    shape = [1] * x.ndim
    shape[axis] = n_out
    return (x.index_select(axis, lo) * w_lo.reshape(shape)
            + x.index_select(axis, hi) * w_hi.reshape(shape))


def resize_bilinear(
    x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize of an NHWC (or HWC) tensor with exact torch semantics.

    Computes in at least float32 and returns ``x.dtype``."""
    orig_dtype = x.dtype
    y = x.to(torch.promote_types(torch.float32, orig_dtype))
    y = _interp_axis(y, x.ndim - 3, out_h, align_corners)
    y = _interp_axis(y, x.ndim - 2, out_w, align_corners)
    return y.to(orig_dtype)


def upsample2x_bilinear(x: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """x2 bilinear upsample of [..., H, W, C]: H, then W.

    The JAX package contracts with ``_bilinear_matrix`` here; the 2-tap
    form has the same two nonzero weights per row (equal up to one float32
    rounding of 1 - frac) and never forms the matrix."""
    return resize_bilinear(x, 2 * x.shape[-3], 2 * x.shape[-2], align_corners)


def _phase2_ac_true(x: torch.Tensor, axis: int):
    """Even/odd output phases of the exact align_corners=True 2x upsample.

    For n inputs the 2n outputs sample src = i*(n-1)/(2n-1):

        src(2k)   = k - k/(2n-1)         -> lerp(x[k-1], x[k]),  w_{k-1} = k/(2n-1)
        src(2k+1) = k + (n-1-k)/(2n-1)   -> lerp(x[k], x[k+1]),  w_{k+1} = (n-1-k)/(2n-1)
    """
    n = x.shape[axis]
    k = torch.arange(n, dtype=x.dtype, device=x.device)
    shape = [1] * x.ndim
    shape[axis] = n
    we = (k / (2 * n - 1)).reshape(shape)            # weight of x[k-1], even
    wo = ((n - 1 - k) / (2 * n - 1)).reshape(shape)  # weight of x[k+1], odd
    idx = torch.arange(n, device=x.device)
    xm1 = x.index_select(axis, (idx - 1).clamp(min=0))
    xp1 = x.index_select(axis, (idx + 1).clamp(max=n - 1))
    even = we * xm1 + (1.0 - we) * x
    odd = (1.0 - wo) * x + wo * xp1
    return even, odd


def upsample2x_argmax_head(logits: torch.Tensor,
                           out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """argmax(upsample2x_bilinear(logits, align_corners=True)) from the four
    (H-phase x W-phase) grids, without the full-resolution logits.

    [B, H, W, C] float -> [B, 2H, 2W] ``out_dtype``."""
    eh, oh = _phase2_ac_true(logits, logits.ndim - 3)
    rows = []
    for h in (eh, oh):
        ew, ow = _phase2_ac_true(h, logits.ndim - 2)
        ce = ew.argmax(dim=-1).to(out_dtype)  # [B, H, W]
        co = ow.argmax(dim=-1).to(out_dtype)
        w2 = torch.stack([ce, co], dim=-1)    # interleave W
        rows.append(w2.reshape(*w2.shape[:-2], 2 * w2.shape[-2]))
    h2 = torch.stack(rows, dim=-2)            # interleave H
    return h2.reshape(*h2.shape[:-3], 2 * h2.shape[-3], h2.shape[-1])


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each of ``n_out`` outputs: min(floor(i*n_in/n_out), n_in-1)."""
    return np.minimum(
        np.floor(np.arange(n_out) * (n_in / n_out)), n_in - 1
    ).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _nearest_tensor(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):     # a normal tensor: see _tap_tensors
        return torch.from_numpy(nearest_indices(n_in, n_out)).to(device)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbor resize (cv2 INTER_NEAREST convention) for masks.

    Works on [..., H, W] integer class maps (no channel dim) or [..., H, W, C]
    (C <= 4), with the JAX package's rule for telling the two apart."""
    has_channels = x.ndim >= 3 and x.shape[-1] <= 4 and x.shape[-2] > 4
    h_ax, w_ax = (x.ndim - 3, x.ndim - 2) if has_channels else (x.ndim - 2, x.ndim - 1)
    # index_select has no uint32 kernel: move the bits as int32
    y = x.view(torch.int32) if x.dtype == torch.uint32 else x
    y = y.index_select(h_ax, _nearest_tensor(x.shape[h_ax], out_h, x.device))
    y = y.index_select(w_ax, _nearest_tensor(x.shape[w_ax], out_w, x.device))
    return y.view(torch.uint32) if x.dtype == torch.uint32 else y


def resize_nearest_host(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """numpy nearest upscale of [B, H, W] maps (any dtype) to [B, out_h, out_w]
    — the same index formula as ``resize_nearest``, without cv2."""
    rows = nearest_indices(arr.shape[1], out_h)
    cols = nearest_indices(arr.shape[2], out_w)
    return arr[:, rows[:, None], cols[None, :]]
