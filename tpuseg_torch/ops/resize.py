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
from typing import Optional

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


@functools.lru_cache(maxsize=None)
def _rounded_taps(n_in: int, n_out: int, align_corners: bool, device: torch.device,
                  dtype: torch.dtype):
    """(lo, hi, w_lo, w_hi) on ``device``: the two nonzero entries of each
    row of ``_bilinear_matrix`` (1 - frac and frac, float64 rounded once to
    float32), rounded to ``dtype`` and held in float32."""
    lo, hi, frac = _taps64(n_in, n_out, align_corners)
    with torch.inference_mode(False):     # a normal tensor: see _tap_tensors
        idx = [torch.from_numpy(a).to(device) for a in (lo, hi)]
        wts = [torch.from_numpy(a.astype(np.float32)).to(device, dtype).to(torch.float32)
               for a in (1.0 - frac, frac)]
    return (*idx, *wts)


def _contract_rounded(x: torch.Tensor, axis: int, n_out: int, align_corners: bool,
                      dtype: torch.dtype) -> torch.Tensor:
    """One axis of ``_apply_hw(compute_dtype=dtype)``: x (already in
    ``dtype``) against the taps rounded to ``dtype``, each output's two
    products summed in float32 and the sum rounded to ``dtype``."""
    lo, hi, w_lo, w_hi = _rounded_taps(x.shape[axis], n_out, align_corners, x.device, dtype)
    shape = [1] * x.ndim
    shape[axis] = n_out
    xf = x.to(torch.float32)
    y = xf.index_select(axis, lo) * w_lo.reshape(shape) + xf.index_select(axis, hi) * w_hi.reshape(shape)
    return y.to(dtype)


def upsample2x_bilinear(x: torch.Tensor, align_corners: bool = False,
                        compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x2 bilinear upsample of [..., H, W, C]: H, then W.

    The JAX package contracts with ``_bilinear_matrix`` here; the 2-tap
    form has the same two nonzero weights per row (equal up to one float32
    rounding of 1 - frac) and never forms the matrix. ``compute_dtype``
    (bf16 for the reduced-traffic head) is the storage dtype of the
    contraction, as the JAX package's: x, the taps and each pass's result
    rounded to it, each 2-tap sum taken in float32; the result is in it.
    None: at least float32, and ``x.dtype`` back."""
    if compute_dtype is None:
        return resize_bilinear(x, 2 * x.shape[-3], 2 * x.shape[-2], align_corners)
    y = x.to(compute_dtype)
    y = _contract_rounded(y, x.ndim - 3, 2 * x.shape[-3], align_corners, compute_dtype)
    return _contract_rounded(y, x.ndim - 2, 2 * x.shape[-2], align_corners, compute_dtype)


def up_pow2_bilinear(x: torch.Tensor, times: int) -> torch.Tensor:
    """2^times bilinear upsample of [..., H, W, C] as a cascade of exact x2
    ``align_corners=False`` steps: the FPN and DeepLab families' definition
    of an Nx upsample, which differs from one direct Nx resize near the
    edges."""
    for _ in range(times):
        x = upsample2x_bilinear(x, align_corners=False)
    return x


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


def _linear_u8_taps(n_in: int, n_out: int, clamp: bool):
    """cv2's INTER_LINEAR taps along one axis: (lo, hi, c0, c1) with 11-bit
    coefficients rint((1-f)*2048) and rint(f*2048), ``f`` in float32 from
    (d+0.5)*scale-0.5. ``clamp`` (the horizontal pass) pins an outside
    source to the edge pixel with f = 0; the vertical pass keeps its f and
    clamps only the rows it reads."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        edge = (s < 0) | (s >= n_in - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, n_in - 1)
    c0 = np.rint((np.float32(1.0) - f) * np.float32(2048)).astype(np.int32)
    c1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), c0, c1


def resize_linear_u8_host(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``cv2.resize(frame, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    on every frame of a uint8 [B, H, W, C] batch, bit for bit, in numpy.

    cv2's fixed-point route: a horizontal pass of 11-bit coefficients into
    int32 rows (exact), then the vertical pass as cv2's SIMD code computes
    it, ``(((c0*(r0>>4))>>16) + ((c1*(r1>>4))>>16) + 2) >> 2`` saturated to
    uint8 (the scalar ``(c0*r0 + c1*r1 + 2^21) >> 22`` differs by 1 on about
    a tenth of the bytes). An exact 2x downscale in both axes is cv2's
    INTER_AREA there, ``(a+b+c+d+2) >> 2``; the same size is a copy.

    Checked bit-equal to cv2 5.0.0 at downscales and upscales, the upscale
    edges included (tests/test_torch_port_infer.py). A cv2 build whose
    vertical pass runs a scalar tail where 3*out_w is not a multiple of its
    vector width could differ there by 1; model widths are multiples of 32,
    so 3*out_w is a multiple of 96 at every served size and no tail runs."""
    if frames.dtype != np.uint8 or frames.ndim != 4:
        raise ValueError(f"frames must be uint8 [B, H, W, C], got {frames.dtype} {frames.shape}")
    h, w = frames.shape[1:3]
    if (h, w) == (out_h, out_w):
        return frames.copy()
    if (h, w) == (2 * out_h, 2 * out_w):
        s = frames.astype(np.int32)
        return ((s[:, 0::2, 0::2] + s[:, 0::2, 1::2] + s[:, 1::2, 0::2] + s[:, 1::2, 1::2] + 2)
                >> 2).astype(np.uint8)
    b, c = frames.shape[0], frames.shape[3]
    x0, x1, a0, a1 = _linear_u8_taps(w, out_w, clamp=True)
    y0, y1, b0, b1 = _linear_u8_taps(h, out_h, clamp=False)
    # the horizontal pass, on the source rows the vertical pass reads, as
    # column gathers of [B*rows, W*C] bytes
    rows, inv = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    src = frames[:, rows].reshape(b * len(rows), w * c)
    ch = np.arange(c)
    cols0, cols1 = ((x[:, None] * c + ch).ravel() for x in (x0, x1))
    horiz = (src[:, cols0].astype(np.int32) * np.repeat(a0, c)
             + src[:, cols1].astype(np.int32) * np.repeat(a1, c)) >> 4
    horiz = horiz.reshape(b, len(rows), out_w * c)
    out = (((b0[:, None] * horiz[:, inv[:out_h]]) >> 16)
           + ((b1[:, None] * horiz[:, inv[out_h:]]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(b, out_h, out_w, c)
