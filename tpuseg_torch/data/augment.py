"""Input normalization and the on-device, batched training augmentation.

The port of ``tpuseg/data/augment.py``: the standard pipeline
(``_standard_sample`` there, the reference's HFlip(.5) ->
ShiftScaleRotate(.05, .05, 10 deg)(.5) -> RandomBrightnessContrast(.5))
and normalize-only. Every geometric op of a sample is composed into one
3x3 homography, and one gather-based warp applies it (bilinear for the
image, nearest for the mask, both with BORDER_REFLECT_101). All of it runs
as batched torch ops on the images' device; the random draws come from an
explicit ``torch.Generator`` on that device.

The contract is distribution parity, as in the JAX module: the same
parameter distributions, not the same random numbers. The deterministic
parts (normalize, the homography builders, ``warp_coords``,
``sample_bilinear``, ``sample_nearest``) follow the JAX arithmetic and are
tested against it. The heavy pipeline is not ported yet (ROADMAP.md A8).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from tpuseg_torch.data.class_maps import IMAGENET_MEAN, IMAGENET_STD

_MEAN = tuple(IMAGENET_MEAN.tolist())
_STD = tuple(IMAGENET_STD.tolist())


def normalize_images(img: torch.Tensor, mean: Tuple[float, float, float] = _MEAN,
                     std: Tuple[float, float, float] = _STD) -> torch.Tensor:
    """uint8/float [.., H, W, 3] in [0,255] -> mean/std-normalized float32.

    The same arithmetic as tpuseg.data.augment.normalize_images:
    ``(img / 255 - mean) / std`` in float32."""
    img = img.to(torch.float32) / 255.0
    return (img - _const(tuple(mean), img.device)) / _const(tuple(std), img.device)


@functools.lru_cache(maxsize=None)
def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``, copied there once (a normal tensor
    even under ``inference_mode``, so that training can use it too)."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Homography builders: [B, 3, 3] float32, acting on [x, y, 1] (x = column),
# forward (input -> output); the warp maps output pixels back through the
# inverse.


def _eye(b: int, device) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(b, 3, 3).clone()


def translate(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    m = _eye(tx.shape[0], tx.device)
    m[:, 0, 2] = tx
    m[:, 1, 2] = ty
    return m


def hflip_matrix(b: int, width: int, device) -> torch.Tensor:
    m = _eye(b, device)
    m[:, 0, 0] = -1.0
    m[:, 0, 2] = width - 1.0
    return m


def rot_scale_about_center(angle_rad: torch.Tensor, scale: torch.Tensor,
                           width: int, height: int) -> torch.Tensor:
    """cv2.getRotationMatrix2D semantics: rotate+scale about the image center."""
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    c = torch.cos(angle_rad) * scale
    s = torch.sin(angle_rad) * scale
    rot = _eye(angle_rad.shape[0], angle_rad.device)
    rot[:, 0, 0], rot[:, 0, 1] = c, s
    rot[:, 1, 0], rot[:, 1, 1] = -s, c
    full = torch.full_like(c, 1.0)
    return translate(cx * full, cy * full) @ rot @ translate(-cx * full, -cy * full)


def _maybe(matrix: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """Per sample: ``matrix`` where ``apply``, else the identity."""
    return torch.where(apply[:, None, None], matrix, _eye(matrix.shape[0], matrix.device))


# ---------------------------------------------------------------------------
# Warping


def _reflect101(coord: torch.Tensor, n: int) -> torch.Tensor:
    """Fold continuous coords into [0, n-1], BORDER_REFLECT_101 (the edge
    pixel is not repeated)."""
    if n == 1:
        return torch.zeros_like(coord)
    period = 2.0 * (n - 1)
    c = torch.remainder(torch.abs(coord), period)
    return torch.minimum(c, period - c)


def warp_coords(inv: torch.Tensor, height: int, width: int):
    """Map the output pixel grid through inverse homographies [B, 3, 3]
    -> input coords (src_y, src_x), each [B, H, W]."""
    dev = inv.device
    gy, gx = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    pts = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)   # [3, H*W]
    mapped = inv @ pts                                                # [B, 3, H*W]
    z = mapped[:, 2]
    denom = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    b = inv.shape[0]
    return ((mapped[:, 1] / denom).reshape(b, height, width),
            (mapped[:, 0] / denom).reshape(b, height, width))


def _flat_index(b: int, h: int, w: int, yi: torch.Tensor, xi: torch.Tensor):
    base = torch.arange(b, device=yi.device).view(b, 1, 1) * (h * w)
    return base + yi.to(torch.int64) * w + xi.to(torch.int64)


def sample_bilinear(img: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor):
    """Bilinear gather of img [B, H, W, C] (float) at continuous coords
    [B, H', W'], reflect-101."""
    b, h, w, c = img.shape
    sy, sx = _reflect101(src_y, h), _reflect101(src_x, w)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    fy, fx = (sy - y0)[..., None], (sx - x0)[..., None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    y1, x1 = torch.clamp(y0 + 1, max=h - 1), torch.clamp(x0 + 1, max=w - 1)
    flat = img.reshape(b * h * w, c)

    def at(yi, xi):
        return flat[_flat_index(b, h, w, yi, xi)]

    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def sample_nearest(mask: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor):
    """Nearest gather of an integer class map [B, H, W], reflect-101
    (round half to even, as jnp.round)."""
    b, h, w = mask.shape
    yi = torch.clamp(torch.round(_reflect101(src_y, h)).to(torch.int64), 0, h - 1)
    xi = torch.clamp(torch.round(_reflect101(src_x, w)).to(torch.int64), 0, w - 1)
    return mask.reshape(-1)[_flat_index(b, h, w, yi, xi)]


def warp(images: torch.Tensor, masks: torch.Tensor, m: torch.Tensor):
    """Apply forward homographies m [B, 3, 3]: (float images [B,H,W,3],
    masks [B,H,W]) -> both warped, bilinear and nearest."""
    _, h, w, _ = images.shape
    # inv_ex: no error check, so no host sync (these matrices are invertible)
    sy, sx = warp_coords(torch.linalg.inv_ex(m).inverse, h, w)
    return sample_bilinear(images, sy, sx), sample_nearest(masks, sy, sx)


# ---------------------------------------------------------------------------
# The standard pipeline


def _uniform(shape, lo: float, hi: float, g: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def standard_params(b: int, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Per-sample random parameters of the standard pipeline, with the JAX
    module's distributions: flip, do_ssr and do_bc ~ Bernoulli(0.5);
    shift ~ U(-0.05, 0.05)^2 of the size; scale ~ 1 + U(-0.05, 0.05);
    angle ~ U(-10, 10) degrees; contrast alpha ~ 1 + U(-0.2, 0.2);
    brightness beta ~ U(-0.2, 0.2) of 255."""
    return {
        "flip": torch.rand(b, generator=g, device=device) < 0.5,
        "do_ssr": torch.rand(b, generator=g, device=device) < 0.5,
        "shift": _uniform((b, 2), -0.05, 0.05, g, device),
        "scale": 1.0 + _uniform((b,), -0.05, 0.05, g, device),
        "angle": torch.deg2rad(_uniform((b,), -10.0, 10.0, g, device)),
        "do_bc": torch.rand(b, generator=g, device=device) < 0.5,
        "alpha": 1.0 + _uniform((b,), -0.2, 0.2, g, device),
        "beta": _uniform((b,), -0.2, 0.2, g, device),
    }


def standard_matrix(p: Dict[str, torch.Tensor], height: int, width: int) -> torch.Tensor:
    """HFlip, then ShiftScaleRotate, composed into [B, 3, 3]."""
    b = p["flip"].shape[0]
    dev = p["flip"].device
    m = _maybe(hflip_matrix(b, width, dev), p["flip"])
    ssr = translate(p["shift"][:, 0] * width, p["shift"][:, 1] * height) @ \
        rot_scale_about_center(p["angle"], p["scale"], width, height)
    return _maybe(ssr, p["do_ssr"]) @ m


def standard_augment(images_u8: torch.Tensor, masks_u8: torch.Tensor,
                     g: torch.Generator):
    """(uint8 [B,H,W,3], uint8 [B,H,W]) -> (float32 [B,H,W,3] in [0,255],
    masks [B,H,W]): one warp, then RandomBrightnessContrast."""
    b, h, w, _ = images_u8.shape
    p = standard_params(b, g, images_u8.device)
    img, mask = warp(images_u8.to(torch.float32), masks_u8,
                     standard_matrix(p, h, w))
    alpha, beta = p["alpha"].view(b, 1, 1, 1), p["beta"].view(b, 1, 1, 1)
    bc = torch.clamp(img * alpha + beta * 255.0, 0.0, 255.0)
    return torch.where(p["do_bc"].view(b, 1, 1, 1), bc, img), mask


def make_augment_fn(height: int, width: int, heavy: bool = False, augment: bool = True,
                    mean: Tuple[float, float, float] = _MEAN,
                    std: Tuple[float, float, float] = _STD) -> Callable:
    """(uint8 images [B,H,W,3], uint8 masks [B,H,W], generator) ->
    (normalized float32 [B,H,W,3], int64 masks [B,H,W]).

    ``augment=False`` is normalize-only (the generator is not drawn
    from). ``heavy=True`` raises: the heavy pipeline is not ported yet."""
    if heavy:
        raise NotImplementedError(
            "the heavy augmentation pipeline is not ported yet (ROADMAP.md A8, data)"
        )

    def fn(images: torch.Tensor, masks: torch.Tensor,
           generator: Optional[torch.Generator] = None):
        if tuple(images.shape[1:3]) != (height, width):
            raise ValueError(f"images {tuple(images.shape)} are not {height}x{width}")
        if augment:
            images, masks = standard_augment(images, masks, generator)
        return normalize_images(images, mean, std), masks.to(torch.int64)

    return fn
