"""Input normalization and the on-device, batched training augmentation.

The port of ``tpuseg/data/augment.py``: the standard pipeline
(``_standard_sample`` there, the reference's HFlip(.5) ->
ShiftScaleRotate(.05, .05, 10 deg)(.5) -> RandomBrightnessContrast(.5))
and normalize-only. Every geometric op of a sample is composed into one
3x3 homography, and one gather-based warp applies it (bilinear for the
image, nearest for the mask, both with BORDER_REFLECT_101). All of it runs
as batched torch ops on the images' device; the random draws come from an
explicit ``torch.Generator`` on that device.

The heavy pipeline (``_heavy_sample`` there, the reference's richer
src/augmentation.py): HFlip(.6) -> OneOf heavy x-translate(.8) ->
Affine(+-80 deg)(.5) -> Perspective(.5), one warp, then OneOf colour
(ColorJitter, HueSaturationValue, RGBShift)(.5) -> OneOf blur(.3). The
detection augment puts boxes through the same heavy geometry.

Each pipeline draws every random parameter of the batch first
(``standard_params``, ``heavy_params``), each from its own draw of the
generator, so no two decisions are correlated; then a deterministic
function of those tensors applies them. Where the JAX module picks a
branch by a draw (``lax.switch``, ``jnp.where``), every branch is computed
and ``torch.where`` selects per sample: nothing reads a device value on
the host, so the whole augment can be captured in the train step's CUDA
graph.

The contract is distribution parity, as in the JAX module: the same
parameter distributions, not the same random numbers. The deterministic
parts (normalize, the homography builders, ``warp_coords``,
``sample_bilinear``, ``sample_nearest``, the colour ops and the blur, the
box arithmetic) follow the JAX arithmetic and are tested against it.
"""

from __future__ import annotations

import functools
import math
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


def _bernoulli(b: int, prob: float, g: torch.Generator, device) -> torch.Tensor:
    return torch.rand(b, generator=g, device=device) < prob


def _choice3(b: int, g: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, 3, (b,), generator=g, device=device)


def standard_params(b: int, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Per-sample random parameters of the standard pipeline, with the JAX
    module's distributions: flip, do_ssr and do_bc ~ Bernoulli(0.5);
    shift ~ U(-0.05, 0.05)^2 of the size; scale ~ 1 + U(-0.05, 0.05);
    angle ~ U(-10, 10) degrees; contrast alpha ~ 1 + U(-0.2, 0.2);
    brightness beta ~ U(-0.2, 0.2) of 255."""
    return {
        "flip": _bernoulli(b, 0.5, g, device),
        "do_ssr": _bernoulli(b, 0.5, g, device),
        "shift": _uniform((b, 2), -0.05, 0.05, g, device),
        "scale": 1.0 + _uniform((b,), -0.05, 0.05, g, device),
        "angle": torch.deg2rad(_uniform((b,), -10.0, 10.0, g, device)),
        "do_bc": _bernoulli(b, 0.5, g, device),
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


# ---------------------------------------------------------------------------
# The heavy pipeline


def heavy_params(b: int, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Per-sample random parameters of the heavy pipeline, with the JAX
    module's distributions, each from its own draw:

    - geometry: flip ~ B(.6); do_shift ~ B(.8) with branch ~ U{0,1,2}
      (left tx ~ U(-.35,-.15), right tx ~ U(.15,.35), or the middle: tx ~
      U(-.1,.1), scale ~ U(.9,1.1), rotation ~ U(-5,5) deg); do_aff ~ B(.5)
      with scale ~ U(.95,1.05), shift ~ U(-.05,.05)^2, rotation ~
      U(-80,80) deg; do_persp ~ B(.5) with scale ~ U(.05,.15) and a
      standard-normal corner jitter [4, 2];
    - colour: do_color ~ B(.5), which ~ U{0,1,2}: ColorJitter (brightness
      and contrast ~ U(.8,1.2), saturation ~ U(.7,1.3), hue ~ U(-.1,.1)
      turns), HSV (hue ~ U(-10,10) deg, saturation ~ U(-20,20)/255, value
      ~ U(-15,15)) or an RGB shift ~ U(-15,15)^3;
    - blur: do_blur ~ B(.3), blur ~ U{0,1,2} (Gaussian, horizontal or
      vertical motion)."""
    def uni(lo, hi, *shape):
        return _uniform((b, *shape), lo, hi, g, device)

    return {
        "flip": _bernoulli(b, 0.6, g, device),
        "do_shift": _bernoulli(b, 0.8, g, device),
        "branch": _choice3(b, g, device),
        "tx_left": uni(-0.35, -0.15),
        "tx_right": uni(0.15, 0.35),
        "tx_mid": uni(-0.1, 0.1),
        "sc_mid": uni(0.9, 1.1),
        "rot_mid": torch.deg2rad(uni(-5.0, 5.0)),
        "do_aff": _bernoulli(b, 0.5, g, device),
        "a_sc": uni(0.95, 1.05),
        "a_tr": uni(-0.05, 0.05, 2),
        "a_rot": torch.deg2rad(uni(-80.0, 80.0)),
        "do_persp": _bernoulli(b, 0.5, g, device),
        "p_scale": uni(0.05, 0.15),
        "p_normal": torch.randn((b, 4, 2), generator=g, device=device),
        "do_color": _bernoulli(b, 0.5, g, device),
        "which": _choice3(b, g, device),
        "cj_b": uni(0.8, 1.2),
        "cj_c": uni(0.8, 1.2),
        "cj_s": uni(0.7, 1.3),
        "cj_h": uni(-0.1, 0.1) * 2.0 * math.pi,
        "hsv_hue": uni(-10.0, 10.0) / 180.0 * math.pi,
        "hsv_sat": uni(-20.0, 20.0) / 255.0,
        "hsv_val": uni(-15.0, 15.0),
        "rgb": uni(-15.0, 15.0, 3),
        "do_blur": _bernoulli(b, 0.3, g, device),
        "blur": _choice3(b, g, device),
    }


def perspective_matrix(jitter: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """The homography [B, 3, 3] that moves the image corners (0,0),
    (w-1,0), (w-1,h-1), (0,h-1) by ``jitter`` [B, 4, 2] pixels (x, y): the
    4-point DLT with H[2,2] = 1, an 8x8 system solved by ``solve_ex``
    (no error check, so no host sync)."""
    b, dev = jitter.shape[0], jitter.device
    w, h = float(width), float(height)
    src = _const((0.0, 0.0, w - 1, 0.0, w - 1, h - 1, 0.0, h - 1), dev).view(1, 4, 2)
    dst = src + jitter
    x, y = src[..., 0].expand(b, 4), src[..., 1].expand(b, 4)
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(u), torch.ones_like(u)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=2)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=2)
    a = torch.cat([rows_u, rows_v], dim=1)                        # [B, 8, 8]
    rhs = torch.cat([u, v], dim=1).unsqueeze(-1)                  # [B, 8, 1]
    hvec = torch.linalg.solve_ex(a, rhs).result.squeeze(-1)
    return torch.cat([hvec, ones[:, :1]], dim=1).view(b, 3, 3)


def heavy_matrix(p: Dict[str, torch.Tensor], height: int, width: int) -> torch.Tensor:
    """The heavy pipeline's geometry composed into [B, 3, 3]: HFlip(.6) ->
    OneOf heavy x-translate(.8) -> Affine(+-80 deg)(.5) -> Perspective(.5).
    Shared by the segmentation and detection paths."""
    b = p["flip"].shape[0]
    dev = p["flip"].device
    m = _maybe(hflip_matrix(b, width, dev), p["flip"])

    branch = p["branch"]
    tx = torch.where(branch == 0, p["tx_left"],
                     torch.where(branch == 1, p["tx_right"], p["tx_mid"]))
    sc = torch.where(branch == 2, p["sc_mid"], 1.0)
    rot = torch.where(branch == 2, p["rot_mid"], 0.0)
    heavy = translate(tx * width, torch.zeros_like(tx)) @ \
        rot_scale_about_center(rot, sc, width, height)
    m = _maybe(heavy, p["do_shift"]) @ m

    aff = translate(p["a_tr"][:, 0] * width, p["a_tr"][:, 1] * height) @ \
        rot_scale_about_center(p["a_rot"], p["a_sc"], width, height)
    m = _maybe(aff, p["do_aff"]) @ m

    jitter = p["p_normal"] * p["p_scale"].view(b, 1, 1) * \
        _const((float(width), float(height)), dev).view(1, 1, 2)
    return _maybe(perspective_matrix(jitter, width, height), p["do_persp"]) @ m


# Colour ops on float images [B, H, W, 3] in [0, 255]; parameters are [B]
# tensors (one value per sample).

_RGB2YIQ = ((0.299, 0.587, 0.114),
            (0.5959, -0.2746, -0.3213),
            (0.2115, -0.5227, 0.3112))


@functools.lru_cache(maxsize=None)
def _yiq(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb2yiq, yiq2rgb) float32 [3, 3] on ``device``, made once."""
    with torch.inference_mode(False):
        fwd = torch.tensor(_RGB2YIQ, dtype=torch.float32)
        inv = torch.linalg.inv(fwd.double()).float()
        return fwd.to(device), inv.to(device)


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    return v.view(-1, 1, 1, 1)


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """Luma [B, H, W, 1] (0.299 R + 0.587 G + 0.114 B)."""
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]


def hue_rotate(img: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate the hue by ``angle`` [B] radians in YIQ space, clipped."""
    fwd, inv = _yiq(img.device)
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([one, zero, zero, zero, c, -s, zero, s, c], dim=1).view(-1, 3, 3)
    m = inv @ rot @ fwd                                           # [B, 3, 3]
    b = img.shape[0]
    out = img.reshape(b, -1, 3) @ m.transpose(1, 2)
    return torch.clamp(out.view(img.shape), 0.0, 255.0)


def color_jitter(img: torch.Tensor, bright: torch.Tensor, contrast: torch.Tensor,
                 sat: torch.Tensor, hue: torch.Tensor) -> torch.Tensor:
    """A.ColorJitter(.2, .2, .3, .1) with its factors given; the contrast
    pivots on each sample's own mean luma."""
    img = img * _per_sample(bright)
    mean = grayscale(img).mean(dim=(1, 2, 3), keepdim=True)
    img = (img - mean) * _per_sample(contrast) + mean
    gray = grayscale(img)
    img = gray + (img - gray) * _per_sample(sat)
    img = hue_rotate(torch.clamp(img, 0.0, 255.0), hue)
    return torch.clamp(img, 0.0, 255.0)


def hsv_shift(img: torch.Tensor, hue: torch.Tensor, sat: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """A.HueSaturationValue(10, 20, 15) approximated in YIQ/luma space:
    ``hue`` in radians, ``sat`` a fraction, ``val`` in levels."""
    img = hue_rotate(img, hue)
    gray = grayscale(img)
    img = gray + (img - gray) * (1.0 + _per_sample(sat))
    return torch.clamp(img + _per_sample(val), 0.0, 255.0)


def rgb_shift(img: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Add ``shifts`` [B, 3] levels per channel, clipped."""
    return torch.clamp(img + shifts[:, None, None, :], 0.0, 255.0)


def _conv3(x: torch.Tensor, k: Tuple[float, float, float], dim: int) -> torch.Tensor:
    """3-tap filter along ``dim`` with edge padding."""
    n = x.shape[dim]
    xp = torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim=dim)
    return (xp.narrow(dim, 0, n) * k[0] + xp.narrow(dim, 1, n) * k[1]
            + xp.narrow(dim, 2, n) * k[2])


_GAUSS3 = (0.25, 0.5, 0.25)
_BOX3 = (1 / 3, 1 / 3, 1 / 3)


def blur3(img: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """OneOf(GaussianBlur(3), MotionBlur(3)) per sample: ``kind`` [B] 0 is
    the separable [.25, .5, .25] Gaussian (rows, then columns), 1 a
    horizontal and 2 a vertical 3-tap box; edges padded."""
    gauss = _conv3(_conv3(img, _GAUSS3, 1), _GAUSS3, 2)
    motion_h = _conv3(img, _BOX3, 2)
    motion_v = _conv3(img, _BOX3, 1)
    kind = _per_sample(kind)
    return torch.where(kind == 0, gauss, torch.where(kind == 1, motion_h, motion_v))


def heavy_color(img: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """OneOf colour (.5), then OneOf blur (.3), per sample."""
    which = _per_sample(p["which"])
    colored = torch.where(
        which == 0, color_jitter(img, p["cj_b"], p["cj_c"], p["cj_s"], p["cj_h"]),
        torch.where(which == 1, hsv_shift(img, p["hsv_hue"], p["hsv_sat"], p["hsv_val"]),
                    rgb_shift(img, p["rgb"])))
    img = torch.where(_per_sample(p["do_color"]), colored, img)
    return torch.where(_per_sample(p["do_blur"]), blur3(img, p["blur"]), img)


def heavy_augment(images_u8: torch.Tensor, masks_u8: torch.Tensor, g: torch.Generator):
    """(uint8 [B,H,W,3], uint8 [B,H,W]) -> (float32 [B,H,W,3] in [0,255],
    masks [B,H,W]): the heavy geometry in one warp (masks nearest, never
    interpolated), then the colour and blur epilogue."""
    b, h, w, _ = images_u8.shape
    p = heavy_params(b, g, images_u8.device)
    img, mask = warp(images_u8.to(torch.float32), masks_u8, heavy_matrix(p, h, w))
    return heavy_color(img, p), mask


def make_augment_fn(height: int, width: int, heavy: bool = False, augment: bool = True,
                    mean: Tuple[float, float, float] = _MEAN,
                    std: Tuple[float, float, float] = _STD) -> Callable:
    """(uint8 images [B,H,W,3], uint8 masks [B,H,W], generator) ->
    (normalized float32 [B,H,W,3], int64 masks [B,H,W]).

    ``heavy=True`` takes the heavy pipeline; ``augment=False`` is
    normalize-only (the generator is not drawn from)."""
    pipeline = heavy_augment if heavy else standard_augment

    def fn(images: torch.Tensor, masks: torch.Tensor,
           generator: Optional[torch.Generator] = None):
        if tuple(images.shape[1:3]) != (height, width):
            raise ValueError(f"images {tuple(images.shape)} are not {height}x{width}")
        if augment:
            images, masks = pipeline(images, masks, generator)
        return normalize_images(images, mean, std), masks.to(torch.int64)

    return fn


def augment_batch(images: torch.Tensor, masks: torch.Tensor, generator: torch.Generator,
                  heavy: bool = False):
    """One-shot wrapper of ``make_augment_fn`` at the images' size."""
    return make_augment_fn(images.shape[1], images.shape[2], heavy)(images, masks, generator)


# ---------------------------------------------------------------------------
# Detection: the heavy geometry with YOLO boxes


def detection_boxes(m: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                    height: int, width: int, min_visibility: float = 0.3):
    """Boxes [B, N, 4] YOLO-normalized (cx, cy, w, h) and valid [B, N]
    through forward homographies m [B, 3, 3]: each box's four corners are
    mapped, their bounding box clipped to the image, and the box kept
    where the clipped area is at least ``min_visibility`` of the mapped
    one (albumentations' BboxParams semantics). Dropped boxes are zeros."""
    cx, cy = boxes[..., 0] * width, boxes[..., 1] * height
    bw, bh = boxes[..., 2] * width, boxes[..., 3] * height
    x0, x1 = cx - bw / 2, cx + bw / 2
    y0, y1 = cy - bh / 2, cy + bh / 2
    corners_x = torch.stack([x0, x1, x0, x1], dim=-1)            # [B, N, 4]
    corners_y = torch.stack([y0, y0, y1, y1], dim=-1)
    pts = torch.stack([corners_x, corners_y, torch.ones_like(corners_x)], dim=-2)
    mapped = m[:, None] @ pts                                     # [B, N, 3, 4]
    z = mapped[..., 2, :]
    denom = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    mx, my = mapped[..., 0, :] / denom, mapped[..., 1, :] / denom
    nx0, nx1 = mx.amin(dim=-1), mx.amax(dim=-1)
    ny0, ny1 = my.amin(dim=-1), my.amax(dim=-1)
    cx0, cx1 = torch.clamp(nx0, 0, width), torch.clamp(nx1, 0, width)
    cy0, cy1 = torch.clamp(ny0, 0, height), torch.clamp(ny1, 0, height)
    area = torch.clamp(nx1 - nx0, min=1e-6) * torch.clamp(ny1 - ny0, min=1e-6)
    clipped = torch.clamp(cx1 - cx0, min=0.0) * torch.clamp(cy1 - cy0, min=0.0)
    new_valid = valid & (clipped / area >= min_visibility) & (clipped > 0)
    new_boxes = torch.stack([(cx0 + cx1) / 2 / width, (cy0 + cy1) / 2 / height,
                             (cx1 - cx0) / width, (cy1 - cy0) / height], dim=-1)
    return torch.where(new_valid[..., None], new_boxes, 0.0), new_valid


def make_detection_augment_fn(height: int, width: int, min_visibility: float = 0.3) -> Callable:
    """(uint8 images [B,H,W,3], boxes [B,N,4] YOLO, valid [B,N] bool,
    generator) -> (normalized float32 images, boxes, valid): the heavy
    geometry (no colour), the image warped bilinear and the boxes through
    ``detection_boxes``."""

    def fn(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
           generator: Optional[torch.Generator] = None):
        b, h, w, _ = images.shape
        if (h, w) != (height, width):
            raise ValueError(f"images {tuple(images.shape)} are not {height}x{width}")
        m = heavy_matrix(heavy_params(b, generator, images.device), h, w)
        sy, sx = warp_coords(torch.linalg.inv_ex(m).inverse, h, w)
        img = sample_bilinear(images.to(torch.float32), sy, sx)
        new_boxes, new_valid = detection_boxes(m, boxes.to(torch.float32), valid, h, w,
                                               min_visibility)
        return normalize_images(img), new_boxes, new_valid

    return fn
