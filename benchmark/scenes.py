"""Seeded road scenes, made in bulk on a device: the benchmark's inputs.

The geometry follows the program's synthetic source (a sky gradient above a
horizon, a road trapezoid widening towards the camera, sidewalk bands
beside it, rectangular objects), extended so that every class of the
configuration appears: each scene carries ``objects`` rectangles whose
classes are drawn from a Zipf law over the classes other than sky, road
and sidewalk, and the first object of scene i takes the (i mod k)-th of
them, so a set of at least k scenes holds all. Sky and road take most of
the pixels and a long tail of classes a few each, as in BDD100K and
Mapillary Vistas. Images are the class's colour from a seeded palette,
each object's own offset, a sky gradient and pixel noise.

Everything is drawn from one ``torch.Generator`` on the device, in a few
calls per chunk of scenes: the same seed, shapes and device give the same
bytes.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

SKY, ROAD = 0, 1


def sidewalk_class(num_classes: int) -> int:
    return 6 if num_classes > 6 else num_classes - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed``."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream) % 2 ** 63)


def _uniform(gen, shape, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def make_scenes(n: int, height: int, width: int, num_classes: int, gen: torch.Generator,
                objects: int = 8, zipf: float = 1.3, chunk: int = 64,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(uint8 images [n, H, W, 3], uint8 masks [n, H, W]) on ``device``."""
    device = torch.device(device if device is not None else gen.device)
    side = sidewalk_class(num_classes)
    others = torch.tensor([k for k in range(num_classes) if k not in (SKY, ROAD, side)],
                          device=device)
    palette = torch.randint(30, 226, (num_classes, 3), generator=gen, device=device)
    zipf_w = 1.0 / torch.arange(1, len(others) + 1, device=device, dtype=torch.float32) ** zipf
    images = torch.empty((n, height, width, 3), dtype=torch.uint8, device=device)
    masks = torch.empty((n, height, width), dtype=torch.uint8, device=device)
    rows = torch.arange(height, device=device).view(1, -1, 1)
    cols = torch.arange(width, device=device).view(1, 1, -1)
    for start in range(0, n, chunk):
        b = min(chunk, n - start)
        horizon = (height // 2 + torch.randint(-(height // 8), height // 8 + 1, (b, 1, 1),
                                               generator=gen, device=device))
        cx = width // 2 + torch.randint(-(width // 8), width // 8 + 1, (b, 1, 1),
                                        generator=gen, device=device)
        t = torch.clamp((rows - horizon) / (height - horizon).clamp(min=1), 0, 1)
        half = width / 16 + (width / 2 - width / 16) * t
        below = rows >= horizon
        road = below & ((cols - cx).abs() <= half)
        walk = below & ((cols - cx).abs() <= half * 1.3) & ~road
        mask = torch.where(road, ROAD, torch.where(walk, side, SKY)).to(torch.int64)
        offset = torch.zeros((b, height, width, 3), device=device)
        classes = others[torch.multinomial(zipf_w, b * objects, replacement=True,
                                           generator=gen)].view(b, objects)
        classes[:, 0] = others[(torch.arange(start, start + b, device=device)) % len(others)]
        ow = torch.exp(_uniform(gen, (b, objects), np.log(width / 40), np.log(width / 4),
                                device)).to(torch.int64).clamp(min=2)
        oh = (ow * _uniform(gen, (b, objects), 0.4, 1.2, device)).to(torch.int64).clamp(min=2)
        y0 = (horizon.view(b, 1) - oh // 2
              + (_uniform(gen, (b, objects), 0, 1, device)
                 * (height - horizon.view(b, 1)).clamp(min=1)).to(torch.int64))
        x0 = (_uniform(gen, (b, objects), 0, 1, device) * (width - ow)).to(torch.int64)
        shade = _uniform(gen, (b, objects, 3), -25, 25, device)
        for j in range(objects):
            inside = ((rows >= y0[:, j].view(b, 1, 1)) & (rows < (y0 + oh)[:, j].view(b, 1, 1))
                      & (cols >= x0[:, j].view(b, 1, 1)) & (cols < (x0 + ow)[:, j].view(b, 1, 1)))
            mask = torch.where(inside, classes[:, j].view(b, 1, 1), mask)
            offset = torch.where(inside[..., None], shade[:, j].view(b, 1, 1, 3), offset)
        sky_light = (60.0 * (1.0 - rows / height)).view(1, height, 1, 1)
        img = palette[mask].to(torch.float32) + offset
        img = img + torch.where((mask == SKY)[..., None], sky_light, 0.0)
        img = img + torch.randint(-10, 11, img.shape, generator=gen, device=device)
        images[start:start + b] = img.clamp(0, 255).to(torch.uint8)
        masks[start:start + b] = mask.to(torch.uint8)
    return images, masks


def write_packed(directory: str, images: np.ndarray, masks: np.ndarray) -> None:
    """The program's packed data set format: ``images.npy`` uint8 [N, H, W,
    3], ``masks.npy`` uint8 [N, H, W] and ``meta.json``."""
    os.makedirs(directory, exist_ok=True)
    np.save(os.path.join(directory, "images.npy"), images)
    np.save(os.path.join(directory, "masks.npy"), masks)
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump({"width": int(images.shape[2]), "height": int(images.shape[1]),
                   "count": int(images.shape[0]), "kind": "benchmark"}, f)
