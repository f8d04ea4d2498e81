"""Host-side data sources: each yields ``(image uint8 [H,W,3] RGB, mask
uint8 [H,W])`` at the configured size.

The port of ``tpuseg/data/sources.py``. ``SyntheticSource`` is a copy of
the JAX package's pure-numpy generator and gives bit-equal samples for
the same seed and index. The file-backed sources (BDD100K, CARLA, SEAME,
packed) need cv2 or the packed memmap loader and are not ported yet:
``build_source`` raises for them, naming ROADMAP.md A8.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpuseg_torch.configs import DatasetSourceConfig


class SyntheticSource:
    """Deterministic procedural road scenes: trapezoid road on the ground
    plane, sidewalk bands, rectangular 'cars' (classes 0 sky, 1 road,
    6 sidewalk, 2 car).

    ``car_prob`` / ``car_scale`` make the car class rare or small; at
    their defaults they draw nothing extra from the RNG stream."""

    def __init__(self, num_samples: int, width: int, height: int, seed: int = 0,
                 car_prob: float = 1.0, car_scale: float = 1.0):
        self.n = num_samples
        self.width = width
        self.height = height
        self.seed = seed
        self.car_prob = car_prob
        self.car_scale = car_scale

    def __len__(self) -> int:
        return self.n

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        h, w = self.height, self.width
        image = np.zeros((h, w, 3), np.uint8)
        mask = np.zeros((h, w), np.uint8)
        # sky gradient
        sky = np.linspace(180, 90, h, dtype=np.float32)[:, None]
        image[..., 2] = np.clip(sky + rng.randint(-20, 20), 0, 255)
        image[..., 1] = image[..., 2] * 0.8
        image[..., 0] = image[..., 2] * 0.6
        horizon = h // 2 + rng.randint(-h // 8, h // 8)
        # road trapezoid
        cx = w // 2 + rng.randint(-w // 8, w // 8)
        top_half, bot_half = w // 16, w // 2
        cols = np.arange(w)[None, :]
        rows = np.arange(h)[:, None]
        t = np.clip((rows - horizon) / max(h - horizon, 1), 0, 1)
        half = top_half + (bot_half - top_half) * t
        road = (rows >= horizon) & (np.abs(cols - cx) <= half)
        mask[road] = 1
        image[road] = (90, 90, 95)
        # sidewalk strips flanking the road
        side = (rows >= horizon) & (np.abs(cols - cx) <= half * 1.3) & ~road
        mask[side] = 6
        image[side] = (160, 150, 140)
        # cars
        for _ in range(rng.randint(1, 4)):
            if self.car_prob < 1.0 and rng.random_sample() >= self.car_prob:
                continue
            cw = rng.randint(w // 12, w // 6)
            if self.car_scale != 1.0:
                cw = max(3, int(cw * self.car_scale))
            ch = max(4, cw // 2)
            y0 = rng.randint(horizon, max(horizon + 1, h - ch - 1))
            x0 = rng.randint(0, max(1, w - cw - 1))
            color = rng.randint(0, 255, size=3)
            image[y0 : y0 + ch, x0 : x0 + cw] = color
            mask[y0 : y0 + ch, x0 : x0 + cw] = 2
        noise = rng.randint(-10, 10, size=image.shape)
        image = np.clip(image.astype(np.int16) + noise, 0, 255).astype(np.uint8)
        return image, mask


NOT_YET_PORTED = ("bdd100k", "carla", "seame", "packed")


def build_source(cfg: DatasetSourceConfig, width: int, height: int):
    if cfg.kind == "synthetic":
        return SyntheticSource(cfg.num_samples, width, height,
                               car_prob=cfg.car_prob, car_scale=cfg.car_scale)
    if cfg.kind in NOT_YET_PORTED:
        raise NotImplementedError(
            f"data source {cfg.kind!r} is not ported yet (ROADMAP.md A8, data); "
            "the port reads the 'synthetic' source"
        )
    raise KeyError(f"unknown source kind {cfg.kind!r}")
