"""Host-side data sources: decode + label remap + resize, nothing else.

The port of ``tpuseg/data/sources.py``. Each source yields ``(image uint8
[H,W,3] RGB, mask uint8 [H,W])`` at the configured size, with the same
bytes as the JAX source for the same files (the code is a copy; the port
imports nothing of the JAX package):

- ``BDD100KSource``: sorted jpg/png images and png masks, the BDD100K LUT;
- ``CarlaSource``: png images, png masks but ``*_viz.png``, the CARLA LUT;
- ``SEAMESource``: JSON-lines polygon annotations, the multi-class
  ``annotations`` format and the legacy road-only ``polygons`` one,
  rasterized with ``cv2.fillPoly`` at native resolution;
- ``SyntheticSource``: procedural road scenes (pure numpy);
- ``PackedSource``: the memmapped arrays that ``python -m
  tpuseg_torch.tools.pack_dataset`` (or the JAX package's
  ``tools/pack_dataset.py``) writes, with a one-call batch gather.

The directory sources and SEAME decode with cv2, imported inside the
functions that use it, so the package imports without it. On a host
without cv2 they raise on construction, naming the packed route; they
never fall back to another decoder. Unreadable files raise in SEAME and
are skipped with a log in the directory sources.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional, Tuple

import numpy as np

from tpuseg_torch.configs import DatasetSourceConfig
from tpuseg_torch.data.class_maps import BDD100K_LUT, CARLA_LUT, SEAME_CLASS_MAP

log = logging.getLogger(__name__)

PACK_HINT = ("decode the dataset where cv2 is installed with `python -m "
             "tpuseg_torch.tools.pack_dataset --kind {kind} ... --out DIR`, then train "
             "from it with kind=\"packed\", packed_dir=DIR")


def _cv2(kind: str = ""):
    """cv2, imported at first use; without it, ImportError naming the
    packed route (the port has no other image decoder)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"the {kind or 'directory'} source decodes images with cv2, which does not import "
            f"here ({e}); " + PACK_HINT.format(kind=kind or "<kind>")) from e
    return cv2


def _resize_pair(image: np.ndarray, mask: np.ndarray, width: int, height: int):
    cv2 = _cv2()
    if image.shape[:2] != (height, width):
        image = cv2.resize(image, (width, height), interpolation=cv2.INTER_LINEAR)
    if mask.shape[:2] != (height, width):
        mask = cv2.resize(mask, (width, height), interpolation=cv2.INTER_NEAREST)
    return image, mask


class _DirSource:
    """Shared file-pair listing of BDD100K and CARLA."""

    kind = ""
    lut: np.ndarray = None  # set by subclass
    img_exts: Tuple[str, ...] = (".jpg", ".png")
    mask_exts: Tuple[str, ...] = (".png",)
    mask_exclude_suffix: Optional[str] = None

    def __init__(self, img_dir: str, mask_dir: str, width: int, height: int):
        _cv2(self.kind)   # refuse here, not mid-epoch in the loader thread
        self.img_dir = img_dir
        self.mask_dir = mask_dir
        self.width = width
        self.height = height
        self.images: List[str] = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.lower().endswith(self.img_exts))
        self.masks: List[str] = sorted(
            os.path.join(mask_dir, f) for f in os.listdir(mask_dir)
            if f.lower().endswith(self.mask_exts)
            and not (self.mask_exclude_suffix and f.endswith(self.mask_exclude_suffix)))
        if len(self.images) != len(self.masks):
            # pair by filename stem: truncating to the shorter list would
            # mispair every sample after the first missing file
            def stem(p):
                return os.path.splitext(os.path.basename(p))[0]

            mask_by_stem = {stem(p): p for p in self.masks}
            pairs = [(i, mask_by_stem[stem(i)]) for i in self.images if stem(i) in mask_by_stem]
            log.warning("%s: %d images vs %d masks — paired %d by filename stem, "
                        "dropped the rest", type(self).__name__, len(self.images),
                        len(self.masks), len(pairs))
            if not pairs:
                raise FileNotFoundError(
                    f"{type(self).__name__}: image/mask counts differ "
                    f"({len(self.images)} vs {len(self.masks)}) and no filename stems "
                    f"match between {self.img_dir!r} and {self.mask_dir!r}")
            self.images = [p for p, _ in pairs]
            self.masks = [p for _, p in pairs]

    def __len__(self) -> int:
        return len(self.images)

    def load(self, idx: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        cv2 = _cv2(self.kind)
        image = cv2.imread(self.images[idx])
        mask = cv2.imread(self.masks[idx], cv2.IMREAD_GRAYSCALE)
        if image is None or mask is None:
            log.warning("skipping unreadable sample %s", self.images[idx])
            return None
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        mask = self.lut[mask]  # one-gather remap
        return _resize_pair(image, mask, self.width, self.height)


class BDD100KSource(_DirSource):
    kind = "bdd100k"
    lut = BDD100K_LUT
    img_exts = (".jpg", ".png")


class CarlaSource(_DirSource):
    kind = "carla"
    lut = CARLA_LUT
    img_exts = (".png",)
    mask_exclude_suffix = "_viz.png"


class SEAMESource:
    """Polygon-annotated frames from a JSON-lines file."""

    def __init__(self, img_dir: str, annotation_file: str, width: int, height: int):
        _cv2("seame")
        self.img_dir = img_dir
        self.width = width
        self.height = height
        self.annotations: List[dict] = []
        with open(annotation_file) as f:
            for line in f:
                if line.strip():
                    self.annotations.append(json.loads(line))
        total = len(self.annotations)
        self.annotations = [a for a in self.annotations
                            if os.path.exists(os.path.join(img_dir, a["raw_file"]))]
        log.info("SEAME: %d/%d annotations have matching images", len(self.annotations), total)

    def __len__(self) -> int:
        return len(self.annotations)

    def rasterize(self, annotation: dict) -> np.ndarray:
        """fillPoly at native resolution (the reference's src/SEAMEDataset.py:84-103)."""
        cv2 = _cv2("seame")
        mask = np.zeros((annotation["image_height"], annotation["image_width"]), np.uint8)
        if "annotations" in annotation:
            for class_ann in annotation["annotations"]:
                class_id = SEAME_CLASS_MAP.get(class_ann["type"])
                if class_id is None:
                    continue
                for polygon in class_ann["polygons"]:
                    cv2.fillPoly(mask, np.array([polygon], np.int32), int(class_id))
        else:
            for polygon in annotation.get("polygons", []):
                cv2.fillPoly(mask, np.array([polygon], np.int32),
                             SEAME_CLASS_MAP["drivable_area"])
        return mask

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        cv2 = _cv2("seame")
        ann = self.annotations[idx]
        path = os.path.join(self.img_dir, ann["raw_file"])
        image = cv2.imread(path)
        if image is None:
            raise ValueError(f"Could not read image: {path}")
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        mask = self.rasterize(ann)
        return _resize_pair(image, mask, self.width, self.height)


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


class PackedSource:
    """The memory-mapped pre-decoded dataset that ``python -m
    tpuseg_torch.tools.pack_dataset`` writes: ``images.npy`` uint8
    [N,H,W,3] RGB, ``masks.npy`` uint8 [N,H,W] and ``meta.json``.

    The decode, remap and resize ran once, offline; ``load`` is a memmap
    slice copy served by the OS page cache, and ``load_batch`` gathers a
    whole batch in one call. No cv2."""

    def __init__(self, packed_dir: str, width: int, height: int):
        with open(os.path.join(packed_dir, "meta.json")) as f:
            meta = json.load(f)
        if (meta["width"], meta["height"]) != (width, height):
            raise ValueError(
                f"packed dataset {packed_dir!r} is {meta['width']}x{meta['height']}, "
                f"pipeline wants {width}x{height} — re-pack with python -m "
                "tpuseg_torch.tools.pack_dataset at the target size")
        self.images = np.load(os.path.join(packed_dir, "images.npy"), mmap_mode="r")
        self.masks = np.load(os.path.join(packed_dir, "masks.npy"), mmap_mode="r")
        if len(self.images) != len(self.masks):
            raise ValueError(f"packed dataset {packed_dir!r}: {len(self.images)} images "
                             f"vs {len(self.masks)} masks")

    def __len__(self) -> int:
        return len(self.images)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        # np.array() materializes the memmap slice
        return np.array(self.images[idx]), np.array(self.masks[idx])

    def load_batch(self, indices: np.ndarray, img_out: np.ndarray,
                   msk_out: np.ndarray) -> None:
        """Gather a whole batch in one call: the native GIL-free memcpy
        when its library loads (``ops/native_loader.py``), else numpy's
        fancy index, with identical bytes."""
        from tpuseg_torch.ops import native_loader

        if native_loader.available():
            native_loader.gather2(self.images, self.masks, indices, img_out, msk_out)
        else:
            img_out[:len(indices)] = self.images[indices]
            msk_out[:len(indices)] = self.masks[indices]


def build_source(cfg: DatasetSourceConfig, width: int, height: int):
    if cfg.kind == "bdd100k":
        return BDD100KSource(cfg.img_dir, cfg.mask_dir, width, height)
    if cfg.kind == "carla":
        return CarlaSource(cfg.img_dir, cfg.mask_dir, width, height)
    if cfg.kind == "seame":
        return SEAMESource(cfg.img_dir, cfg.annotation_file, width, height)
    if cfg.kind == "synthetic":
        return SyntheticSource(cfg.num_samples, width, height,
                               car_prob=cfg.car_prob, car_scale=cfg.car_scale)
    if cfg.kind == "packed":
        return PackedSource(cfg.packed_dir, width, height)
    raise KeyError(f"unknown source kind {cfg.kind!r}")
