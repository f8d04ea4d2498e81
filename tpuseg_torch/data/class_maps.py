"""The 10-class road-scene label scheme, the per-source id remaps, the
palettes and the ImageNet normalization constants.

Copied from the JAX package's ``tpuseg/data/class_maps.py`` (the port
imports nothing of it). Class scheme:

    0 background, 1 road, 2 car, 3 traffic light, 4 traffic sign,
    5 person, 6 sidewalk, 7 truck, 8 bus, 9 motorcycle/bicycle/rider

Each source's id map is compiled once into a 256-entry uint8 LUT, so the
remap of a mask is one vectorized gather.
"""

from __future__ import annotations

import numpy as np

CLASS_NAMES = (
    "background",
    "road",
    "car",
    "traffic_light",
    "traffic_sign",
    "person",
    "sidewalk",
    "truck",
    "bus",
    "motorcycle",
)
NUM_CLASSES = len(CLASS_NAMES)

# BDD100K trainId -> ours (the reference's src/BDD100KDataset.py:23-35)
BDD100K_CLASS_MAP = {
    0: 1, 13: 2, 6: 3, 7: 4, 11: 5, 1: 6, 14: 7, 15: 8, 17: 9, 18: 9, 12: 9,
}

# CARLA semantic id -> ours (src/CarlaDataset.py:22-36)
CARLA_CLASS_MAP = {
    1: 1, 24: 1, 14: 2, 7: 3, 8: 4, 12: 5, 2: 6, 15: 7, 16: 8, 18: 9, 19: 9,
    13: 9,
}

# SEAME polygon annotation type -> ours (src/SEAMEDataset.py:26-30)
SEAME_CLASS_MAP = {"background": 0, "drivable_area": 1, "car": 2}

# Overlay palette, BGR (the reference draws with cv2 in BGR).
COLOR_MAP_BGR = np.array(
    [
        [0, 0, 0],        # 0 background
        [0, 255, 0],      # 1 road
        [255, 0, 0],      # 2 car
        [250, 170, 30],   # 3 traffic light
        [220, 220, 0],    # 4 traffic sign
        [220, 20, 60],    # 5 person
        [244, 35, 232],   # 6 sidewalk
        [0, 0, 70],       # 7 truck
        [0, 60, 100],     # 8 bus
        [0, 0, 230],      # 9 motorcycle
    ],
    dtype=np.uint8,
)
COLOR_MAP_RGB = COLOR_MAP_BGR[:, ::-1].copy()

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def build_lut(class_map: dict, size: int = 256) -> np.ndarray:
    """Compile an id->id dict into a flat uint8 lookup table; unmapped
    source ids go to 0 (background)."""
    lut = np.zeros(size, dtype=np.uint8)
    for src, dst in class_map.items():
        lut[src] = dst
    return lut


BDD100K_LUT = build_lut(BDD100K_CLASS_MAP)
CARLA_LUT = build_lut(CARLA_CLASS_MAP)
