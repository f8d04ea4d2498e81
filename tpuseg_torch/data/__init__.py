"""The data layer: sources, the weighted mix, the input pipeline, augment."""

from tpuseg_torch.data.augment import augment_batch, make_augment_fn
from tpuseg_torch.data.class_maps import (BDD100K_CLASS_MAP, CARLA_CLASS_MAP, CLASS_NAMES,
                                          COLOR_MAP_BGR, COLOR_MAP_RGB, SEAME_CLASS_MAP,
                                          build_lut)
from tpuseg_torch.data.combined import CombinedDataset, WeightedMixSampler
from tpuseg_torch.data.pipeline import InputPipeline
from tpuseg_torch.data.sources import (BDD100KSource, CarlaSource, PackedSource, SEAMESource,
                                       SyntheticSource, build_source)

__all__ = [
    "BDD100K_CLASS_MAP",
    "CARLA_CLASS_MAP",
    "SEAME_CLASS_MAP",
    "CLASS_NAMES",
    "COLOR_MAP_BGR",
    "COLOR_MAP_RGB",
    "build_lut",
    "BDD100KSource",
    "CarlaSource",
    "SEAMESource",
    "SyntheticSource",
    "PackedSource",
    "build_source",
    "CombinedDataset",
    "WeightedMixSampler",
    "InputPipeline",
    "augment_batch",
    "make_augment_fn",
]
