"""Model registry: name -> constructor, driven by ModelConfig.

The five families of the JAX package's registry, with its defaults:
``base_filters`` sets the FPN and ASPP widths (0 -> 128) and the UNets'
(0 -> 64 and 32); ``stem_s2d`` reaches the two MobileNetV2 families that
take it in the JAX package (FPN and DeepLab) and the flagship; every
family computes in ``compute_dtype`` (``core/dtypes.py``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn

from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.dtypes import set_compute_dtype
from tpuseg_torch.models.deeplab import MobileNetV2DeepLab
from tpuseg_torch.models.fpn import MobileNetV2FPN
from tpuseg_torch.models.mobilenetv2_unet import MobileNetV2UNet
from tpuseg_torch.models.unet import LightUNet, UNet

MODEL_REGISTRY: Dict[str, Callable[[ModelConfig], nn.Module]] = {
    "mobilenetv2_unet": lambda cfg: MobileNetV2UNet(
        output_channels=cfg.num_classes,
        width_mult=cfg.width_mult,
        use_pallas=cfg.use_pallas,
        stem_s2d=cfg.stem_s2d,
        up_subpixel=cfg.up_subpixel,
        head_fp32=cfg.head_fp32,
    ),
    "mobilenetv2_fpn": lambda cfg: MobileNetV2FPN(
        output_channels=cfg.num_classes,
        width_mult=cfg.width_mult,
        fpn_channels=cfg.base_filters or 128,
        stem_s2d=cfg.stem_s2d,
    ),
    "mobilenetv2_deeplab": lambda cfg: MobileNetV2DeepLab(
        output_channels=cfg.num_classes,
        width_mult=cfg.width_mult,
        aspp_channels=cfg.base_filters or 128,
        stem_s2d=cfg.stem_s2d,
    ),
    "unet": lambda cfg: UNet(
        output_channels=cfg.num_classes, base_filters=cfg.base_filters or 64),
    # one output channel whatever num_classes says, as in the JAX package
    "light_unet": lambda cfg: LightUNet(base_filters=cfg.base_filters or 32),
}

_UNETS = ("unet", "light_unet")


def _check_name(name: str) -> None:
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        )


def build_model(cfg: ModelConfig, seed: int = 0) -> nn.Module:
    """The model of ``cfg`` on the CPU, initialized from ``seed``
    (``tpuseg_torch.core.weights.init_weights``; global RNG untouched)."""
    from tpuseg_torch.core.prng import make_generator
    from tpuseg_torch.core.weights import init_weights

    _check_name(cfg.name)
    with torch.device("meta"):
        model = MODEL_REGISTRY[cfg.name](cfg)
    model = model.to_empty(device="cpu")
    init_weights(model, make_generator(seed))
    return set_compute_dtype(model, cfg.compute_dtype)


def size_divisor(model) -> int:
    """H and W must be multiples of this (an instance or a registry name):
    the MobileNetV2 encoders downsample x32, the UNets pool x8, and the
    decoders' exact 2x upsamples must land back on every skip grid."""
    if isinstance(model, str):
        _check_name(model)
        return 8 if model in _UNETS else 32
    if isinstance(model, UNet):
        return 8
    if isinstance(model, (MobileNetV2UNet, MobileNetV2FPN, MobileNetV2DeepLab)):
        return 32
    return 1


def validate_input_size(model, height: int, width: int) -> None:
    """Raise a clear ValueError when height/width violate the model's
    divisibility contract."""
    down = size_divisor(model)
    if height % down or width % down:
        name = model if isinstance(model, str) else type(model).__name__
        raise ValueError(
            f"{name} requires input height and width to be multiples of "
            f"{down}; got {height}x{width} (the encoder downsamples x{down} "
            f"and the decoder's exact 2x upsamples must land back on every "
            f"skip-connection grid)"
        )
