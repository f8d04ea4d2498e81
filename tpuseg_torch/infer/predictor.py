"""Batched serving: uint8 RGB frames in, per-pixel class maps out.

The port of ``tpuseg/infer/predictor.py`` with its call contract: uint8 RGB
frames [B, H, W, 3] of any fixed size go in, uint8 class maps [B, H, W] at
the same size come out, plus packed uint32 colours (0x00RRGGBB of the BGR
palette) when colorize is on. On the device, in one eager pass: bilinear
resize to the model size (half-pixel, cv2 INTER_LINEAR convention),
normalize, forward, then argmax — or, with colorize, the CUDA
``argmax_colorize`` kernel, which ``use_pallas`` forces on as in the JAX
package.

The nearest upscale back to the frame size runs on the host by default
(``upscale_on_host``), in numpy with the ``floor(i*n/m)`` index formula of
``resize_nearest`` — no cv2 — so only model-size maps cross to the host;
``upscale_on_host=False`` runs ``resize_nearest`` on the device instead.

Every family of the registry serves through it, the model built from
``model_cfg``; ``light_unet``'s one output channel gives class 0 at every
pixel, as the JAX Predictor's argmax does.

Checkpoints: ``""`` gives a seeded init, a path ending in ``.pth`` is a
state_dict (reference key names; flax's module names for FPN and DeepLab). Not ported yet, each raising NotImplementedError with
its ROADMAP.md item: Orbax directories, ``artifact``, ``mesh``,
``preprocess_on_host``, ``device_close``, ``fetch_pack4`` and int8 ``quant``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core.dtypes import resolve_device
from tpuseg_torch.data.augment import normalize_images
from tpuseg_torch.data.class_maps import COLOR_MAP_BGR, IMAGENET_MEAN, IMAGENET_STD
from tpuseg_torch.models.registry import build_model, validate_input_size
from tpuseg_torch.ops.kernels import argmax_colorize
from tpuseg_torch.ops.resize import resize_bilinear, resize_nearest, resize_nearest_host

StateDict = Dict[str, torch.Tensor]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


def load_variables(checkpoint: str, init_fn: Callable[[], StateDict]) -> StateDict:
    """Resolve a checkpoint path into the model's state_dict."""
    if not checkpoint:
        return init_fn()
    if checkpoint.endswith(".pth"):
        from tpuseg_torch.core.weights import load_pth

        return load_pth(checkpoint)
    if os.path.isdir(checkpoint):
        raise _not_ported("loading an Orbax checkpoint directory (it needs "
                          "orbax, hence JAX)", "Orbax loading")
    raise FileNotFoundError(f"checkpoint {checkpoint!r} not found")


class Predictor:
    """Batched (frames -> class maps) on one device."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        checkpoint: str = "",
        input_hw: Tuple[int, int] = (128, 256),
        batch_size: int = 8,
        colorize_on_device: bool = False,
        upscale_on_host: bool = True,
        preprocess_on_host: bool = False,
        device_close: bool = False,
        fetch_pack4: bool = False,
        mesh=None,
        normalize_mean=None,
        normalize_std=None,
        artifact: str = "",
        device: Optional[Union[str, torch.device]] = None,
    ):
        """``device``: None means the CUDA card, and raises without one;
        pass ``"cpu"`` to run the plain PyTorch path on the CPU."""
        for flag, what, item in (
            (artifact, "artifact serving", "queue A9, export"),
            (mesh is not None, "mesh (multi-device) serving", "A13, multi-GPU"),
            (preprocess_on_host, "preprocess_on_host", "A5, serving"),
            (device_close, "device_close", "A5, serving"),
            (fetch_pack4, "fetch_pack4", "A5, fetch_pack4 with the C1 check"),
        ):
            if flag:
                raise _not_ported(what, item)
        self.device = resolve_device(device)
        self.model = build_model(model_cfg)
        validate_input_size(self.model, *input_hw)
        self.input_hw = tuple(input_hw)
        self.batch_size = batch_size
        # use_pallas forces colorize on: the CUDA argmax_colorize kernel
        self.colorize_on_device = colorize_on_device or model_cfg.use_pallas
        self.upscale_on_host = upscale_on_host
        self.normalize_mean = tuple(
            IMAGENET_MEAN.tolist() if normalize_mean is None else normalize_mean)
        self.normalize_std = tuple(
            IMAGENET_STD.tolist() if normalize_std is None else normalize_std)
        self.model.load_state_dict(
            load_variables(checkpoint, self.model.state_dict))
        self.model.to(self.device, memory_format=torch.channels_last).eval()

    @torch.inference_mode()
    def _device_forward(self, frames: torch.Tensor, out_hw: Tuple[int, int]):
        """uint8 NHWC frames on the device -> class maps (and colours) at
        ``out_hw``, still on the device."""
        mh, mw = self.input_hw
        x = frames.to(torch.float32)
        if tuple(frames.shape[1:3]) != (mh, mw):
            x = resize_bilinear(x, mh, mw, align_corners=False)
        x = normalize_images(x, self.normalize_mean, self.normalize_std)
        # NHWC -> an NCHW view with channels_last strides (no copy)
        logits = self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.colorize_on_device:
            classes, packed = argmax_colorize(logits.contiguous(), COLOR_MAP_BGR)
        else:
            classes, packed = logits.argmax(dim=-1).to(torch.uint8), None
        if out_hw != (mh, mw):
            classes = resize_nearest(classes, *out_hw)
            packed = None if packed is None else resize_nearest(packed, *out_hw)
        return classes, packed

    def __call__(self, frames: np.ndarray):
        """frames: uint8 RGB [B, H, W, 3] -> class maps uint8 [B, H, W]
        (plus packed-BGR uint32 colours when colorize is on)."""
        if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"frames must be uint8 [B, H, W, 3], got "
                             f"{frames.dtype} {frames.shape}")
        fh, fw = frames.shape[1], frames.shape[2]
        out_hw = self.input_hw if self.upscale_on_host else (fh, fw)
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        classes, packed = self._device_forward(x, out_hw)
        classes = classes.cpu().numpy()
        packed = None if packed is None else packed.cpu().numpy()
        if classes.shape[1:] != (fh, fw):
            classes = resize_nearest_host(classes, fh, fw)
            packed = None if packed is None else resize_nearest_host(packed, fh, fw)
        return classes if packed is None else (classes, packed)
