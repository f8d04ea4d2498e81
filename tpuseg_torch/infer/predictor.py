"""Batched serving: uint8 RGB frames in, per-pixel class maps out.

The port of ``tpuseg/infer/predictor.py`` with its call contract: uint8 RGB
frames [B, H, W, 3] of any fixed size go in, uint8 class maps [B, H, W] at
the same size come out, plus packed uint32 colours (0x00RRGGBB of the BGR
palette) when colorize is on. On the device, in one pass: bilinear resize
to the model size (half-pixel, cv2 INTER_LINEAR convention), normalize,
forward, then argmax — or, with colorize, the CUDA ``argmax_colorize``
kernel, which ``use_pallas`` forces on as in the JAX package. On the card
that pass is one CUDA graph per (batch size, frame size, output size),
captured at its first call and replayed after (``core/graphs.py``), the
counterpart of the JAX Predictor's cache of jitted programs; its outputs
are the graph's tensors until the next call at the same key. A graph holds
the memory of the whole pass (its intermediates at frame size), where a
jitted program holds none, so the cache keeps at most ``MAX_GRAPHS`` keys:
past that the least recently called one is dropped with its memory, and
captured again if it comes back. The HTTP server's buckets and the video
pipeline use a few fixed keys; callers with frames of many sizes recapture.

The nearest upscale back to the frame size runs on the host by default
(``upscale_on_host``), in numpy with the ``floor(i*n/m)`` index formula of
``resize_nearest`` — no cv2 — so only model-size maps cross to the host;
``upscale_on_host=False`` runs ``resize_nearest`` on the device instead.

The serving options of the JAX Predictor:

- ``preprocess_on_host``: the model-size downscale runs on the host on the
  uint8 frames, with cv2 INTER_LINEAR where cv2 imports and its numpy
  replica ``resize_linear_u8_host`` (bit-equal) where it does not;
  ``preprocess_route`` says which;
- ``device_close``: the 5x5 road close (``ops/morphology.py``) runs on the
  device at frame resolution and is packed into bit 0x80 of the class map;
- ``fetch_pack4``: two 4-bit class ids per fetched byte, unpacked on the
  host by ``unpack4_host``;
- ``predict_async``: dispatch without a sync, returning the device tensors
  (the VideoPipeline's hook).

One guard differs on purpose from the JAX package (ROADMAP C1): fetch_pack4
is checked against the effective colorize flag, so ``use_pallas`` (which
forces colorize on) with ``fetch_pack4`` raises here, where the JAX package
goes on and unpacks ids that were never packed.

Every family of the registry serves through it, the model built from
``model_cfg``; ``light_unet``'s one output channel gives class 0 at every
pixel, as the JAX Predictor's argmax does.

Checkpoints: ``""`` gives a seeded init, a path ending in ``.pth`` is a
state_dict (reference key names; flax's module names for FPN and DeepLab),
and a training checkpoint of the port (a ``step_<N>.pt`` file, or a
checkpoint directory, whose latest step is taken) serves its EMA weights
when it has them, as the JAX package serves ``ema_params``. The port does
not read Orbax: a checkpoint directory of the JAX package is converted
once, where JAX is, by ``tools/orbax_to_torch.py`` (and a torchvision
encoder by ``python -m tpuseg_torch.tools.import_pretrained``). A
checkpoint that carries a calibrated int8 ``quant`` collection
(``export/int8_full.py::save_quantized``, ``python -m tpuseg_torch.convert
--export.format=quantized``, or a JAX one converted) is served in int8:
``self.int8`` is set and every calibrated conv runs int8 x int8 -> int32
inside the captured pass, as the JAX Predictor binds ``quant``.

``artifact``: a ``torch.export`` program written by
``export/torch_export.py::export_model`` (``python -m tpuseg_torch.convert
--export.format=stablehlo``) is served in place of the live model, as the
JAX Predictor serves its StableHLO artifact: the checkpoint is ignored
(the weights are in the program), the program takes the resized and
normalized NHWC images and its logits go to the same head
(``argmax_colorize`` with colorize on). A mesh raises.

``mesh`` (``tpuseg_torch.core.mesh``, more than one rank): every rank calls
the Predictor on the same frames, runs its rows of the batch (the
captured pass above) and all-gathers the class maps (and colours) over
the data axis, so every rank returns the whole batch's, as the JAX
Predictor's batch-sharded jit does. The weights are rank 0's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from tpuseg_torch.configs import ModelConfig
from tpuseg_torch.core import graphs
from tpuseg_torch.core.dtypes import resolve_device
from tpuseg_torch.core.mesh import all_gather, batch_slice, replicate
from tpuseg_torch.data.augment import normalize_images
from tpuseg_torch.data.class_maps import COLOR_MAP_BGR, IMAGENET_MEAN, IMAGENET_STD
from tpuseg_torch.infer.postprocess import ROAD_CLASS, cv2_or_none
from tpuseg_torch.models.registry import build_model, validate_input_size
from tpuseg_torch.ops.kernels import argmax_colorize
from tpuseg_torch.ops.morphology import morph_close
from tpuseg_torch.ops.resize import (resize_bilinear, resize_linear_u8_host, resize_nearest,
                                     resize_nearest_host)

StateDict = Dict[str, torch.Tensor]


def unpack4_host(packed: np.ndarray) -> np.ndarray:
    """Inverse of the device-side fetch_pack4 nibble pack: [B, h, w/2]
    uint8 -> [B, h, w] class ids (high nibble = even column)."""
    b, h, wp = packed.shape
    out = np.empty((b, h, wp * 2), np.uint8)
    out[..., 0::2] = packed >> 4
    out[..., 1::2] = packed & 0x0F
    return out


def host_resize_linear(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2 INTER_LINEAR downscale of uint8 [B, H, W, C] frames: cv2 where it
    imports, its bit-equal numpy replica where it does not."""
    cv2 = cv2_or_none()
    if cv2 is None:
        return resize_linear_u8_host(frames, out_h, out_w)
    out = np.empty((frames.shape[0], out_h, out_w, frames.shape[3]), frames.dtype)
    for i in range(frames.shape[0]):
        out[i] = cv2.resize(frames[i], (out_w, out_h), interpolation=cv2.INTER_LINEAR)
    return out


Quant = Dict[str, Dict[str, torch.Tensor]]


def load_checkpoint(checkpoint: str, init_fn: Callable[[], StateDict]
                    ) -> Tuple[StateDict, Optional[Quant]]:
    """Resolve a checkpoint path into (the model's state_dict, its int8
    ``quant`` collection or None)."""
    if not checkpoint:
        return init_fn(), None
    if checkpoint.endswith(".pth"):
        from tpuseg_torch.core.weights import load_pth

        return load_pth(checkpoint), None
    if checkpoint.endswith(".pt") and os.path.isfile(checkpoint):
        return _training_weights(torch.load(checkpoint, map_location="cpu", weights_only=True))
    if os.path.isdir(checkpoint):
        from tpuseg_torch.core.checkpoint import CheckpointManager

        mgr = CheckpointManager(checkpoint)
        if mgr.latest_step() is not None:
            return _training_weights(mgr.restore())
        raise NotImplementedError(
            f"{checkpoint!r} holds no checkpoint of the port. The port does not read "
            "Orbax checkpoint directories (that needs orbax, hence JAX): convert one "
            f"where JAX is, with python tools/orbax_to_torch.py --checkpoint {checkpoint} "
            "--out <dir>, and pass <dir>")
    raise FileNotFoundError(f"checkpoint {checkpoint!r} not found")


def load_variables(checkpoint: str, init_fn: Callable[[], StateDict]) -> StateDict:
    """The model's state_dict of a checkpoint path (its ``quant``, if any,
    left out: what a Trainer's ``init_checkpoint`` takes, as the JAX one
    takes ``params`` and ``batch_stats`` alone)."""
    return load_checkpoint(checkpoint, init_fn)[0]


def _training_weights(payload: dict) -> Tuple[StateDict, Optional[Quant]]:
    """A port checkpoint's model state_dict, with its EMA parameters in
    place of the raw ones when it has them (they are what the Trainer
    evaluated and selected the best checkpoint by), and its ``quant``."""
    weights = dict(payload["model"])
    weights.update(payload.get("ema") or {})
    return weights, payload.get("quant") or None


class Predictor:
    """Batched (frames -> class maps) on one device."""

    MAX_GRAPHS = 8      # captured device passes kept (see the module)

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
        pass ``"cpu"`` to run the plain PyTorch path on the CPU. The
        ValueErrors are the JAX Predictor's guards, in its order."""
        if mesh is not None and model_cfg.use_pallas:
            raise ValueError("use_pallas is single-chip only; Pallas kernels are not "
                             "partitionable across a mesh")
        if mesh is not None:
            n_data = mesh.shape.get("data", 1)
            if batch_size % n_data:
                raise ValueError(f"batch_size {batch_size} not divisible by the mesh's "
                                 f"data axis ({n_data} devices)")
        if artifact and mesh is not None:
            raise ValueError("artifact serving is single-chip: the exported computation "
                             "carries no sharding annotations for GSPMD to partition")
        # use_pallas forces colorize on (the CUDA argmax_colorize kernel), as
        # in the JAX package; fetch_pack4 is checked against this effective
        # flag (ROADMAP C1)
        colorize = colorize_on_device or model_cfg.use_pallas
        if fetch_pack4:
            if model_cfg.num_classes > 16:
                raise ValueError(f"fetch_pack4 packs class ids into 4 bits; model has "
                                 f"{model_cfg.num_classes} classes (> 16)")
            if device_close or colorize:
                raise ValueError(
                    "fetch_pack4 is incompatible with device_close (uses bit 0x80) and "
                    "colorize_on_device (the 4 B/px color fetch dominates anyway); "
                    "use_pallas forces colorize_on_device on")
            if not upscale_on_host:
                raise ValueError(
                    "fetch_pack4 shrinks the model-res fetch; it requires "
                    "upscale_on_host=True (the frame-res path re-inflates the fetch it "
                    "exists to shrink)")
            if input_hw[1] % 2:
                raise ValueError("fetch_pack4 needs an even model width")
        if device_close and upscale_on_host:
            raise ValueError(
                "device_close runs the 5x5 morph-close at the device program's output "
                "resolution; pass upscale_on_host=False so that is the frame resolution "
                "(reference parity)")
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.model = build_model(model_cfg)
        validate_input_size(self.model, *input_hw)
        self.input_hw = tuple(input_hw)
        self.batch_size = batch_size
        self.colorize_on_device = colorize
        self.upscale_on_host = upscale_on_host
        self.fetch_pack4 = fetch_pack4
        self.device_close = device_close
        self.preprocess_on_host = preprocess_on_host
        # which host resize preprocess_on_host runs: "cv2" or "numpy"
        self.preprocess_route = (("numpy" if cv2_or_none() is None else "cv2")
                                 if preprocess_on_host else None)
        self.normalize_mean = tuple(
            IMAGENET_MEAN.tolist() if normalize_mean is None else normalize_mean)
        self.normalize_std = tuple(
            IMAGENET_STD.tolist() if normalize_std is None else normalize_std)
        self.artifact_call = None
        quant = None
        if artifact:
            from tpuseg_torch.export.torch_export import load_exported

            # the weights are the program's; the model only checked the size
            self.artifact_call = load_exported(artifact, self.device)
        else:
            weights, quant = load_checkpoint(checkpoint, self.model.state_dict)
            self.model.load_state_dict(weights)
            self.model.to(self.device, memory_format=torch.channels_last).eval()
            replicate(self.model, self.mesh)
        # a calibrated int8 checkpoint: its convs run int8 x int8 -> int32
        self.int8 = quant is not None
        if self.int8:
            from tpuseg_torch.export.int8_full import bind_quant

            bind_quant(self.model, quant)
        # the device pass, one CUDA graph per input shape and out_hw
        self._device_forward = graphs.Captured(self._device_forward_eager, "serve_forward",
                                               max_keys=self.MAX_GRAPHS)

    @torch.inference_mode()
    def _device_forward_eager(self, frames: torch.Tensor, out_hw: Tuple[int, int]):
        """uint8 NHWC frames on the device -> (class maps, colours or None)
        at ``out_hw``, still on the device. With ``fetch_pack4`` the class
        maps are nibble pairs [B, h, w/2]; with ``device_close`` bit 0x80
        carries the closed road mask. ``_device_forward`` is this pass,
        captured."""
        mh, mw = self.input_hw
        x = frames.to(torch.float32)
        if tuple(frames.shape[1:3]) != (mh, mw):
            x = resize_bilinear(x, mh, mw, align_corners=False)
        x = normalize_images(x, self.normalize_mean, self.normalize_std)
        if self.artifact_call is not None:
            logits = self.artifact_call(x)
        else:
            # NHWC -> an NCHW view with channels_last strides (no copy)
            logits = self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.colorize_on_device:
            classes, packed = argmax_colorize(logits.contiguous(), COLOR_MAP_BGR)
        else:
            classes, packed = logits.argmax(dim=-1).to(torch.uint8), None
        if tuple(out_hw) != (mh, mw):
            # nearest upscale commutes with the palette lookup
            classes = resize_nearest(classes, *out_hw)
            packed = None if packed is None else resize_nearest(packed, *out_hw)
        elif self.fetch_pack4:
            # two 4-bit ids per fetched byte (high nibble = even column)
            classes = (classes[..., 0::2] << 4) | classes[..., 1::2]
        if self.device_close:
            closed = morph_close(classes == ROAD_CLASS, 5)
            classes = classes | (closed.to(torch.uint8) << 7)
        return classes, packed

    def _maybe_host_resize(self, frames: np.ndarray) -> np.ndarray:
        """preprocess_on_host: the model-size INTER_LINEAR downscale of the
        uint8 frames on the host (cv2, or its numpy replica)."""
        mh, mw = self.input_hw
        if not self.preprocess_on_host or frames.shape[1:3] == (mh, mw):
            return frames
        return host_resize_linear(frames, mh, mw)

    def predict_async(self, frames: np.ndarray, out_hw: Optional[Tuple[int, int]] = None):
        """Dispatch without a host sync: the device tensors, (classes,
        colours) with colorize and classes alone without, in the layout
        ``_device_forward`` describes. On the card they are the captured
        graph's outputs, which the next call at the same shapes overwrites:
        copy them, or queue their reads before that call.

        ``out_hw``: the true frame size when the caller already downscaled
        the frames; without ``upscale_on_host`` it is the device upscale's
        target. Defaults to the frames' own size."""
        if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"frames must be uint8 [B, H, W, 3], got "
                             f"{frames.dtype} {frames.shape}")
        fh, fw = out_hw if out_hw is not None else frames.shape[1:3]
        dev_hw = self.input_hw if self.upscale_on_host else (fh, fw)
        x = torch.from_numpy(np.ascontiguousarray(self._maybe_host_resize(frames)))
        if self.mesh is not None:
            x = x[batch_slice(self.mesh, x.shape[0])]
        classes, packed = self._device_forward(x.to(self.device), dev_hw)
        if self.mesh is not None:
            classes, packed = (None if t is None else torch.cat(
                all_gather(t, self.mesh, self.mesh.data_group)) for t in (classes, packed))
        return (classes, packed) if self.colorize_on_device else classes

    def finish_host(self, classes: np.ndarray, packed: Optional[np.ndarray],
                    fh: int, fw: int):
        """Fetched device outputs -> the __call__ result at frame size
        (unpack the nibble pairs, then the host nearest upscale)."""
        if self.fetch_pack4:
            classes = unpack4_host(classes)
        if classes.shape[1:] != (fh, fw):
            classes = resize_nearest_host(classes, fh, fw)
            packed = None if packed is None else resize_nearest_host(packed, fh, fw)
        return classes if packed is None else (classes, packed)

    def __call__(self, frames: np.ndarray):
        """frames: uint8 RGB [B, H, W, 3] -> class maps uint8 [B, H, W]
        (plus packed-BGR uint32 colours when colorize is on)."""
        out = self.predict_async(frames)
        classes, packed = out if self.colorize_on_device else (out, None)
        return self.finish_host(classes.cpu().numpy(),
                                None if packed is None else packed.cpu().numpy(),
                                frames.shape[1], frames.shape[2])
