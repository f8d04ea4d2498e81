"""torchvision and reference ``.pth`` state_dicts -> the port's state_dict.

The port of ``tpuseg/core/torch_import.py``. The port's module names are
torchvision's and the reference's (``backbone.features.N.conv.M.*``,
``upK.conv.conv.N.*``, ``outc.conv.N.*``; the UNet's ``inc``, ``downK``,
``sem_out``), so an import is a mapping of keys on state_dicts: no NCHW ->
NHWC transpose, no renaming of BatchNorm's tensors.

- ``import_torchvision_encoder``: an ImageNet ``mobilenet_v2`` state_dict
  (``features.N.*``, or ``backbone.features.N.*``) -> the encoder's
  entries (``backbone.features.N.*``). ``classifier.*`` is ignored, and so
  are BatchNorm's ``num_batches_tracked`` counters, which the JAX importer
  does not read either (flax has none).
- ``merge_variables``: an overlay over a base state_dict; every overlay key
  must be in the base with the same shape (KeyError, ValueError).
- ``import_state_dict``: a full reference state_dict of a registry family
  that has one (``mobilenetv2_unet``, ``unet``, ``light_unet``) -> the
  model's state_dict, with the reference's duplicate encoder keys dropped.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from tpuseg_torch.core.weights import drop_encoder_slices

StateDict = Dict[str, torch.Tensor]

# registry names with a reference checkpoint layout
IMPORTABLE = ("mobilenetv2_unet", "unet", "light_unet")


def import_torchvision_encoder(sd: Mapping[str, torch.Tensor]) -> StateDict:
    """ImageNet-pretrained torchvision ``mobilenet_v2`` state_dict -> the
    encoder's entries of the port's state_dict (see the module). Merge the
    result over a seeded model's state_dict with ``merge_variables`` to get
    a train-ready init (the reference's pretrained-at-construction
    encoder, ``mobilenet_v2(weights=DEFAULT).features``)."""
    prefix = ("backbone.features." if any(k.startswith("backbone.features.") for k in sd)
              else "features.")
    return {"backbone.features." + k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix) and not k.endswith("num_batches_tracked")}


def merge_variables(base: Mapping[str, torch.Tensor],
                    overlay: Mapping[str, torch.Tensor]) -> StateDict:
    """``base`` with ``overlay``'s entries in place of its own, each checked
    to exist in ``base`` with the same shape."""
    out = dict(base)
    for k, v in overlay.items():
        if k not in base:
            raise KeyError(f"overlay key {k!r} not present in model tree")
        bs, vs = tuple(base[k].shape), tuple(v.shape)
        if bs != vs:
            raise ValueError(f"shape mismatch at {k!r}: {vs} vs {bs}")
        out[k] = v
    return out


def import_state_dict(sd: Mapping[str, torch.Tensor], model_name: str,
                      target: Mapping[str, torch.Tensor]) -> StateDict:
    """A full reference state_dict of ``model_name`` -> the model's
    state_dict (``target`` is the model's own, which gives the keys and
    shapes). A key of the model missing from ``sd`` raises the JAX
    importer's KeyError; BatchNorm counters missing there keep the model's."""
    if model_name not in IMPORTABLE:
        raise KeyError(f"no importer for model {model_name!r}")
    sd = drop_encoder_slices(sd)
    for k in target:
        if k not in sd and not k.endswith("num_batches_tracked"):
            raise KeyError(
                f"state_dict does not look like a {model_name!r} checkpoint: "
                f"missing key {k!r} (checkpoint starts with {sorted(sd)[:3]}). "
                "Did you pass the right --model.name?")
    return merge_variables(target, {k: sd[k] for k in target if k in sd})
