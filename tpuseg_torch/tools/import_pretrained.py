"""Convert a PyTorch ``.pth`` state_dict into a train-ready checkpoint of the port.

The port's copy of ``tools/import_pretrained.py``, with the same flags:

    python -m tpuseg_torch.tools.import_pretrained --pth mobilenet_v2.pth \\
        --out checkpoints/pretrained

Two input flavours are detected:

- a torchvision ImageNet ``mobilenet_v2`` state_dict (``features.N.*``
  keys, ``classifier.*`` ignored): the ENCODER is imported and the decoder
  stays at the port's seeded init (``--model`` must be
  ``mobilenetv2_unet``), the reference's pretrained-at-construction start;
- a full reference state_dict (``backbone.features.*`` with ``upK``/
  ``outc``, or a UNet's ``inc``/``downK``/``sem_out`` with ``up1``):
  everything is imported.

The output is a checkpoint directory of the port, ``<out>/step_0.pt``
holding ``{"model": state_dict, "step": 0}``, which ``load_variables``
(``tpuseg_torch/infer/predictor.py``) reads for ``--train.init_checkpoint``,
``--infer.checkpoint``, ``--train.distill_checkpoint`` and ``python -m
tpuseg_torch.tools.eval_miou --checkpoint``. The conversion is host work:
the model is built on the CPU, and ``--platform`` (the JAX tool's flag) is
only checked.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pth", required=True, help="input .pth state_dict")
    ap.add_argument("--out", required=True, help="output checkpoint dir")
    ap.add_argument("--model", default="mobilenetv2_unet", help="model registry name")
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--platform", default="", help="cuda (default) or cpu: unused, "
                    "the conversion runs on the host")
    args = ap.parse_args(argv)

    import torch

    from tpuseg_torch.configs import ModelConfig
    from tpuseg_torch.core.checkpoint import CheckpointManager
    from tpuseg_torch.core.torch_import import (import_state_dict, import_torchvision_encoder,
                                                merge_variables)
    from tpuseg_torch.main import device_for_platform
    from tpuseg_torch.models.registry import build_model

    device_for_platform(args.platform or None)
    raw = torch.load(args.pth, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    model = build_model(ModelConfig(name=args.model, num_classes=args.num_classes))
    base = model.state_dict()
    if any(k.startswith(("up1.", "outc.")) for k in raw):      # a whole reference model
        print(f"full-model state_dict ({len(raw)} tensors): importing all")
        sd = import_state_dict(raw, args.model, base)
    else:
        print(f"encoder-only state_dict ({len(raw)} tensors): importing MobileNetV2 "
              "features, decoder stays at the seeded init")
        if args.model != "mobilenetv2_unet":
            print("ERROR: encoder-only import needs --model=mobilenetv2_unet")
            return 1
        enc = import_torchvision_encoder(raw)
        missing = [k for k in base if k.startswith("backbone.features.")
                   and not k.endswith("num_batches_tracked") and k not in enc]
        if missing:
            raise KeyError(f"state_dict does not look like a torchvision mobilenet_v2: "
                           f"missing key {missing[0]!r} (checkpoint starts with "
                           f"{sorted(raw)[:3]})")
        sd = merge_variables(base, enc)
    model.load_state_dict(sd, strict=True)
    CheckpointManager(args.out, max_to_keep=1).save(0, {"model": model.state_dict(),
                                                        "step": 0})
    n = sum(1 for _ in model.parameters())
    print(f"Wrote step-0 checkpoint ({n} param tensors) to {args.out}")
    print("Use with: python -m tpuseg_torch.main --train.init_checkpoint="
          f"{args.out}  (or --infer.checkpoint)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
