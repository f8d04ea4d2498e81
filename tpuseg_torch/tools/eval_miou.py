"""Eval-only entry point: dataset + checkpoint -> mIoU (one JSON line).

The port's copy of ``tools/eval_miou.py``, with its flags and kinds:

    python -m tpuseg_torch.tools.eval_miou --data_dir /path/to/bdd100k \\
        --checkpoint checkpoints [--platform cpu]
    python -m tpuseg_torch.tools.eval_miou --kind synthetic --samples 64 \\
        --checkpoint checkpoints

``--data_dir`` expects the BDD100K layout (``images/`` + ``masks/``;
override with ``--img_dir``/``--mask_dir``, or ``--kind carla|seame|
synthetic``); the directory kinds decode with cv2 (a host without it
refuses them, naming the packed route). The checkpoint is anything
``load_checkpoint`` reads: a checkpoint directory or ``step_<N>.pt`` of the
port (its EMA weights when it has them), a reference ``.pth``, or ``''`` for
a seeded init; an Orbax directory of the JAX package is converted first with
``tools/orbax_to_torch.py``, and a checkpoint with an int8 ``quant`` tree is
refused, naming ``python -m tpuseg_torch.tools.eval_quantized``.

It runs the code ``Trainer.evaluate`` runs: ``InputPipeline.eval_batches``
(a zero-padded last batch), ``make_eval_step`` (the confusion matrix on the
device; a captured graph per batch shape on the card) and
``train/metrics.py``. ``--limit N`` scores N images evenly strided across
the dataset; ``--holdout_val_split`` carves the Trainer's seeded split
(``--holdout_seed`` = training's ``--data.seed``) and scores its val side
only. It runs on the card unless ``--platform cpu``.

Prints ONE JSON line: {"miou", "pixel_acc", "val_loss", "iou_per_class",
"n_images"}.
"""

from __future__ import annotations

import argparse
import json
import sys


class _Strided:
    """``base``'s samples at ``idx``."""

    def __init__(self, base, idx):
        self.base, self.idx = base, idx

    def __len__(self) -> int:
        return len(self.idx)

    def load(self, i: int):
        return self.base.load(int(self.idx[i]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", default="",
                   help="dataset root with images/ + masks/ (bdd100k layout)")
    p.add_argument("--img_dir", default="")
    p.add_argument("--mask_dir", default="")
    p.add_argument("--annotation_file", default="", help="seame JSONL")
    p.add_argument("--kind", default="bdd100k",
                   choices=["bdd100k", "carla", "seame", "synthetic"])
    p.add_argument("--checkpoint", default="",
                   help="the port's checkpoint dir or .pt, or a .pth ('' = seeded init)")
    p.add_argument("--model", default="mobilenetv2_unet")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--base_filters", type=int, default=0)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--samples", type=int, default=64,
                   help="synthetic only: number of val samples")
    p.add_argument("--limit", type=int, default=0,
                   help="evaluate only N images, evenly strided across the dataset "
                        "(0 = all)")
    p.add_argument("--holdout_val_split", type=float, default=0.0,
                   help="carve the Trainer's seeded train/val split (--data.val_split) "
                        "and evaluate only the held-out side (0 = score everything)")
    p.add_argument("--holdout_seed", type=int, default=42,
                   help="split seed; must match training's --data.seed")
    p.add_argument("--normalize_mean", default="",
                   help='comma-separated, e.g. "0.5,0.5,0.5" (default: ImageNet)')
    p.add_argument("--normalize_std", default="")
    p.add_argument("--ms_scales", default="0.75,1.25",
                   help="multi-scale TTA scale factors (snapped to the encoder's /32 "
                        "pyramid)")
    p.add_argument("--tta", default="", choices=["", "flip", "ms", "flip+ms"],
                   help="test-time augmentation: 'flip' averages the logits with the "
                        "mirrored forward's, 'ms' those at --ms_scales, 'flip+ms' both")
    p.add_argument("--platform", default="", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import os

    import numpy as np
    import torch

    from tpuseg_torch.configs import DatasetSourceConfig, ModelConfig
    from tpuseg_torch.core.dtypes import resolve_device
    from tpuseg_torch.data.class_maps import IMAGENET_MEAN, IMAGENET_STD
    from tpuseg_torch.data.combined import CombinedDataset
    from tpuseg_torch.data.pipeline import InputPipeline
    from tpuseg_torch.data.sources import build_source
    from tpuseg_torch.infer.predictor import load_checkpoint
    from tpuseg_torch.main import device_for_platform
    from tpuseg_torch.models.registry import build_model
    from tpuseg_torch.train.metrics import (iou_from_confusion, mean_iou,
                                            pixel_accuracy_from_confusion)
    from tpuseg_torch.train.train_step import make_eval_step, sum_eval_outputs

    device = resolve_device(device_for_platform(args.platform or None))
    if device.type == "cuda":      # fp32 is fp32, as in training
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    img_dir = args.img_dir or os.path.join(args.data_dir, "images")
    mask_dir = args.mask_dir or os.path.join(args.data_dir, "masks")
    src_cfg = DatasetSourceConfig(kind=args.kind, img_dir=img_dir, mask_dir=mask_dir,
                                  annotation_file=args.annotation_file,
                                  num_samples=args.samples, weight=1.0)
    try:
        source = build_source(src_cfg, args.width, args.height)
    except (FileNotFoundError, NotADirectoryError, OSError, ImportError) as e:
        print(f"ERROR: cannot open dataset: {e}", file=sys.stderr)
        return 1
    if len(source) == 0:
        print(f"ERROR: no samples found under {img_dir!r}", file=sys.stderr)
        return 1
    if args.limit and args.holdout_val_split:
        print("ERROR: --limit and --holdout_val_split carve the dataset differently "
              "from the trainer's split — use one or the other", file=sys.stderr)
        return 1
    if args.limit and args.limit < len(source):
        # evenly strided, reproducible run to run
        source = _Strided(source, np.linspace(0, len(source) - 1, args.limit).astype(int))
    if args.holdout_val_split:
        # the Trainer's seeded split: the file set its in-loop eval saw
        combined = CombinedDataset([source], val_split=args.holdout_val_split,
                                   seed=args.holdout_seed)
        if combined.val_size == 0:
            print("ERROR: holdout split is empty", file=sys.stderr)
            return 1
    else:
        # val_split=1.0: the whole dataset is the (deterministic) eval split
        combined = CombinedDataset([source], val_split=1.0)
    pipeline = InputPipeline(combined, batch_size=args.batch, height=args.height,
                             width=args.width, device=device)

    model = build_model(ModelConfig(name=args.model, num_classes=args.num_classes,
                                    base_filters=args.base_filters))
    weights, quant = load_checkpoint(args.checkpoint, model.state_dict)
    if quant:
        # the eval step binds the fp32 weights only: the score would be theirs,
        # not the int8 artifact's
        print("ERROR: checkpoint carries a calibrated 'quant' collection — evaluate int8 "
              "accuracy with python -m tpuseg_torch.tools.eval_quantized instead",
              file=sys.stderr)
        return 1
    model.load_state_dict(weights, strict=True)
    if not args.checkpoint:
        print("WARNING: no --checkpoint — evaluating a seeded model (smoke test only)",
              file=sys.stderr)
    model = model.to(device, memory_format=torch.channels_last)
    mean = (tuple(float(v) for v in args.normalize_mean.split(","))
            if args.normalize_mean else tuple(IMAGENET_MEAN.tolist()))
    std = (tuple(float(v) for v in args.normalize_std.split(","))
           if args.normalize_std else tuple(IMAGENET_STD.tolist()))
    eval_step = make_eval_step(
        model, args.num_classes, normalize=(mean, std), tta=args.tta,
        ms_scales=tuple(float(s) for s in args.ms_scales.split(",") if s.strip()))
    tot = sum_eval_outputs(eval_step, pipeline.eval_batches(), device)
    if tot is None:
        print("ERROR: empty val split", file=sys.stderr)
        return 1
    cm = tot["confusion"].cpu().numpy()
    n = float(tot["n"])
    iou = iou_from_confusion(cm)
    print(json.dumps({
        "miou": mean_iou(cm),
        "pixel_acc": pixel_accuracy_from_confusion(cm),
        "val_loss": float(tot["loss_sum"]) / max(n, 1.0),
        "iou_per_class": [None if np.isnan(v) else round(float(v), 4) for v in iou],
        "n_images": int(n),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
