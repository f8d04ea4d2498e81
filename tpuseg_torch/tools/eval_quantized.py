"""Quantization accuracy harness of the PyTorch port: fp32 vs BN-folded vs int8 vs fp16 mIoU.

The port of ``tools/eval_quantized.py``, with its flags, its five
variants, its JSON and its verdict (every variant within 1 mIoU point of
fp32: rc 0, else rc 1):

    python -m tpuseg_torch.tools.eval_quantized [--platform cpu] \\
        [--checkpoint ckpt_dir_or_pth] [--samples 64] \\
        [--data_dir /data/bdd100k [--kind bdd100k|carla|seame]]

- ``fp32``: the weights as they are (a checkpoint's int8 ``quant`` is
  never bound to the baseline);
- ``bn_folded``: ``export/quantize.py::fold_batchnorm``;
- ``int8_weights``: dequantize(quantize_int8(weights));
- ``fp16_weights``: the parameters rounded to fp16 and widened back;
- ``int8_full``: activations calibrated on two batches (seeded synthetic
  scenes, seed 77, or evenly strided images of ``--data_dir``), every conv
  in int8 (``export/int8_full.py``).

With no checkpoint it scores a seeded model on synthetic scenes (seed 123):
the deltas between variants still mean something (same inputs, the same
weights up to quantization). The directory kinds decode with cv2. It runs
on the CUDA card unless ``--platform=cpu`` is given (TF32 off there).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default="")
    p.add_argument("--model", default="mobilenetv2_unet")
    p.add_argument("--base_filters", type=int, default=0,
                   help="family width knob (0 = registry default)")
    p.add_argument("--data_dir", default="",
                   help="real dataset root with images/ + masks/ (bdd100k layout) — eval "
                        "AND int8 calibration both read real images (default: synthetic "
                        "scenes)")
    p.add_argument("--img_dir", default="")
    p.add_argument("--mask_dir", default="")
    p.add_argument("--annotation_file", default="", help="seame JSONL")
    p.add_argument("--kind", default="bdd100k", choices=["bdd100k", "carla", "seame"],
                   help="loader for --data_dir/--img_dir")
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--platform", default="")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from tpuseg_torch.configs import DatasetSourceConfig, ModelConfig
    from tpuseg_torch.core.dtypes import resolve_device
    from tpuseg_torch.data.augment import normalize_images
    from tpuseg_torch.data.sources import SyntheticSource, build_source
    from tpuseg_torch.export.int8_full import bind_quant, calibrate
    from tpuseg_torch.export.quantize import (cast_params, dequantize_int8, fold_batchnorm,
                                              quantize_int8)
    from tpuseg_torch.infer.predictor import load_checkpoint
    from tpuseg_torch.main import device_for_platform
    from tpuseg_torch.models.registry import build_model
    from tpuseg_torch.train.metrics import confusion_matrix, mean_iou

    device = resolve_device(device_for_platform(args.platform or None))
    if device.type == "cuda":      # fp32 is fp32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    # apply-time rewrites off, so that calibration sees every conv input
    model = build_model(ModelConfig(name=args.model, base_filters=args.base_filters,
                                    up_subpixel=False))
    # a calibrated int8 checkpoint's quant is never bound to the fp32
    # baseline (every delta would compare int8 against int8)
    base, _ = load_checkpoint(args.checkpoint, model.state_dict)
    base = {k: v.to(torch.float32) if v.is_floating_point() else v for k, v in base.items()}
    variants = {
        "fp32": base,
        "bn_folded": fold_batchnorm(base),
        "int8_weights": dequantize_int8(quantize_int8(base)),
        "fp16_weights": {k: v.to(torch.float32) for k, v in
                         cast_params(base, torch.float16).items()},
    }

    # eval + calibration source: the real files when given (activation
    # ranges calibrated on real images), else the synthetic scenes
    real_src = None
    if args.data_dir or args.img_dir:
        src_cfg = DatasetSourceConfig(
            kind=args.kind,
            img_dir=args.img_dir or os.path.join(args.data_dir, "images"),
            mask_dir=args.mask_dir or os.path.join(args.data_dir, "masks"),
            annotation_file=args.annotation_file, weight=1.0)
        try:
            real_src = build_source(src_cfg, args.width, args.height)
        except (FileNotFoundError, NotADirectoryError, OSError, ImportError) as e:
            print(f"ERROR: cannot open dataset: {e}", file=sys.stderr)
            return 1
        if len(real_src) == 0:
            print("ERROR: no samples found", file=sys.stderr)
            return 1
        args.samples = min(args.samples, len(real_src))

    if real_src is None:
        calib_src = SyntheticSource(args.batch * 2, args.width, args.height, seed=77)
        calib_imgs = [calib_src.load(i)[0] for i in range(args.batch * 2)]
    else:
        # evenly strided real images (they may overlap eval: calibration
        # reads activation ranges, not labels); unreadable files skipped,
        # the readable ones repeated to fill
        calib_idx = np.linspace(0, len(real_src) - 1, args.batch * 2).astype(int)
        calib_imgs = [pr[0] for pr in (real_src.load(int(i)) for i in calib_idx)
                      if pr is not None]
        if not calib_imgs:
            print("ERROR: no readable calibration images", file=sys.stderr)
            return 1
        n_readable = len(calib_imgs)
        while len(calib_imgs) < args.batch * 2:
            calib_imgs.append(calib_imgs[len(calib_imgs) % n_readable])
    model.to(device, memory_format=torch.channels_last)
    calib = [normalize_images(torch.from_numpy(np.stack(calib_imgs[b:b + args.batch]))
                              .to(device)) for b in (0, args.batch)]
    quant = calibrate(model, base, calib)
    variants["int8_full"] = base
    variants = {k: {n: t.to(device) for n, t in v.items()} for k, v in variants.items()}

    def predict(name: str, x: torch.Tensor) -> torch.Tensor:
        model.load_state_dict(variants[name])
        bind_quant(model, quant if name == "int8_full" else None)
        with torch.no_grad():
            return model.eval()(x.permute(0, 3, 1, 2)).argmax(dim=1)

    src = real_src if real_src is not None else SyntheticSource(
        args.samples, args.width, args.height, seed=123)
    cms = {k: np.zeros((10, 10), np.int64) for k in variants}
    agree = {k: [0, 0] for k in variants}
    for start in range(0, args.samples, args.batch):
        pairs = [src.load(i) for i in range(start, min(start + args.batch, args.samples))]
        pairs = [pr for pr in pairs if pr is not None]     # skip unreadable
        if not pairs:
            continue
        imgs, masks = zip(*pairs)
        x = normalize_images(torch.from_numpy(np.stack(imgs)).to(device))
        y = torch.from_numpy(np.stack(masks).astype(np.int64)).to(device)
        ref_pred = None
        for name in variants:
            pred = predict(name, x)
            cms[name] += confusion_matrix(pred, y, 10).cpu().numpy().astype(np.int64)
            if name == "fp32":
                ref_pred = pred
            else:
                agree[name][0] += int((pred == ref_pred).sum())
                agree[name][1] += int(pred.numel())

    fp32_miou = mean_iou(cms["fp32"])
    results = {}
    for name in variants:
        miou = mean_iou(cms[name])
        results[name] = {
            "miou": round(miou, 5),
            "delta_miou_pts": round((miou - fp32_miou) * 100, 4),
            "mask_agreement": (round(agree[name][0] / agree[name][1], 6)
                               if agree[name][1] else 1.0),
        }
    print(json.dumps(results, indent=2))
    worst = min(r["delta_miou_pts"] for r in results.values())
    ok = worst >= -1.0
    print(f"acceptance (all variants within 1 mIoU point): {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
