"""Render synthetic road scenes to an on-disk dataset in a real source layout.

The port's copy of ``tools/export_synthetic_dataset.py``, with its flags:

    python -m tpuseg_torch.tools.export_synthetic_dataset --out synth_val \\
        --num 256 --seed 7 --width 256 --height 128
    python -m tpuseg_torch.tools.eval_miou --data_dir synth_val --checkpoint ...

It writes the port's ``SyntheticSource`` scenes through the inverse of the
source's class map (``--kind bdd100k|carla``): ``images/`` (PNG, or JPEG
with ``--jpeg``), ``masks/`` (PNG source ids) and ``meta.json``, so the
directory exercises the real file path (decode, LUT remap, resize). The
files are the JAX tool's, byte for byte, at the same flags. ``--seed``
picks a sample universe apart from a training run's (seed 0), so the set
is held out. It encodes with cv2 and raises where cv2 does not import (the
card's host: ROADMAP.md A9).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from tpuseg_torch.data.class_maps import (BDD100K_CLASS_MAP, CARLA_CLASS_MAP, NUM_CLASSES,
                                          build_lut)

CV2_HINT = (" (ROADMAP.md A9: the port writes and decodes image files with cv2 only); "
            "run this tool where cv2 is installed")


def inverse_lut(class_map: dict) -> np.ndarray:
    """ours -> a source id that maps back; unmapped classes -> an id the
    forward LUT sends to 0 (background)."""
    fwd = build_lut(class_map)
    # 255 is outside every reference map -> remaps to background
    inv = np.full(NUM_CLASSES, 255, dtype=np.uint8)
    for src_id, ours in sorted(class_map.items(), reverse=True):
        # reverse-sorted so the smallest source id wins for each class,
        # deterministically (e.g. road: bdd 0, carla 1)
        inv[ours] = src_id
    assert (fwd[inv[1:]] == np.arange(1, NUM_CLASSES)).all()
    return inv


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--kind", default="bdd100k", choices=["bdd100k", "carla"])
    p.add_argument("--num", type=int, default=64)
    p.add_argument("--seed", type=int, default=7,
                   help="sample universe; != a train run's seed (0) => held out")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--jpeg", action="store_true",
                   help="write .jpg images (lossy) instead of .png")
    p.add_argument("--car_prob", type=float, default=1.0,
                   help="imbalanced-arm rehearsal: probability a scene draws cars "
                        "(protocol: 0.12)")
    p.add_argument("--car_scale", type=float, default=1.0,
                   help="imbalanced-arm car size multiplier (protocol: 0.45; with "
                        "car_prob 0.12 the car class is 0.067%% of pixels)")
    args = p.parse_args(argv)

    from tpuseg_torch.data.sources import SyntheticSource
    from tpuseg_torch.infer.postprocess import require_cv2

    cv2 = require_cv2("export_synthetic_dataset", CV2_HINT)
    class_map = BDD100K_CLASS_MAP if args.kind == "bdd100k" else CARLA_CLASS_MAP
    inv = inverse_lut(class_map)
    src = SyntheticSource(args.num, args.width, args.height, seed=args.seed,
                          car_prob=args.car_prob, car_scale=args.car_scale)

    img_dir = os.path.join(args.out, "images")
    mask_dir = os.path.join(args.out, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    ext = ".jpg" if args.jpeg else ".png"
    for i in range(args.num):
        image, mask = src.load(i)  # RGB uint8, ours-ids uint8
        if mask.max() >= len(inv):
            raise ValueError(f"sample {i}: mask id {mask.max()} out of scheme")
        ok = cv2.imwrite(os.path.join(img_dir, f"{i:05d}{ext}"), image[..., ::-1]) \
            and cv2.imwrite(os.path.join(mask_dir, f"{i:05d}.png"), inv[mask])
        if not ok:
            print(f"ERROR: imwrite failed for sample {i}", file=sys.stderr)
            return 1
    meta = {
        "kind": args.kind, "count": args.num, "seed": args.seed,
        "width": args.width, "height": args.height,
        "car_prob": args.car_prob, "car_scale": args.car_scale,
        "classes_present": sorted(int(c) for c in np.unique(src.load(0)[1])),
    }
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(json.dumps({"out": args.out, **meta}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
