"""Per-class pixel statistics and suggested --train.class_weights.

The port's copy of ``tools/class_stats.py``, over the port's
``compute_stats`` and ``suggest_weights`` (``tpuseg_torch/data/
class_stats.py``, the implementation ``--train.class_weights=auto`` uses):

    python -m tpuseg_torch.tools.class_stats --data_dir DIR [--kind bdd100k]
        [--samples N] [--scheme median|inverse] [--num_classes 10]

Prints one JSON line: per-class pixel counts, frequencies, image-presence
counts and suggested weights:

- "median" (default): median-frequency balancing (Eigen & Fergus):
  w_c = median(freq)/freq_c over present classes; absent classes get 0;
- "inverse": plain 1/freq_c normalized to mean 1 over present classes.

Host-side only (numpy over the source's ``load``); no device work. The
printed flag line freezes the weights that ``auto`` would resolve.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tpuseg_torch.data.class_stats import compute_stats, suggest_weights


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", default="")
    p.add_argument("--img_dir", default="")
    p.add_argument("--mask_dir", default="")
    p.add_argument("--annotation_file", default="", help="seame JSONL")
    p.add_argument("--kind", default="bdd100k",
                   choices=["bdd100k", "carla", "seame", "synthetic",
                            "packed"])
    p.add_argument("--packed_dir", default="")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--samples", type=int, default=0,
                   help="cap on images scanned (0 = all)")
    p.add_argument("--scheme", default="median",
                   choices=["median", "inverse"])
    p.add_argument("--car_prob", type=float, default=1.0,
                   help="synthetic only: imbalance rehearsal knob")
    p.add_argument("--car_scale", type=float, default=1.0,
                   help="synthetic only: imbalance rehearsal knob")
    args = p.parse_args(argv)

    from tpuseg_torch.configs import DatasetSourceConfig
    from tpuseg_torch.data.sources import build_source

    img_dir = args.img_dir or (
        os.path.join(args.data_dir, "images") if args.data_dir else ""
    )
    mask_dir = args.mask_dir or (
        os.path.join(args.data_dir, "masks") if args.data_dir else ""
    )
    cfg = DatasetSourceConfig(
        kind=args.kind, img_dir=img_dir, mask_dir=mask_dir,
        annotation_file=args.annotation_file, packed_dir=args.packed_dir,
        num_samples=args.samples or 64, weight=1.0,
        car_prob=args.car_prob, car_scale=args.car_scale,
    )
    try:
        source = build_source(cfg, args.width, args.height)
    except (FileNotFoundError, NotADirectoryError, OSError, KeyError, ImportError) as e:
        print(f"ERROR: cannot open dataset: {e}", file=sys.stderr)
        return 1
    if len(source) == 0:
        print("ERROR: no samples found", file=sys.stderr)
        return 1

    counts, present, read = compute_stats(
        source, args.num_classes, args.samples
    )
    weights = suggest_weights(counts, args.scheme)
    total = int(counts.sum())
    print(json.dumps({
        "images": read,
        "pixel_counts": [int(c) for c in counts],
        "pixel_freq": [round(float(c) / max(total, 1), 6) for c in counts],
        "images_present": [int(c) for c in present],
        "scheme": args.scheme,
        "class_weights": [round(float(w), 4) for w in weights],
        "flag": "--train.class_weights=" + ",".join(
            f"{w:.4f}" for w in weights
        ),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
