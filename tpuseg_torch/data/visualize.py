"""Dataset visualization helpers.

The port of ``tpuseg/data/visualize.py``: the counterparts of the
reference's debug viewers (CarlaDataset's ``visualize_sample``,
SEAMEDataset's keyboard-driven annotation viewer). Works with any of the
port's sources (each yields a uint8 RGB image and a uint8 class mask);
rendering is file-first (a PNG) with an optional cv2.imshow display.
cv2 is imported only inside the code that writes or displays.

    python -m tpuseg_torch.data.visualize --kind synthetic --idx 0 --out sample.png

Interactive: add ``--display`` and step with n/p/q like the reference viewer.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np

from tpuseg_torch.configs import DatasetSourceConfig
from tpuseg_torch.data.class_maps import CLASS_NAMES, COLOR_MAP_RGB
from tpuseg_torch.data.sources import build_source


def blend_sample(
    image_rgb: np.ndarray, mask: np.ndarray, alpha: float = 0.5
) -> np.ndarray:
    """Alpha-blend the colorized mask over the image (the reference's
    visualize_sample semantics, src/CarlaDataset.py:93-103) — RGB in/out."""
    colored = COLOR_MAP_RGB[mask]
    fg = mask > 0
    out = image_rgb.copy()
    out[fg] = (
        image_rgb[fg].astype(np.float32) * (1 - alpha)
        + colored[fg].astype(np.float32) * alpha
    ).astype(np.uint8)
    return out


def class_histogram(mask: np.ndarray) -> str:
    counts = np.bincount(mask.reshape(-1), minlength=len(CLASS_NAMES))
    total = mask.size
    lines = []
    for i, n in enumerate(counts[: len(CLASS_NAMES)]):
        if n:
            lines.append(f"  {i} {CLASS_NAMES[i]:<14} {n:>8} ({100*n/total:.1f}%)")
    return "\n".join(lines)


def visualize_sample(
    source, idx: int, out_path: Optional[str] = None, display: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    sample = source.load(idx)
    if sample is None:
        raise ValueError(f"sample {idx} unreadable")
    image, mask = sample
    blended = blend_sample(image, mask)
    print(f"sample {idx}: image {image.shape}, classes present:")
    print(class_histogram(mask))
    if out_path:
        import cv2

        cv2.imwrite(out_path, blended[..., ::-1])  # RGB -> BGR for imwrite
        print(f"wrote {out_path}")
    if display:
        import cv2

        cv2.imshow("tpuseg_torch sample", blended[..., ::-1])
        return image, mask
    return image, mask


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kind", default="synthetic")
    p.add_argument("--img_dir", default="")
    p.add_argument("--mask_dir", default="")
    p.add_argument("--annotation_file", default="")
    p.add_argument("--num_samples", type=int, default=16)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--idx", type=int, default=0)
    p.add_argument("--out", default="")
    p.add_argument("--display", action="store_true",
                   help="interactive viewer: n=next, p=prev, q=quit "
                        "(the reference viewer's keys, src/SEAMEDataset.py:223-235)")
    args = p.parse_args(argv)

    src = build_source(
        DatasetSourceConfig(
            kind=args.kind,
            img_dir=args.img_dir,
            mask_dir=args.mask_dir,
            annotation_file=args.annotation_file,
            num_samples=args.num_samples,
        ),
        args.width,
        args.height,
    )
    if not args.display:
        visualize_sample(src, args.idx, out_path=args.out or None)
        return 0

    import cv2

    idx = args.idx
    out_path = args.out or None  # honor --out for the first displayed frame
    step = 1
    skipped = 0
    while True:
        try:
            visualize_sample(src, idx, display=True, out_path=out_path)
            out_path = None
            skipped = 0
        except ValueError as e:
            # unreadable sample: skip in the walking direction instead of
            # killing the viewer session (real sources return None for
            # corrupt files; the pipeline skips them too)
            print(f"skipping: {e}")
            skipped += 1
            if skipped >= len(src):
                print("ERROR: no readable samples")
                return 1
            idx = (idx + step) % len(src)
            continue
        key = cv2.waitKey(0) & 0xFF
        if key == ord("q"):
            break
        if key == ord("n"):
            step = 1
            idx = (idx + 1) % len(src)
        elif key == ord("p"):
            step = -1
            idx = (idx - 1) % len(src)
    cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
