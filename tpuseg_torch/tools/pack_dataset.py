"""Pack any configured source into the memory-mapped training format.

The port's copy of ``tools/pack_dataset.py``, with the same flags and the
same files, over the port's own sources (so a host without JAX packs, and
a host without cv2 packs ``--kind synthetic``). It runs the host decode
path (decode + LUT remap + resize) once, offline, and writes:

    <out>/images.npy   uint8 [N, H, W, 3] RGB
    <out>/masks.npy    uint8 [N, H, W]
    <out>/meta.json    {"width", "height", "count", "kind"}

Train from it with ``--data.sources='[{"kind":"packed","packed_dir":"<out>",
"weight":1.0}]'``: ``PackedSource`` memmaps the arrays, and the input
pipeline gathers each batch in one native call. Unreadable samples are
skipped (logged) and the skipped tail trimmed from the arrays.

    python -m tpuseg_torch.tools.pack_dataset --kind bdd100k --img_dir ... \\
        --mask_dir ... --out DIR --width 256 --height 128
    python -m tpuseg_torch.tools.pack_dataset --kind synthetic --num_samples 512 --out DIR
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
from numpy.lib.format import open_memmap


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--kind", required=True,
                   choices=["bdd100k", "carla", "seame", "synthetic"])
    p.add_argument("--img_dir", default="")
    p.add_argument("--mask_dir", default="")
    p.add_argument("--annotation_file", default="")
    p.add_argument("--num_samples", type=int, default=64)
    p.add_argument("--out", required=True)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=128)
    args = p.parse_args(argv)

    from tpuseg_torch.configs import DatasetSourceConfig
    from tpuseg_torch.data.sources import build_source

    src = build_source(
        DatasetSourceConfig(
            kind=args.kind, img_dir=args.img_dir, mask_dir=args.mask_dir,
            annotation_file=args.annotation_file,
            num_samples=args.num_samples,
        ),
        args.width, args.height,
    )
    n = len(src)
    if n == 0:
        print("source is empty — nothing to pack", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    # open_memmap streams samples straight to disk: packing never needs the
    # whole dataset in RAM
    images = open_memmap(
        os.path.join(args.out, "images.npy"), mode="w+", dtype=np.uint8,
        shape=(n, args.height, args.width, 3),
    )
    masks = open_memmap(
        os.path.join(args.out, "masks.npy"), mode="w+", dtype=np.uint8,
        shape=(n, args.height, args.width),
    )
    kept = 0
    for i in range(n):
        sample = src.load(i)
        if sample is None:  # unreadable: skip
            print(f"skipping unreadable sample {i}", file=sys.stderr)
            continue
        images[kept], masks[kept] = sample
        kept += 1
        if kept % 500 == 0:
            print(f"packed {kept}/{n}", flush=True)
    images.flush()
    masks.flush()
    if kept < n:  # truncate the skipped tail by rewriting the headers
        del images, masks
        for name, shape in (
            ("images.npy", (kept, args.height, args.width, 3)),
            ("masks.npy", (kept, args.height, args.width)),
        ):
            path = os.path.join(args.out, name)
            full = np.load(path, mmap_mode="r")
            trimmed = open_memmap(
                path + ".tmp", mode="w+", dtype=np.uint8, shape=shape
            )
            trimmed[:] = full[:kept]
            trimmed.flush()
            del full, trimmed
            os.replace(path + ".tmp", path)
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump({
            "width": args.width, "height": args.height,
            "count": kept, "kind": args.kind,
        }, f)
    print(json.dumps({"packed": kept, "skipped": n - kept, "out": args.out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
