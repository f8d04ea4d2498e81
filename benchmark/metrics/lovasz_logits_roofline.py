"""The fused Lovász region's share of its roofline (``ops/lovasz.py``,
``csrc/lovasz_logits.cu``): its least time over the traced window's steps
(``counts.lovasz_region`` at the cell's batch, size and classes) over the
device time of its kernels in the profile, found by the names in
``lovasz_logits_roofline.json``. Nothing when no such kernel ran."""

import json
import os

from benchmark import counts


def read(ctx, out):
    with open(os.path.splitext(__file__)[0] + ".json") as f:
        names = json.load(f)["kernels"]
    reading = out.get("trace")
    if reading is None:
        return None
    seconds = reading.device_seconds(lambda n: any(k in n for k in names))
    steps = out["timing"]["steps"]
    if seconds <= 0 or not steps:
        return None
    t = out["shape"]
    bound = counts.lovasz_region(t["batch_size"] * t["height"] * t["width"],
                                 ctx.config["reference"]["num_classes"])["bound_s"]
    return 100.0 * bound * steps / seconds
