"""The whole train step's share of the card's peak: the reference model's
FLOPs per step at the cell's shapes, three forwards for the forward and
the backward (``counts.model_flops``), times the steps of the traced window, over its
seconds and the configuration's peak for each chip."""

from benchmark import counts


def read(ctx, out):
    t = out["shape"]
    steps, window = out["timing"]["steps"], out["window_s"]
    if not steps:
        return None
    flops = counts.model_flops(ctx.config["reference"], t["batch_size"], t["height"],
                               t["width"], train=True, root=ctx.root)
    peak = counts.PEAK_FLOPS[ctx.config["compute_dtype"]] * ctx.chips
    return 100.0 * flops * steps / window / peak
