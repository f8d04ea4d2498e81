"""The whole served pass's share of the card's peak: the reference model's
forward FLOPs at the model input size and batch (``counts.model_flops``),
times the calls of the traced window, over its seconds and the
configuration's peak."""

from benchmark import counts


def read(ctx, out):
    t = ctx.workload["traffic"]
    calls = len(out["timing"]["calls"])
    if not calls:
        return None
    h, w = t["model_hw"]
    flops = counts.model_flops(ctx.config["reference"], t["batch_size"], h, w, train=False,
                               root=ctx.root)
    peak = counts.PEAK_FLOPS[ctx.config["compute_dtype"]] * ctx.chips
    return 100.0 * flops * calls / out["window_s"] / peak
