"""Device milliseconds per train step: CUDA events on the current stream
around each ``Trainer.train_step`` call (the captured K-step graph),
divided by the steps in the call, over the traced window."""


def read(ctx, out):
    marks = out["timing"]["dispatch"]
    steps = sum(k for _, _, k in marks)
    return sum(a.elapsed_time(b) for a, b, _ in marks) / steps if steps else None
