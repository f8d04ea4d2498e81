"""Device milliseconds per served batch: CUDA events around each call of
the Predictor's captured ``_device_forward`` (``core/graphs.py``), over the
traced window."""


def read(ctx, out):
    marks = out["timing"]["passes"]
    return sum(a.elapsed_time(b) for a, b in marks) / len(marks) if marks else None
