"""Host milliseconds per served call to copy the frames to the card: the
program's ``serve.upload`` spans over its ``serve.call`` spans in the traced
window (``infer/predictor.py``)."""

from benchmark import program_spans


def read(ctx, out):
    return program_spans.mean_ms(out, "serve.upload", per="serve.call")
