"""Host milliseconds per served call to wait for the pass and copy the class
maps to the host: the program's ``serve.fetch`` spans over its
``serve.call`` spans in the traced window (``infer/predictor.py``)."""

from benchmark import program_spans


def read(ctx, out):
    return program_spans.mean_ms(out, "serve.fetch", per="serve.call")
