"""Milliseconds the loader's producer thread takes per batch to sample and
gather it into the host buffers: the program's ``data.assemble`` spans in
the traced window (``data/pipeline.py``)."""

from benchmark import program_spans


def read(ctx, out):
    return program_spans.mean_ms(out, "data.assemble", per="data.assemble")
