"""Share of the traced training window in which the card is idle while the
Trainer waits for a batch: the device's idle gaps whose innermost program
span on the driving thread is ``data.wait`` (``train/trainer.py``, the
consumer side of ``data/pipeline.py``), over the window."""

from benchmark import program_spans


def read(ctx, out):
    return program_spans.idle_share(out, program_spans.input_wait)
