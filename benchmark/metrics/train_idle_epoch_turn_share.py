"""Share of the traced training window in which the card is idle in the
turn between epochs: the device's idle gaps under the program's
``train.epoch_end`` or ``data.stop`` span, or with no ``train.epoch`` span
open on the driving thread (``train/trainer.py``), over the window."""

from benchmark import program_spans


def read(ctx, out):
    return program_spans.idle_share(out, program_spans.epoch_turn)
