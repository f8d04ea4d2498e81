"""Host milliseconds blocked on the card per dispatch to read the lagged
losses: the program's ``train.loss_read`` spans over its ``train.dispatch``
spans in the traced window (``train/trainer.py``)."""

from benchmark import program_spans


def read(ctx, out):
    return program_spans.mean_ms(out, "train.loss_read", per="train.dispatch")
