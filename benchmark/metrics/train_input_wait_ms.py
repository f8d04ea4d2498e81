"""Mean host wait for a batch, per step: the host clock around each
``next()`` of ``InputPipeline.train_batches`` as the Trainer consumes it
(``data/pipeline.py``), over the traced window."""


def read(ctx, out):
    waits = out["timing"]["waits"]
    return 1e3 * sum(waits) / len(waits) if waits else None
