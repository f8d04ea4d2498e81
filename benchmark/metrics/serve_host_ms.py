"""Host milliseconds per served batch outside the device pass
(``infer/predictor.py``: the pageable upload, the fetch, ``finish_host``):
the mean call time on the host clock minus the mean pass time on the
device."""


def read(ctx, out):
    calls, marks = out["timing"]["calls"], out["timing"]["passes"]
    if not calls or not marks:
        return None
    return 1e3 * sum(calls) / len(calls) - sum(a.elapsed_time(b) for a, b in marks) / len(marks)
