"""Share of the traced training window in which no kernel, copy or set ran
on the card (the profile's timeline)."""


def read(ctx, out):
    reading = out.get("trace")
    if reading is None or reading.busy_s <= 0:
        return None
    return 100.0 * (1.0 - reading.busy_s / reading.window_s)
