"""The 95th percentile of every call's latency in the traced window, call
to return on the host clock. One caller in a closed loop keeps the card
saturated, so this tail swings with the host from run to run: a layer's
reading here, and no end-to-end metric."""

import numpy as np


def read(ctx, out):
    calls = out["timing"]["calls"]
    return float(np.percentile(np.asarray(calls) * 1e3, 95)) if calls else None
