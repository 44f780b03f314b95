"""The 95th percentile, over every call of the traced window, of the host's
time from a call's hand-over to its results being ready, in ms (a closed
loop: it follows the calls in flight times the time per call)."""

import numpy as np


def read(ctx):
    lat = ctx["latencies"]
    return float(np.percentile(np.asarray(lat, np.float64), 95)) * 1e3 if lat else None
