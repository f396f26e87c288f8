"""The 95th percentile of every request of the window, each timed by the
host's clock from its start, X* on the host, to its mean and variance on
the host (numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    lat = ctx["stats"].get("latency_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
