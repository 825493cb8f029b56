"""ms: the 90th percentile (numpy's linear interpolation) of the latency
of every video of the window, from the call with the photograph on the
host to its frames on the host. A failed video counts as a miss, an
infinite latency: where the percentile reaches one, it is infinite and
the line leaves the metric out."""

import math

import numpy as np


def value(record):
    lat = sorted(v["latency_s"] if v["ok"] else math.inf
                 for v in record["window"]["videos"])
    if not lat:
        return None
    if not math.isfinite(lat[math.ceil(0.9 * (len(lat) - 1))]):
        return math.inf
    return float(np.percentile(lat, 90)) * 1e3
