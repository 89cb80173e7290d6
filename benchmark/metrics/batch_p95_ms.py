"""The 95th percentile of the latency of every call completed inside the
window (the client's clock from sending a call to holding its results)."""

import numpy as np

UNIT = "ms"
MOVES = "reads_per_s"
SOURCE = "host_clock"


def read(r):
    done = r["done"]
    if not done:
        return None
    return float(np.percentile([1e3 * (c["end"] - c["start"]) for c in done], 95))
