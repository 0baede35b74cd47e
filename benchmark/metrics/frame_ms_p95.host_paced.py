"""engine frame loop: the 95th percentile of the traced window's frame
latencies after its profiled and sync-counted frames (ms), for a cell
whose end-to-end tail spreads too widely to hold a bound."""

import numpy as np


def read(run):
    if len(run.latencies_ms) < 20:
        return None
    return float(np.percentile(run.latencies_ms, 95))
