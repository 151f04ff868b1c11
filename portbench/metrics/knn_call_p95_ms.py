"""knn_call_p95_ms (ms, host clock): the 95th percentile (nearest rank) of
the latency of every call in the window, from the call to its answer
frame."""

import math


def read(run):
    lat = sorted(c["end"] - c["start"] for c in run.calls)
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
