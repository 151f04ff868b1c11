#
# Loop "open_loop": requests arrive at a fixed rate, drawn from the seed,
# whether or not the last one has been answered, and one caller serves
# them in order of arrival.  The mix gives "rate_per_s"; the gaps between
# arrivals are exponential (Poisson arrivals) from the run's seed.  A
# call's latency runs from its arrival to its answer, so it counts the
# wait in the queue.  The caller starts no call after the first one that
# ends past `seconds`; requests still queued then are neither attempted
# nor answered.  Below the rate the system sustains the tails are the
# metrics to read; above it the queue grows through the window and the
# completed rate is.
#

import time

import numpy as np

from portbench import data
from portbench.loops.closed_loop import call

ARRIVALS_TAG = 6


def arrivals(rate_per_s: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival times (s from the window's start) of the requests due in a
    window of `seconds` and a little past it."""
    rng = np.random.default_rng(data.derive(seed, ARRIVALS_TAG))
    n = int(rate_per_s * seconds * 1.5) + 16
    return np.cumsum(rng.exponential(1.0 / rate_per_s, n))


def run(entry, state, mix, seconds, t0, seed):
    due = arrivals(float(mix["rate_per_s"]), seconds, seed)
    calls = []
    while (not calls or calls[-1]["end"] < seconds) and len(calls) < len(due):
        wait = due[len(calls)] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(wait)
        calls.append(call(entry, state, len(calls), float(due[len(calls)]), t0))
    return calls
