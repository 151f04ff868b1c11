#
# Loop "closed_loop": one caller, closed loop.  Call i starts when call
# i - 1 has answered; the window closes with the first call that ends past
# `seconds`.  Each call is timed from its start to its answer on the host's
# clock and wrapped in the trace's call range; a call that raises is
# counted failed and the loop goes on.  Every call the window started is
# attempted.
#
# A loop's run(entry, state, mix, seconds, t0, seed) owns the window and
# returns one record a call: "start" (when the call was due) and
# "end" (when it answered) in seconds from t0, "ok", and what the entry's
# call recorded ("rows", "fits", ...; "rows" 0 where the call failed).
# call() below makes and records one call; when to make it is the loop's.
#

import sys
import time
import traceback

from torch.profiler import record_function

from portbench import trace


def call(entry, state, i, due, t0):
    """Call i of the window, due at `due` (seconds from t0): its record."""
    try:
        with record_function(trace.CALL_RANGE):
            rec, out = entry.call(state, i)
        end = time.perf_counter() - t0
        entry.keep(state, i, out)
        return {"start": due, "end": end, "ok": True, **rec}
    except Exception:
        traceback.print_exc(file=sys.stderr)
        return {"start": due, "end": time.perf_counter() - t0, "ok": False, "rows": 0}


def run(entry, state, mix, seconds, t0, seed):
    calls = []
    while not calls or calls[-1]["end"] < seconds:
        calls.append(call(entry, state, len(calls), time.perf_counter() - t0, t0))
    return calls
