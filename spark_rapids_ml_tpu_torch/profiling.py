#
# Process-wide named counters.
#
# Counterpart of the counter part of spark_rapids_ml_tpu/profiling.py (this
# package's own copy): the exchange sections (parallel/exchange.py) count
# their calls, bytes and time here, and the exact kNN search the exchange
# route each block took (knn.exchange_route.<route>).  Spans, sessions and
# the export surface of the JAX module are not carried over; the port names
# its host ranges with torch.profiler.record_function instead.
#

from __future__ import annotations

import threading
from typing import Dict

_lock = threading.Lock()
_counters: Dict[str, int] = {}


def incr_counter(name: str, amount: int = 1) -> None:
    """Add `amount` to the process-wide counter `name` (created at 0)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + amount


def counters(prefix: str = "") -> Dict[str, int]:
    """Snapshot of the counters whose names start with `prefix`."""
    with _lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Drop the counters whose names start with `prefix`."""
    with _lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]
