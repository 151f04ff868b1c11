#
# Process-wide named counters and phase timers.
#
# Counterpart of the counter and phase parts of
# spark_rapids_ml_tpu/profiling.py (this package's own copy): the exchange
# sections (parallel/exchange.py) count their calls, bytes and time here,
# and the exact kNN search the exchange route each block took
# (knn.exchange_route.<route>).  phase(name, device) is a
# torch.profiler.record_function range that also adds its wall seconds to
# phase_times(), the card synchronised at its end so the seconds hold the
# device work launched inside it (the CrossValidator's stages).  Spans,
# sessions and the export surface of the JAX module are not carried over.
#

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, Optional

_lock = threading.Lock()
_counters: Dict[str, int] = {}
_phases: Dict[str, float] = {}


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


@contextlib.contextmanager
def phase(name: str, device: Optional[Any] = None) -> Iterator[None]:
    """A record_function range named `name` whose wall seconds, with a CUDA
    `device` synchronised at its end, add to phase_times()[name]."""
    import torch
    from torch.profiler import record_function

    t0 = time.perf_counter()
    with record_function(name):
        yield
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    with _lock:
        _phases[name] = _phases.get(name, 0.0) + seconds


def phase_times() -> Dict[str, float]:
    """Seconds spent in each phase since the last reset_phase_times()."""
    with _lock:
        return dict(_phases)


def reset_phase_times() -> None:
    with _lock:
        _phases.clear()
