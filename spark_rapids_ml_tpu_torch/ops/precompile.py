#
# The serving plane's per-bucket warm cache.
#
# Counterpart of spark_rapids_ml_tpu/ops/precompile.py, where it is the
# process's ahead-of-time executable cache: a jitted kernel is lowered and
# compiled once per (shape bucket, dtype, mesh, statics) on a thread pool and
# every later dispatch runs the cached executable.  The port has nothing to
# compile per shape.  Its kernels are built once a library, at first use
# (ops/_build.load), and a launch at a new shape costs no build.  What a
# steady serving state must still not do is meet a geometry no warm-up ran
# through: a bucket's first dispatch sizes the caching allocator's blocks,
# pins the host staging buffer and creates a thread's cuBLAS handle.  So
# this module keeps:
#
#   - shape_bucket: the one power-of-two bucketing rule, with the JAX
#     module's results (serving/entry.bucket_rows rides it);
#   - a process-wide registry of warmed keys (entry name, bucket, dtype,
#     device): dispatch(key) counts precompile.compile the first time a key
#     is dispatched, and ops/_build.load counts it at a library's first load;
#   - the counters precompile.compile and precompile.fallback, which the
#     serving engine reads as its watermark (serving/engine.py).  Nothing in
#     the port counts precompile.fallback: it counts an ahead-of-time
#     executable that rejected its inputs, and the port has no such
#     executable; the watermark reads it as the JAX engine does.
#
# The JAX module's Precompiler thread pool, its cached_call / cached_kernel
# dispatch and initialize_persistent_cache (the on-disk XLA cache) have no
# counterpart: there is no per-shape compile to overlap or to persist.
#

from __future__ import annotations

import threading
from typing import Any, Dict, Hashable, Iterable, Tuple

from .. import profiling

_lock = threading.Lock()
_warm: set = set()


def shape_bucket(n: int, lo: int = 64, hi: int = 1 << 30) -> int:
    """Power-of-two bucket for a dynamic row count: lo doubled until it
    reaches min(n, hi)."""
    b = lo
    while b < min(n, hi):
        b *= 2
    return b


def warm_key(name: str, bucket: int, dtype: Any, device: Any) -> Tuple[str, int, str, str]:
    """The registry key of one served geometry."""
    return (str(name), int(bucket), str(dtype), str(device))


def dispatch(key: Hashable) -> bool:
    """Note a dispatch of `key`: True when it was already warm; the first
    dispatch of a key counts precompile.compile and warms it."""
    with _lock:
        if key in _warm:
            return True
        _warm.add(key)
    profiling.incr_counter("precompile.compile")
    return False


def is_warm(key: Hashable) -> bool:
    with _lock:
        return key in _warm


def warmed(keys: Iterable[Hashable]) -> bool:
    """Whether every key of `keys` is in the registry."""
    with _lock:
        return all(k in _warm for k in keys)


def warm_cache_stats() -> Dict[str, int]:
    """{'entries': warmed keys} (the watch gauge precompile.warm.entries)."""
    with _lock:
        return {"entries": len(_warm)}
