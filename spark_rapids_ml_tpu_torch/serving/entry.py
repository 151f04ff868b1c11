#
# The model <-> serving-engine contract.
#
# Counterpart of spark_rapids_ml_tpu/serving/entry.py.  A ServingEntry is
# what a fitted model hands the online inference engine: a `call` that runs
# ONE padded batch end to end (upload -> the model's kernels -> host fetch ->
# output columns), a `warm` that names the warm-cache keys of the buckets the
# engine will dispatch, and the `device` the entry runs on.  Models implement
# `_serving_entry(mesh)` (core._TpuModel hook); most build theirs through
# `kernel_entry`, whose `fn` is a plain function on tensors
# (X, *consts) -> tensors.
#
# The ONE bucketing rule: every flushed micro-batch is zero-padded to
# `bucket_rows(n)`, a power of two between SRML_SERVE_MIN_BUCKET and the
# batcher's max batch, so the steady state meets a handful of geometries,
# all warmed when the model is loaded (ops/precompile.py keeps the registry
# of warmed keys).
#
# Host transfers (kernel_entry on a CUDA device): each padded batch is
# copied into a pinned host buffer kept per bucket and per calling thread,
# uploaded with non_blocking=True, and the outputs come back through fetch:
# pinned copies and one event wait.  Fill, upload and readback happen inside
# one call on one thread, and the readback's event follows the upload on the
# same stream, so a buffer is never refilled while its upload is pending; a
# superseded worker still inside a call keeps its own buffers.
#

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import precompile

MIN_BUCKET_ENV = "SRML_SERVE_MIN_BUCKET"
_DEFAULT_MIN_BUCKET = 16


def min_bucket() -> int:
    """Smallest serving row bucket (bucket_rows' doubling walk rounds a
    setting that is not a power of two up)."""
    return max(1, int(os.environ.get(MIN_BUCKET_ENV, str(_DEFAULT_MIN_BUCKET))))


def bucket_rows(n: int, max_batch: int) -> int:
    """Power-of-two row bucket for a flushed batch of `n` valid rows, shared
    by the dispatch path and the warm path."""
    return precompile.shape_bucket(n, lo=min_bucket(), hi=max(min_bucket(), max_batch))


def serve_buckets(max_batch: int) -> List[int]:
    """Every bucket the engine can dispatch at `max_batch`: min_bucket,
    2 * min_bucket, ..., bucket_rows(max_batch) -- the warm set."""
    out, b = [], min_bucket()
    top = bucket_rows(max_batch, max_batch)
    while b < top:
        out.append(b)
        b *= 2
    out.append(top)
    return out


@dataclass
class ServingEntry:
    """One model's online-inference surface.

    `call` receives the PADDED (bucket, n_cols) batch (pad rows are zeros)
    and returns {output column: host np array of bucket rows}; the engine
    slices to the valid rows and scatters per request.  `warm(buckets)`
    returns the warm-cache keys the entry's dispatches of those buckets
    register (possibly none); the engine warms by dispatching one synthetic
    batch per bucket.  `device` is where the entry runs (None: the host)."""

    name: str                 # warm-cache namespace, e.g. "serve.kmeans"
    n_cols: int
    dtype: np.dtype
    out_cols: List[str]
    call: Callable[[np.ndarray], Dict[str, np.ndarray]]
    warm: Callable[[Sequence[int]], list]
    info: Dict[str, Any] = field(default_factory=dict)
    device: Optional[torch.device] = None


class HostStaging:
    """Pinned host buffers per (calling thread, bucket) for one entry's
    uploads (module header)."""

    def __init__(self, device: torch.device, dtype: np.dtype):
        self.device = torch.device(device)
        self.dtype = np.dtype(dtype)
        self._tls = threading.local()

    def upload(self, batch: np.ndarray) -> torch.Tensor:
        """The batch as a tensor on the entry's device (no copy on the CPU)."""
        host = np.ascontiguousarray(batch, dtype=self.dtype)
        if self.device.type != "cuda":
            return torch.from_numpy(host)
        bufs = getattr(self._tls, "bufs", None)
        if bufs is None:
            bufs = self._tls.bufs = {}
        buf = bufs.get(host.shape[0])
        if buf is None:
            buf = bufs[host.shape[0]] = torch.empty(host.shape, dtype=torch.from_numpy(host).dtype, pin_memory=True)
        buf.numpy()[...] = host
        return buf.to(self.device, non_blocking=True)


def fetch(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of `tensors` (all on one device): pinned non-blocking
    copies and one event wait on a CUDA device, the arrays themselves on the
    CPU."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return [h.numpy() for h in host]


def kernel_entry(
    name: str,
    fn: Callable[..., Any],
    consts: tuple,
    postprocess: Callable[[List[np.ndarray]], Dict[str, np.ndarray]],
    *,
    device: Any,
    dtype: Any,
    n_cols: int,
    out_cols: List[str],
    info: Optional[Dict[str, Any]] = None,
) -> ServingEntry:
    """ServingEntry for the single-function models (kmeans / pca / linreg /
    logreg / forest): `fn(X, *consts)` runs on `device` and returns a tensor
    or a tuple of tensors; `postprocess` maps their host copies (still at
    padded length: the engine slices) to output columns."""
    np_dtype = np.dtype(dtype)
    dev = torch.device(device)
    staging = HostStaging(dev, np_dtype)

    def call(batch: np.ndarray) -> Dict[str, np.ndarray]:
        precompile.dispatch(precompile.warm_key(name, batch.shape[0], np_dtype, dev))
        out = fn(staging.upload(batch), *consts)
        return postprocess(fetch(list(out) if isinstance(out, (tuple, list)) else [out]))

    def warm(buckets: Sequence[int]) -> list:
        return [precompile.warm_key(name, b, np_dtype, dev) for b in buckets]

    return ServingEntry(
        name=name,
        n_cols=int(n_cols),
        dtype=np_dtype,
        out_cols=list(out_cols),
        call=call,
        warm=warm,
        info=dict(info or {}),
        device=dev,
    )


def entry_signature(entry: "ServingEntry") -> tuple:
    """The client-visible serving contract of an entry: feature width,
    dtype, and output columns.  Two models with equal signatures are
    hot-swappable."""
    return (
        int(entry.n_cols),
        str(np.dtype(entry.dtype)),
        tuple(sorted(entry.out_cols)),
    )


def check_swap_compatible(
    old: "ServingEntry", new: "ServingEntry", name: str
) -> None:
    """Raise ValueError naming every signature mismatch (the registry /
    router swap() guard): an incompatible upgrade is registered under a new
    name, not swapped."""
    mismatches = []
    if int(old.n_cols) != int(new.n_cols):
        mismatches.append(f"n_cols {old.n_cols} -> {new.n_cols}")
    if np.dtype(old.dtype) != np.dtype(new.dtype):
        mismatches.append(f"dtype {np.dtype(old.dtype)} -> {np.dtype(new.dtype)}")
    if sorted(old.out_cols) != sorted(new.out_cols):
        mismatches.append(
            f"out_cols {sorted(old.out_cols)} -> {sorted(new.out_cols)}"
        )
    if mismatches:
        raise ValueError(
            f"swap({name!r}): incoming model is not serving-compatible "
            f"({'; '.join(mismatches)}); register it under a new name "
            "instead"
        )


def entry_for(model: Any, mesh: Any = None) -> ServingEntry:
    """The model's serving entry via its `_serving_entry` hook, with a
    uniform error for models that have no online-inference path."""
    hook = getattr(model, "_serving_entry", None)
    if hook is None:
        raise TypeError(
            f"{type(model).__name__} is not a servable model (no "
            "_serving_entry hook)"
        )
    entry = hook(mesh)
    if not isinstance(entry, ServingEntry):
        raise TypeError(
            f"{type(model).__name__}._serving_entry returned "
            f"{type(entry).__name__}, expected ServingEntry"
        )
    return entry
