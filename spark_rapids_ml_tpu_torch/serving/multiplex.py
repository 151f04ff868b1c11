#
# srml-lanes serving: multiplexed multi-tenant model serving.
#
# Counterpart of spark_rapids_ml_tpu/serving/multiplex.py: the same classes,
# counters (serving.<name>.lanes.*, serving.<name>.tenant.<model_id>.*),
# series (serve.<name>.page_in, serve.<name>.tenant.<model_id>.latency) and
# SRML_SERVE_PAGE_WAIT_S.
#
# A dedicated ModelServer pays one dispatch and one resident parameter
# buffer per model variant.  MultiplexServer stacks K same-shape variants
# onto the pow2 lane axis of ONE parameter buffer per leaf
# (ops/lanes.stack_lanes) and dispatches one lane kernel per micro-batch
# across different tenants' models: each request carries its lane id
# through the MicroBatcher, the kernel scores every row against its own
# lane, and the per-request scatter is the engine's.
#
# Lane paging: variants beyond the resident lane budget live as host numpy
# leaves in `_registered`; a request for a non-resident variant pages it
# into the least-recently-used idle lane with one H2D write per parameter
# leaf (ops/lanes.write_lane), so many registered variants share a few
# resident lanes.  A lane is evicted only when no queued or in-flight
# request rides it (`_lane_pending`).  The JAX page-in replaces the stacked
# tuple immutably; here the write is in place, on the server's copy stream,
# and ops/lanes.py's header says why that is safe: only an idle lane is
# written, the paging request waits for the write's event before it is
# admitted, and each dispatch's stream waits on the newest page-in event
# before it launches.  Pad rows of a batch ride the lane of its last real
# row (the JAX package pads with lane 0), so they read a pinned lane and,
# on the KMeans kernel, add no launch.
#
# Warm set: the entry registers one warm-cache key per bucket
# (ops/precompile.py) and each leaf's page-in write under
# `<entry>.write<i>`, warmed at construction by rewriting lane 0, so a
# page-in adds no steady-state warm-up and assert_steady_state() holds on a
# server that pages.
#
# Exactness contract: the lane kernels (ops/kmeans, ops/glm, ops/logistic,
# ops/linalg) equal the dedicated kernels bit for bit on integer-exact rows
# (the JAX multiplex gate, tests/test_multiplex.py).
#

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from .. import profiling, sanitize
from ..ops import precompile
from ..ops.lanes import lane_bucket, stack_lanes, write_lane
from .batcher import ServerOverloaded
from .engine import ModelServer, _warm_scope
from .entry import HostStaging, ServingEntry, fetch

PAGE_WAIT_ENV = "SRML_SERVE_PAGE_WAIT_S"
_DEFAULT_PAGE_WAIT_S = 5.0


def _page_wait_s() -> float:
    from ..utils import env_float

    return env_float(PAGE_WAIT_ENV, _DEFAULT_PAGE_WAIT_S)


@dataclass
class LaneEntry:
    """One model's multiplexed serving surface — what `_lane_entry` hooks
    return: the host parameter `leaves` (stacked on a new leading lane
    axis), the lane kernel `kernel(X, lanes, *stacked, **statics)` ->
    tensor or tuple of tensors, and the shared `postprocess` that maps their
    host copies (at padded length) to output columns.  `meta` carries
    variant identity that must match for two models to share a kernel and
    postprocess (the logistic class labels); it rides lane_signature next
    to the shape/dtype/out_cols checks.  `device` is where the stacked
    buffers live (the port's addition, as on ServingEntry)."""

    name: str                 # warm-cache namespace, e.g. "lanes.linreg"
    n_cols: int
    dtype: np.dtype
    out_cols: List[str]
    leaves: tuple             # host np parameter leaves (this variant's values)
    kernel: Any               # (X, lanes, *stacked, **statics) -> tensors
    statics: Dict[str, Any] = field(default_factory=dict)
    postprocess: Callable[[List[np.ndarray]], Dict[str, np.ndarray]] = None
    meta: tuple = ()
    info: Dict[str, Any] = field(default_factory=dict)
    device: Optional[torch.device] = None


def lane_signature(entry: "LaneEntry") -> tuple:
    """Everything two variants must agree on to share one lane buffer:
    kernel namespace, client contract (n_cols/dtype/out_cols), parameter
    leaf geometry, statics, and the model-class meta."""
    return (
        entry.name,
        int(entry.n_cols),
        str(np.dtype(entry.dtype)),
        tuple(sorted(entry.out_cols)),
        tuple((tuple(np.asarray(l).shape), str(np.asarray(l).dtype)) for l in entry.leaves),
        tuple(sorted(entry.statics.items())),
        entry.meta,
    )


def lane_entry_for(model: Any, mesh: Any = None) -> LaneEntry:
    """The model's multiplexed serving entry via its `_lane_entry` hook,
    with a uniform error for models that have no lane-batched path."""
    hook = getattr(model, "_lane_entry", None)
    if hook is None:
        raise TypeError(
            f"{type(model).__name__} is not multiplexable (no _lane_entry "
            "hook); serve it on a dedicated ModelServer instead"
        )
    entry = hook(mesh)
    if not isinstance(entry, LaneEntry):
        raise TypeError(
            f"{type(model).__name__}._lane_entry returned "
            f"{type(entry).__name__}, expected LaneEntry"
        )
    return entry


class _LaneStackModel:
    """Internal servable facade: hands ModelServer.__init__ the prebuilt
    multiplex ServingEntry through the standard _serving_entry hook, so
    the base engine (batcher, warm-up, recovery, health) runs unchanged on
    the lane entry."""

    def __init__(self, entry: ServingEntry):
        self._entry = entry

    def _serving_entry(self, mesh: Any = None) -> ServingEntry:
        return self._entry


class MultiplexServer(ModelServer):
    """One lane-batched server for K same-shape model variants.

    `models` is an ordered {model_id: fitted model}; every variant must
    produce an equal lane_signature (same model class, feature width,
    dtype, output columns, parameter geometry).  `resident_lanes` bounds
    the device lane budget: lane_bucket(resident_lanes) lane slots are
    stacked on the device, and variants beyond them page in through the
    LRU.  Clients pass model_id to submit()/predict(); the rest of the
    ModelServer surface (health, stats, drain, shutdown, recovery) is
    inherited."""

    def __init__(
        self,
        name: str,
        models: Dict[str, Any],
        mesh: Any = None,
        *,
        resident_lanes: Optional[int] = None,
        **kwargs: Any,
    ):
        if not models:
            raise ValueError("MultiplexServer requires at least one model")
        entries = {mid: lane_entry_for(m, mesh) for mid, m in models.items()}
        ids = list(entries)
        proto = entries[ids[0]]
        sig0 = lane_signature(proto)
        for mid in ids[1:]:
            if lane_signature(entries[mid]) != sig0:
                raise ValueError(
                    f"multiplex({name!r}): variant {mid!r} is not "
                    f"lane-compatible with {ids[0]!r} (lane_signature "
                    "mismatch); same-shape variants only"
                )
        self._proto = proto
        self._device = torch.device(proto.device if proto.device is not None else _device.resolve())
        # every registered variant's host leaves; .reshape keeps a 0-d leaf
        # (a scalar intercept) 0-d, as its lane slot is
        self._registered: "collections.OrderedDict[str, tuple]" = collections.OrderedDict(
            (mid, tuple(np.ascontiguousarray(np.asarray(l)).reshape(np.shape(l)) for l in e.leaves))
            for mid, e in entries.items()
        )
        want = int(resident_lanes) if resident_lanes else len(ids)
        want = max(1, min(want, len(ids)))
        self._n_lanes = lane_bucket(want)
        # lane state: model_id <-> lane maps, LRU order, per-lane pending
        # request counts (a lane with pending > 0 is never an eviction
        # victim — its queued/in-flight rows were routed against it)
        self._lane_lock = sanitize.lockdep_lock("serve.multiplex.lanes")
        self._lane_free = threading.Condition(self._lane_lock)
        self._lane_of: Dict[str, int] = {}
        self._lru: "collections.OrderedDict[str, int]" = collections.OrderedDict()
        self._lane_pending = [0] * self._n_lanes
        residents = ids[: min(self._n_lanes, len(ids))]
        self._stacked = stack_lanes([self._registered[mid] for mid in residents], self._n_lanes, self._device)
        for i, mid in enumerate(residents):
            self._lane_of[mid] = i
            self._lru[mid] = i
        self._free_lanes = list(range(len(residents), self._n_lanes))
        cuda = self._device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self._device) if cuda else None
        self._page_event: Optional["torch.cuda.Event"] = None  # the newest page-in's
        # warm the page-in writes before traffic by rewriting lane 0 with
        # its own values (idempotent): after this, a page-in into any lane
        # is no new warm-cache key.  _warm_scope keeps it out of concurrent
        # servers' steady-state windows.
        with _warm_scope():
            done = write_lane(
                self._stacked, 0, self._registered[residents[0]], name=proto.name, stream=self._copy_stream
            )
            if cuda:
                # also orders the stacked buffers' uploads before any use
                done.synchronize()
                torch.cuda.synchronize(self._device)
        super().__init__(name, _LaneStackModel(self._build_entry()), mesh, **kwargs)

    # -- the lane-batched ServingEntry ---------------------------------------
    def _build_entry(self) -> ServingEntry:
        proto = self._proto
        np_dtype = np.dtype(proto.dtype)
        n_cols = int(proto.n_cols)
        statics = dict(proto.statics)
        dev = self._device
        staging = HostStaging(dev, np_dtype)
        server = self  # the entry is owned by the server; plain closure is fine

        def call(batch: np.ndarray, lanes: np.ndarray) -> Dict[str, np.ndarray]:
            precompile.dispatch(precompile.warm_key(proto.name, batch.shape[0], np_dtype, dev))
            X = staging.upload(batch)
            lane_ids = torch.from_numpy(np.ascontiguousarray(lanes, dtype=np.int32))
            if server._page_event is not None:
                # rows of this batch ride only lanes whose page-in event
                # completed before admission; the wait keeps the stream's
                # order explicit all the same
                torch.cuda.current_stream(dev).wait_event(server._page_event)
            out = proto.kernel(X, lane_ids, *server._stacked, **statics)
            return proto.postprocess(fetch(list(out) if isinstance(out, (tuple, list)) else [out]))

        def warm(buckets) -> list:
            writes = [
                precompile.warm_key(f"{proto.name}.write{i}", buf.shape[0], buf.dtype, dev)
                for i, buf in enumerate(server._stacked)
            ]
            return [precompile.warm_key(proto.name, b, np_dtype, dev) for b in buckets] + writes

        return ServingEntry(
            name=proto.name,
            n_cols=n_cols,
            dtype=np_dtype,
            out_cols=list(proto.out_cols),
            call=call,
            warm=warm,
            info=dict(proto.info, lanes=self._n_lanes, registered=len(self._registered)),
            device=dev,
        )

    # -- lane paging ----------------------------------------------------------
    def _find_slot_locked(self) -> Optional[int]:
        """A lane to page into: a never-used free slot, else the least-
        recently-used resident whose pending count is zero (evicted).
        Returns None when every lane has in-flight traffic."""
        if self._free_lanes:
            return self._free_lanes.pop()
        for mid, lane in self._lru.items():  # oldest first
            if self._lane_pending[lane] == 0:
                del self._lane_of[mid]
                del self._lru[mid]
                profiling.incr_counter(f"{self.ns}.lanes.evictions")
                return lane
        return None

    def _lane_in(self, model_id: str) -> int:
        """Resolve model_id -> resident lane, paging it in if spilled, and
        pin the lane (pending += 1) until the request's future resolves."""
        with self._lane_lock:
            if model_id not in self._registered:
                known = sorted(self._registered)
                shown = known[:8] + ["..."] if len(known) > 8 else known
                raise KeyError(
                    f"{self.ns}: no registered variant {model_id!r} "
                    f"(registered: {shown})"
                )
            lane = self._lane_of.get(model_id)
            if lane is not None:
                self._lru.move_to_end(model_id)
                self._lane_pending[lane] += 1
                profiling.incr_counter(f"{self.ns}.lanes.hits")
                return lane
            deadline = profiling.now() + _page_wait_s()
            while True:
                lane = self._find_slot_locked()
                if lane is not None:
                    break
                remaining = deadline - profiling.now()
                if remaining <= 0:
                    raise ServerOverloaded(
                        f"{self.ns}: all {self._n_lanes} resident lanes "
                        "have in-flight traffic; retry with backoff "
                        f"(registered variants: {len(self._registered)})"
                    )
                # bounded wait: a lost notify or a wedged dispatch can never
                # park a page-in forever — the deadline above converts it
                # into the typed retryable overload
                self._lane_free.wait(min(remaining, 1.0))
            t0 = profiling.now()
            done = write_lane(
                self._stacked, lane, self._registered[model_id], name=self._proto.name, stream=self._copy_stream
            )
            if done is not None:
                self._page_event = done
            self._lane_of[model_id] = lane
            self._lru[model_id] = lane
            self._lane_pending[lane] += 1
            profiling.incr_counter(f"{self.ns}.lanes.page_in")
        # the wait for the write runs OUTSIDE the critical section: the pin
        # taken above keeps the lane resident, and only this tenant's
        # request waits for its page-in (never the other lanes' traffic)
        if done is not None:
            done.synchronize()
        profiling.record_duration(f"serve.{self.name}.page_in", profiling.now() - t0)
        return lane

    def _lane_release(self, lane: int) -> None:
        with self._lane_lock:
            self._lane_pending[lane] -= 1
            if self._lane_pending[lane] == 0:
                self._lane_free.notify_all()

    # -- client API -----------------------------------------------------------
    def submit(
        self,
        features: np.ndarray,
        timeout_ms: Optional[float] = None,
        *,
        model_id: Optional[str] = None,
    ):
        """Enqueue one request for ONE tenant's model; returns a Future.
        `model_id` is required when more than one variant is registered
        (the single-variant case defaults to it, so a MultiplexServer of
        one model is submit-compatible with a dedicated server)."""
        if model_id is None:
            if len(self._registered) == 1:
                model_id = next(iter(self._registered))
            else:
                raise ValueError(
                    f"{self.ns}: multiplexed submit requires model_id= "
                    f"(one of {len(self._registered)} registered variants)"
                )
        resolved = self._lane_in(model_id)
        t0 = profiling.now()
        try:
            fut = super().submit(features, timeout_ms=timeout_ms, lane=resolved)
        except BaseException:
            self._lane_release(resolved)
            raise
        feats = np.asarray(features)
        n_rows = 1 if feats.ndim == 1 else int(feats.shape[0])
        tns = f"{self.ns}.tenant.{model_id}"
        profiling.incr_counter(f"{tns}.requests")
        profiling.incr_counter(f"{tns}.rows", n_rows)

        def _done(f) -> None:
            # runs on the resolving thread (dispatch scatter / recovery
            # shed): only counters + the pending decrement, never blocking
            self._lane_release(resolved)
            if not f.cancelled() and f.exception() is None:
                profiling.record_duration(
                    f"serve.{self.name}.tenant.{model_id}.latency",
                    profiling.now() - t0,
                )
            else:
                profiling.incr_counter(f"{tns}.errors")

        fut.add_done_callback(_done)
        return fut

    def predict(
        self,
        features: np.ndarray,
        timeout_ms: Optional[float] = None,
        *,
        model_id: Optional[str] = None,
    ) -> Dict[str, np.ndarray]:
        """Blocking convenience around submit(), per tenant."""
        fut = self.submit(features, timeout_ms=timeout_ms, model_id=model_id)
        wait_s = None
        if timeout_ms is not None and timeout_ms > 0:
            wait_s = timeout_ms / 1000.0 + 60.0  # dispatch slack
        return fut.result(timeout=wait_s)

    # -- engine hooks ----------------------------------------------------------
    def _synth_args(self, b: int) -> tuple:
        return (
            np.zeros((b, self._entry.n_cols), dtype=self._entry.dtype),
            np.zeros(b, dtype=np.int32),
        )

    def _assemble(self, batch) -> Tuple[np.ndarray, int, int, np.ndarray]:
        padded, n_rows, b = super()._assemble(batch)
        lanes = np.empty(b, dtype=np.int32)
        off = 0
        for r in batch:
            lanes[off : off + r.n_rows] = r.lane
            off += r.n_rows
        if b > n_rows:
            # pad rows ride the last real row's (pinned) lane; their output
            # is sliced off
            lanes[n_rows:] = lanes[n_rows - 1]
        return padded, n_rows, b, lanes

    # -- observability ---------------------------------------------------------
    def lanes(self) -> Dict[str, Any]:
        """Lane-plane snapshot: budget, residency, paging counters."""
        with self._lane_lock:
            resident = dict(self._lane_of)
            pending = list(self._lane_pending)
        return {
            "n_lanes": self._n_lanes,
            "registered": len(self._registered),
            "resident": len(resident),
            "resident_models": sorted(resident),
            "pending_by_lane": pending,
            "hits": profiling.counter(f"{self.ns}.lanes.hits"),
            "page_in": profiling.counter(f"{self.ns}.lanes.page_in"),
            "evictions": profiling.counter(f"{self.ns}.lanes.evictions"),
            "page_in_latency": profiling.percentiles(f"serve.{self.name}.page_in"),
        }

    def model_ids(self) -> list:
        return sorted(self._registered)

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        out["lanes"] = self.lanes()
        return out
