#
# Dynamic micro-batcher: the request path of the serving subsystem.
#
# Copy of spark_rapids_ml_tpu/serving/batcher.py, which imports no JAX.
#
# Clients submit single rows or small feature batches from any thread; the
# engine's dispatch worker pops COALESCED batches.  Policy:
#
#   - bounded queue (SRML_SERVE_QUEUE_DEPTH rows): admission control — a
#     submit that would exceed the bound fails fast with ServerOverloaded
#     instead of growing an unbounded-latency backlog.  Overload is the
#     CALLER's signal to shed or retry; the queue never blocks producers.
#   - coalesce-until-deadline: a flush happens when the pending rows fill
#     SRML_SERVE_MAX_BATCH, or when the OLDEST pending request has waited
#     SRML_SERVE_MAX_WAIT_MS (the latency price of batching is bounded by
#     max_wait, paid only under light traffic).  Quiescent partial batches
#     therefore flush at the deadline; drain()/shutdown flush immediately.
#   - per-request deadlines: a request whose timeout expires while queued is
#     failed with RequestTimeout at batch assembly (never dispatched).
#
# Results travel back through concurrent.futures.Future: the worker scatters
# each flushed batch's output columns to its requests' futures, so a blocked
# client wakes exactly when its rows are done, not when the whole queue is.
#

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from concurrent.futures import Future, InvalidStateError

from .. import profiling, sanitize


def resolve_future(fut: "Future", result: Any = None, exc: Any = None) -> bool:
    """set_result/set_exception tolerating a concurrent client-side
    cancel(): checking fut.cancelled() first is a TOCTOU race — the cancel
    can land between the check and the set, and the resulting
    InvalidStateError must never kill the dispatch worker.  Returns whether
    the outcome was delivered."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except InvalidStateError:  # cancelled (or already resolved) under us
        return False

MAX_BATCH_ENV = "SRML_SERVE_MAX_BATCH"
MAX_WAIT_ENV = "SRML_SERVE_MAX_WAIT_MS"
QUEUE_DEPTH_ENV = "SRML_SERVE_QUEUE_DEPTH"
TIMEOUT_ENV = "SRML_SERVE_TIMEOUT_MS"

_DEFAULT_MAX_BATCH = 256
_DEFAULT_MAX_WAIT_MS = 5.0
_DEFAULT_QUEUE_DEPTH = 4096  # rows


# take(cancelled=...) sentinel: a superseded consumer left without
# consuming (distinct from None = stopped-and-drained)
CANCELLED = object()


class ServerDraining(RuntimeError):
    """Raised by submit() once drain()/shutdown() has begun: this server
    generation is completing its admitted work and admitting nothing new.
    Typed (and a RuntimeError subclass, so pre-router callers that matched
    RuntimeError still do) because the router's swap path NEEDS to tell
    "this replica is leaving rotation" from a real failure: a submit that
    races the rolling-swap cut-over onto the outgoing generation must fail
    over to the incoming one, not surface to the client."""

    retryable = True


class ServerOverloaded(RuntimeError):
    """Raised by submit() when the bounded request queue is full — the
    fast-rejection half of admission control (callers shed or retry with
    backoff; queueing would only convert overload into unbounded latency)."""

    retryable = True  # with backoff — the queue drains at dispatch rate


class RequestTimeout(TimeoutError):
    """Set on a request's future when its deadline expires while queued."""

    retryable = True  # the request was never dispatched


class _Request:
    __slots__ = ("features", "n_rows", "future", "enqueue_t", "deadline_t", "lane")

    def __init__(
        self, features: np.ndarray, timeout_s: Optional[float], lane: int = 0
    ):
        self.features = features
        self.n_rows = int(features.shape[0])
        self.future: "Future[Dict[str, np.ndarray]]" = Future()
        self.enqueue_t = profiling.now()
        self.deadline_t = (
            self.enqueue_t + timeout_s if timeout_s and timeout_s > 0 else None
        )
        # srml-lanes: which lane of a multiplexed server's stacked parameter
        # buffer this request's rows score against (0 for dedicated servers
        # — the engine's assembly ignores it unless the entry takes lanes)
        self.lane = int(lane)


from ..utils import env_float as _env_float  # noqa: E402 - knob parsing


class MicroBatcher:
    """Bounded request queue + coalescing policy for ONE served model.

    Thread-safe: any number of producer threads submit; exactly one
    consumer (the engine's dispatch worker) calls take().  `counter_ns` is
    the profiling-counter namespace (e.g. "serving.kmeans")."""

    def __init__(
        self,
        n_cols: int,
        dtype: np.dtype,
        counter_ns: str,
        max_batch: Optional[int] = None,
        max_wait_ms: Optional[float] = None,
        queue_depth: Optional[int] = None,
        default_timeout_ms: Optional[float] = None,
    ):
        self.n_cols = int(n_cols)
        self.dtype = np.dtype(dtype)
        self.ns = counter_ns
        self.max_batch = int(max_batch or _env_float(MAX_BATCH_ENV, _DEFAULT_MAX_BATCH))
        self.max_wait_s = (
            max_wait_ms
            if max_wait_ms is not None
            else _env_float(MAX_WAIT_ENV, _DEFAULT_MAX_WAIT_MS)
        ) / 1000.0
        self.queue_depth = int(
            queue_depth or _env_float(QUEUE_DEPTH_ENV, _DEFAULT_QUEUE_DEPTH)
        )
        if self.max_batch < 1 or self.queue_depth < 1:
            raise ValueError("max_batch and queue_depth must be >= 1")
        self._default_timeout_s = (
            default_timeout_ms
            if default_timeout_ms is not None
            else _env_float(TIMEOUT_ENV, 0.0)
        ) / 1000.0
        self._lock = sanitize.lockdep_lock("serve.batcher.queue")
        self._nonempty = threading.Condition(self._lock)
        self._queue: "collections.deque[_Request]" = collections.deque()
        self._queued_rows = 0
        self._stopped = False
        self._draining = False
        # quiescence accounting lives under its OWN lock: futures resolve
        # from arbitrary threads — including take() failing expired requests
        # while it holds _lock — and a done-callback re-acquiring _lock
        # would self-deadlock
        self._done_lock = sanitize.lockdep_lock("serve.batcher.done")
        self._quiescent = threading.Condition(self._done_lock)
        self._outstanding = 0  # admitted requests whose future is unresolved

    def _on_done(self, _fut) -> None:
        """Future done-callback: quiescence accounting (covers set_result,
        set_exception AND client-side cancellation, so drain can never hang
        on a request that already has an outcome)."""
        with self._done_lock:
            self._outstanding -= 1
            if self._outstanding == 0:
                self._quiescent.notify_all()

    # -- producer side ------------------------------------------------------
    def submit(
        self,
        features: np.ndarray,
        timeout_ms: Optional[float] = None,
        *,
        lane: int = 0,
    ) -> "Future[Dict[str, np.ndarray]]":
        """Enqueue one request ((D,) row or (n, D) block); returns its
        future.  `lane` tags the request's rows with a multiplexed server's
        lane id (srml-lanes; dedicated servers leave the default 0).
        Raises ServerOverloaded when the queue bound would be exceeded and
        ValueError on shape mismatch or oversized requests."""
        feats = np.asarray(features, dtype=self.dtype)
        if feats.ndim == 1:
            feats = feats[None, :]
        if feats.ndim != 2 or feats.shape[1] != self.n_cols:
            raise ValueError(
                f"request features must be ({self.n_cols},) or "
                f"(n, {self.n_cols}); got shape {np.asarray(features).shape}"
            )
        if feats.shape[0] == 0:
            raise ValueError("empty request (0 rows)")
        if feats.shape[0] > self.max_batch:
            raise ValueError(
                f"request of {feats.shape[0]} rows exceeds max_batch="
                f"{self.max_batch}; split it client-side (bulk scoring "
                "belongs on the batch transform path)"
            )
        timeout_s = (
            timeout_ms / 1000.0 if timeout_ms is not None else self._default_timeout_s
        )
        req = _Request(feats, timeout_s, lane)
        with self._lock:
            if self._stopped or self._draining:
                raise ServerDraining(
                    f"server {self.ns!r} is draining/shut down; "
                    "resubmit to its successor"
                )
            if self._queued_rows + req.n_rows > self.queue_depth:
                profiling.incr_counter(f"{self.ns}.rejected")
                raise ServerOverloaded(
                    f"{self.ns}: queue full ({self._queued_rows} rows "
                    f"queued, depth {self.queue_depth}); retry with backoff"
                )
            self._queue.append(req)
            self._queued_rows += req.n_rows
            # inside the admission critical section (nested _done_lock; the
            # done-callback only ever takes _done_lock, so no inversion):
            # incrementing after releasing _lock would let a concurrent
            # drain() see outstanding == 0 while this request sits queued
            with self._done_lock:
                self._outstanding += 1
            profiling.incr_counter(f"{self.ns}.requests")
            profiling.incr_counter(f"{self.ns}.rows", req.n_rows)
            self._nonempty.notify()
        # registered AFTER the increment on this thread: a future that
        # already resolved runs the callback inline, keeping the balance
        req.future.add_done_callback(self._on_done)
        return req.future

    # -- consumer side ------------------------------------------------------
    def take(
        self, cancelled=None, hold=None
    ) -> Optional[Tuple[List[_Request], str]]:
        """Block until a batch is ready under the coalescing policy; returns
        (requests, flush_reason) with at least one live request, or None
        when the batcher is stopped and drained.  Expired requests are
        failed here and never returned.

        `cancelled` (optional zero-arg predicate) is the SUPERSEDED-
        CONSUMER exit: a depth>1 assembly thread parks INSIDE take(), so
        when a recovery hands the batcher to a new worker generation the
        stale consumer must leave WITHOUT consuming a request the new
        generation owns.  When the predicate turns true, take() returns
        the CANCELLED sentinel at the next wait re-check, having popped
        nothing.

        `hold` (optional zero-arg predicate) is ITERATION-LEVEL continuous
        batching: while it returns True (the depth>1 staging slot is still
        occupied, i.e. the device has not consumed the previously staged
        batch), a deadline-expired partial batch stays OPEN to late
        arrivals instead of flushing — closing it early cannot make it
        dispatch sooner (a staged batch is already ahead of it) but would
        freeze its occupancy below max_batch.  Full/drain/stop flushes
        ignore `hold`; the consumer wakes promptly via kick() when the
        slot frees."""
        with self._lock:
            while True:
                while not self._queue and not self._stopped:
                    # bounded wait (graftlint R9): re-checking the predicate
                    # once a second costs nothing and means a lost notify —
                    # or a recovery path that swapped consumers — can never
                    # park this worker forever
                    if cancelled is not None and cancelled():
                        return CANCELLED
                    self._nonempty.wait(timeout=1.0)
                if cancelled is not None and cancelled():
                    return CANCELLED  # queued work belongs to the successor
                if not self._queue:
                    return None  # stopped and drained
                # coalesce-until-deadline, anchored at the OLDEST request:
                # its wait bounds the batching latency everyone else rides
                deadline = self._queue[0].enqueue_t + self.max_wait_s
                while True:
                    rows = sum(r.n_rows for r in self._queue)
                    if rows >= self.max_batch or self._draining or self._stopped:
                        reason = "full" if rows >= self.max_batch else "drain"
                        break
                    remaining = deadline - profiling.now()
                    if remaining <= 0:
                        if hold is None or not hold():
                            reason = "deadline"
                            break
                        # past the deadline but held: the staging slot is
                        # occupied, so keep coalescing — kick() (or the next
                        # submit) wakes this wait the moment that changes
                        profiling.incr_counter(f"{self.ns}.held_open")
                        remaining = 1.0
                    # bounded like the outer wait, so a consumer superseded
                    # mid-coalesce notices within a second even when no
                    # producer ever notifies again
                    self._nonempty.wait(min(remaining, 1.0))
                    if cancelled is not None and cancelled():
                        return CANCELLED
                    if not self._queue:
                        break  # everything expired/cancelled under us
                if not self._queue:
                    continue
                batch: List[_Request] = []
                taken_rows = 0
                now = profiling.now()
                while self._queue:
                    req = self._queue[0]
                    if req.deadline_t is not None and now > req.deadline_t:
                        self._queue.popleft()
                        self._queued_rows -= req.n_rows
                        profiling.incr_counter(f"{self.ns}.timeouts")
                        resolve_future(
                            req.future,
                            exc=RequestTimeout(
                                f"{self.ns}: request expired after "
                                f"{(now - req.enqueue_t) * 1e3:.1f} ms in queue"
                            ),
                        )
                        continue
                    if taken_rows + req.n_rows > self.max_batch:
                        break  # next request starts the following batch
                    self._queue.popleft()
                    self._queued_rows -= req.n_rows
                    taken_rows += req.n_rows
                    batch.append(req)
                if not batch:
                    continue  # all expired — wait for fresh traffic
                profiling.incr_counter(f"{self.ns}.batches")
                profiling.incr_counter(f"{self.ns}.flush_{reason}")
                if len(batch) > 1:
                    profiling.incr_counter(f"{self.ns}.coalesced_batches")
                return batch, reason

    def kick(self) -> None:
        """Wake a take() parked under `hold`: the depth>1 dispatcher calls
        this right after popping the staged batch, so a deadline-expired
        held batch flushes within one lock handoff of the slot freeing
        instead of one bounded-wait interval later."""
        with self._lock:
            self._nonempty.notify_all()

    # -- lifecycle ----------------------------------------------------------
    def queued_rows(self) -> int:
        with self._lock:
            return self._queued_rows

    def queued_requests(self) -> int:
        with self._lock:
            return len(self._queue)

    def outstanding(self) -> int:
        """Admitted requests whose future has not resolved yet (queued OR
        inside the in-flight dispatch)."""
        with self._done_lock:
            return self._outstanding

    def wait_quiescent(self, timeout_s: Optional[float] = None) -> bool:
        """Block until every admitted request has an outcome; True on
        quiescence, False on timeout."""
        deadline = (
            profiling.now() + timeout_s if timeout_s is not None else None
        )
        with self._done_lock:
            while self._outstanding > 0:
                remaining = None
                if deadline is not None:
                    remaining = deadline - profiling.now()
                    if remaining <= 0:
                        return False
                self._quiescent.wait(remaining)
            return True

    def fail_pending(self, exc: Exception) -> int:
        """Pop EVERY queued request and resolve its future with `exc` — the
        srml-shield recovery shed: queued work gets a typed retryable error
        the moment the supervisor restarts the worker, instead of waiting
        out a dead consumer.  Admission stays open (the recovered worker
        serves new traffic); returns the number of requests failed."""
        with self._lock:
            popped = list(self._queue)
            self._queue.clear()
            self._queued_rows = 0
        n = 0
        for req in popped:
            if resolve_future(req.future, exc=exc):
                n += 1
        return n

    def begin_drain(self) -> None:
        """Stop admitting; pending batches flush immediately (the worker's
        take() stops waiting for deadlines)."""
        with self._lock:
            self._draining = True
            self._nonempty.notify_all()

    def stop(self) -> None:
        """Stop admitting AND wake the consumer for exit; queued requests
        still flush (take() returns them until the queue is empty)."""
        with self._lock:
            self._stopped = True
            self._nonempty.notify_all()
