#
# Replica scheduling policy for the serving router (serving/router.py):
# a copy of spark_rapids_ml_tpu/serving/scheduler.py, which imports no JAX.
# WHICH replica takes a request, and WHETHER the request is admitted at all.
#
# The two policies are deliberately tiny, pure functions over observable
# state — no threads, no locks of their own — so the router's dispatch path
# stays one state snapshot + one comparison pass, and the policy is unit-
# testable without standing up a single replica:
#
#   ADMISSION (priority classes)  Every request carries a priority class
#     ("interactive" > "standard" > "batch").  Admission compares the
#     replica set's aggregate queue-fill fraction against a per-class
#     ceiling (SRML_SERVE_SHED_FRACTIONS, least-critical class first to
#     shed): interactive rides until the queues are hard-full, batch is
#     shed at half-full.  Load shedding therefore degrades the plane in
#     priority order instead of uniformly — the Clipper/Orca-style
#     admission control the ROADMAP's serving item calls for.
#
#   DISPATCH (least-outstanding, health-aware)  Among replicas IN ROTATION
#     (state READY), pick the one with the fewest outstanding requests —
#     the classic least-outstanding-requests balancer, which tracks real
#     per-replica speed differences (a replica slowed by a shared device
#     accumulates backlog and stops being picked).  A replica reporting
#     DEGRADED / RECOVERING / UNHEALTHY / DRAINING is OUT of rotation; when
#     *no* replica is READY the scheduler falls back to DEGRADED replicas
#     (single-replica degraded mode: an SLO-burning replica beats a hard
#     failure) before raising the typed retryable NoReplicaAvailable.
#
from __future__ import annotations

import os
from typing import Any, List, Sequence, Tuple

from .engine import DEGRADED, READY

# priority classes, most- to least-critical; index = shed order
PRIORITY_CLASSES = ("interactive", "standard", "batch")
DEFAULT_CLASS = "interactive"

SHED_FRACTIONS_ENV = "SRML_SERVE_SHED_FRACTIONS"
_DEFAULT_SHED_FRACTIONS = (1.0, 0.75, 0.5)


class NoReplicaAvailable(RuntimeError):
    """Every replica of the requested model is out of rotation (RECOVERING
    / UNHEALTHY / DRAINING, with not even a DEGRADED fallback).  Retryable:
    a supervised restart typically re-admits a replica within its sub-
    second re-warm window — callers retry with backoff rather than failing
    the client request outright."""

    retryable = True


class RequestShed(RuntimeError):
    """Admission control shed this request: the replica set's aggregate
    queue fill exceeded the request's priority-class ceiling.  Retryable
    with backoff — the queues drain at dispatch rate, and higher-priority
    traffic is deliberately still being admitted."""

    retryable = True


def shed_fractions() -> Tuple[float, ...]:
    """Per-class admission ceilings (fraction of aggregate queue depth),
    indexed like PRIORITY_CLASSES.  SRML_SERVE_SHED_FRACTIONS takes a
    comma list ("1.0,0.75,0.5"); short lists repeat their last value, junk
    falls back to the default — admission policy must never raise."""
    raw = os.environ.get(SHED_FRACTIONS_ENV, "")
    if not raw:
        return _DEFAULT_SHED_FRACTIONS
    vals: List[float] = []
    for part in raw.split(","):
        try:
            vals.append(max(0.0, min(1.0, float(part))))
        except ValueError:
            return _DEFAULT_SHED_FRACTIONS
    if not vals:
        return _DEFAULT_SHED_FRACTIONS
    while len(vals) < len(PRIORITY_CLASSES):
        vals.append(vals[-1])
    return tuple(vals[: len(PRIORITY_CLASSES)])


def class_index(priority: str) -> int:
    """Index of `priority` in PRIORITY_CLASSES; unknown classes raise (a
    typo'd class silently riding the batch ceiling would be a policy bug
    that only fires under overload — fail at submit time instead)."""
    try:
        return PRIORITY_CLASSES.index(priority)
    except ValueError:
        raise ValueError(
            f"unknown priority class {priority!r}; choose from "
            f"{PRIORITY_CLASSES}"
        ) from None


def admit(priority: str, fill_fraction: float) -> bool:
    """Admission verdict for one request: classes are admitted while the
    aggregate queue-fill fraction is UNDER their ceiling."""
    return fill_fraction < shed_fractions()[class_index(priority)]


def aggregate_fill(replicas: Sequence[Any]) -> float:
    """Aggregate queue-fill fraction over a replica set: total queued rows
    over total queue depth.  Terminal replicas (UNHEALTHY) still count in
    the denominator — their capacity is provisioned, just dark — so a
    half-dead set reads as fuller, shedding batch traffic earlier."""
    depth = sum(r.queue_depth() for r in replicas)
    if depth <= 0:
        return 1.0
    queued = sum(r.queued_rows() for r in replicas)
    return queued / depth


def aggregate_occupancy(replicas: Sequence[Any]) -> float:
    """Aggregate occupancy over a replica set: admitted-but-unresolved
    requests over total queue depth.  Where aggregate_fill counts only
    rows still WAITING in the queues (it collapses to zero the instant
    dispatch keeps up), occupancy also counts rows in flight on the
    devices, so it stays a truthful busyness signal for a set that is
    saturated but not backlogged — the autoscaler's scale-DOWN guard
    (serving/autoscale.py) and the router.<model>.occupancy gauge.  Can
    exceed 1.0 under deep continuous-batching pipelines; an empty set
    reads 0.0 (nothing is busy, unlike fill's defensive 1.0)."""
    depth = sum(r.queue_depth() for r in replicas)
    if depth <= 0:
        return 0.0
    return sum(r.outstanding() for r in replicas) / depth


def _state_of(r: Any) -> str:
    """A replica's rotation state: effective_state() (the SLO-burn-aware
    verdict) when the object offers it, plain state() otherwise."""
    fn = getattr(r, "effective_state", None)
    return fn() if fn is not None else r.state()


def pick(replicas: Sequence[Any]) -> Tuple[Any, str]:
    """Choose the dispatch target among `replicas` (objects with state()/
    effective_state() and outstanding()): least-outstanding among READY
    replicas, falling back to least-outstanding among DEGRADED ones
    (degraded mode), else raising the typed retryable NoReplicaAvailable.
    Returns (replica, mode) with mode in {"ready", "degraded"} so the
    router can count degraded-mode dispatches."""
    states = [(r, _state_of(r)) for r in replicas]
    ready = [r for r, s in states if s == READY]
    if ready:
        return min(ready, key=lambda r: r.outstanding()), "ready"
    degraded = [r for r, s in states if s == DEGRADED]
    if degraded:
        return min(degraded, key=lambda r: r.outstanding()), "degraded"
    raise NoReplicaAvailable(
        "no replica in rotation: "
        + ", ".join(f"{r.name}={s}" for r, s in states)
    )
