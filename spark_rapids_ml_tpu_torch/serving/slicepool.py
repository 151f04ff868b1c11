#
# srml-elastic slice pool: the capacity ledger under the replica plane.
#
# Counterpart of spark_rapids_ml_tpu/serving/slicepool.py.  ONE ledger of
# fixed-size, disjoint, group-aware device slices
# (parallel/mesh.carve_device_slices) from which the router's replicas of
# ALL served models allocate and release.  No slice is ever handed to two
# owners; when nothing is free the pool raises the typed CapacityExhausted
# instead of quietly doubling up, and oversubscription (single-device
# shared leases) happens only under an explicit policy flag.  The device
# list defaults to the port's device.devices(): on a host with one card the
# pool holds one single-device slice of cuda:0, and N replicas of a model
# run on N shared leases of it (Router.serve(..., allow_oversubscribe=True)).
#
# The pool is deliberately dumb: no waiting, no priorities, no preemption
# of leases.  Deciding WHEN to take or give back a slice is the
# autoscaler's job (serving/autoscale.py); deciding WHO runs on a slice is
# the router's.
#

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .. import device as _device
from .. import profiling, sanitize
from ..parallel.mesh import Mesh, carve_device_slices

SLICE_DEVICES_ENV = "SRML_POOL_SLICE_DEVICES"


class CapacityExhausted(ValueError):
    """The pool has no free slice for this allocation.  A ValueError
    because asking for more disjoint slices than the hardware holds is a
    deployment-spec error — but retryable, because capacity is dynamic:
    a scale-down or an unroute elsewhere frees a slice.  Callers that can
    wait (the autoscaler's scale-up path) treat it as "hold and re-try
    next tick"; callers that cannot (Router.serve at deploy time) surface
    it with the allow_oversubscribe escape hatch named."""

    retryable = True


class SliceLease:
    """One granted slice: the mesh to build a replica on, plus the ledger
    bookkeeping to give it back.  Release through SlicePool.release (or
    lease.release()) — idempotent, so teardown paths may race."""

    __slots__ = ("pool", "index", "devices", "mesh", "owner", "shared",
                 "released")

    def __init__(self, pool, index, devices, mesh, owner, shared):
        self.pool = pool
        self.index = index  # ledger slot; -1 for oversubscribed leases
        self.devices = tuple(devices)
        self.mesh = mesh
        self.owner = owner
        self.shared = shared  # True: single-device oversubscription lease
        self.released = False

    def release(self) -> None:
        self.pool.release(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        kind = "shared" if self.shared else f"slice {self.index}"
        return (
            f"<SliceLease {kind} owner={self.owner!r} "
            f"devices={[getattr(d, 'id', d) for d in self.devices]} "
            f"released={self.released}>"
        )


def _default_slice_devices(n_devices: int) -> int:
    """Default carve granularity: a quarter of the fleet per slice (at
    least one device) — four-way scale headroom out of the box, which is
    what makes `Autoscaler` useful on a pool nobody tuned.  Override with
    SRML_POOL_SLICE_DEVICES or the ctor knob."""
    from ..utils import env_float

    configured = int(env_float(SLICE_DEVICES_ENV, 0))
    if configured >= 1:
        return configured
    return max(1, n_devices // 4)


class SlicePool:
    """Fixed-granularity allocator of disjoint, group-aware device slices.

    `allocate(owner)` grants a free slice as a SliceLease (its `.mesh` is
    a 1-D data mesh over the slice, ready for ModelServer); `release`
    returns it.  With every slice taken, allocate raises the typed
    CapacityExhausted — unless oversubscription is explicitly allowed
    (pool-wide `allow_oversubscribe=True` or per-call), in which case the
    overflow lease is a SINGLE device picked round-robin (marked
    `.shared`), mirroring slice_meshes' degradation rule: single-device
    replicas on one device only contend.

    Thread-safe under one lockdep-named lock; gauges (slicepool.*) ride
    the srml_elastic Prometheus family via a weak provider, so an
    abandoned pool is collectable."""

    def __init__(
        self,
        slice_devices: Optional[int] = None,
        devices: Optional[List[Any]] = None,
        *,
        allow_oversubscribe: bool = False,
    ):
        devs = list(devices) if devices is not None else list(_device.devices())
        if not devs:
            raise ValueError("SlicePool needs at least one device")
        self.slice_devices = (
            slice_devices
            if slice_devices is not None
            else _default_slice_devices(len(devs))
        )
        slices = carve_device_slices(devs, self.slice_devices)
        if not slices:
            raise ValueError(
                f"no {self.slice_devices}-device slice fits in "
                f"{len(devs)} device(s)"
            )
        self._devices = devs
        self._slices = slices
        self._meshes = [Mesh(tuple(s)) for s in slices]
        self.stranded_devices = len(devs) - self.slice_devices * len(slices)
        self.allow_oversubscribe = allow_oversubscribe
        self._lock = sanitize.lockdep_lock("serve.slicepool")
        self._owners: List[Optional[str]] = [None] * len(slices)
        self._rr = 0  # round-robin cursor for oversubscribed leases
        self._shared = 0  # live oversubscribed leases
        import weakref

        self._gauge_key = f"serving-slicepool-{id(self):x}"
        ref = weakref.ref(self)

        def _provider():
            pool = ref()
            return pool._pool_gauges() if pool is not None else {}

        profiling.register_gauges(self._gauge_key, _provider)

    # -- ledger ---------------------------------------------------------------
    @property
    def capacity(self) -> int:
        return len(self._slices)

    def free(self) -> int:
        with self._lock:
            return sum(1 for o in self._owners if o is None)

    def holders(self) -> Dict[str, int]:
        """Live owners -> held slice count (oversubscribed leases are not
        ledger slots and do not appear)."""
        with self._lock:
            out: Dict[str, int] = {}
            for o in self._owners:
                if o is not None:
                    out[o] = out.get(o, 0) + 1
            return out

    def allocate(
        self, owner: str, *, oversubscribe: Optional[bool] = None
    ) -> SliceLease:
        """Grant a free slice to `owner`.  `oversubscribe` overrides the
        pool-wide policy for this call (None: inherit)."""
        allow = (
            self.allow_oversubscribe if oversubscribe is None else oversubscribe
        )
        with self._lock:
            for i, holder in enumerate(self._owners):
                if holder is None:
                    self._owners[i] = owner
                    profiling.incr_counter("slicepool.allocate")
                    return SliceLease(
                        self, i, self._slices[i], self._meshes[i], owner,
                        shared=False,
                    )
            if not allow:
                held: Dict[str, int] = {}
                for o in self._owners:
                    held[o] = held.get(o, 0) + 1
                profiling.incr_counter("slicepool.exhausted")
                raise CapacityExhausted(
                    f"slicepool: all {self.capacity} "
                    f"{self.slice_devices}-device slice(s) are held "
                    f"({held}); scale something down, or pass "
                    "allow_oversubscribe=True to accept single-device "
                    "shared slices (compute contention, no rendezvous "
                    "deadlock)"
                )
            dev = self._devices[self._rr % len(self._devices)]
            self._rr += 1
            self._shared += 1
        profiling.incr_counter("slicepool.allocate")
        profiling.incr_counter("slicepool.oversubscribed")
        return SliceLease(self, -1, [dev], Mesh((dev,)), owner, shared=True)

    def release(self, lease: SliceLease) -> None:
        """Return a lease.  Idempotent: teardown paths (half-built replica
        sets, shutdown racing a scale-down) may release twice."""
        if lease.pool is not self:
            raise ValueError("lease belongs to a different SlicePool")
        with self._lock:
            if lease.released:
                return
            lease.released = True
            if lease.shared:
                self._shared -= 1
            else:
                self._owners[lease.index] = None
        profiling.incr_counter("slicepool.release")

    # -- observability --------------------------------------------------------
    def _pool_gauges(self) -> Dict[str, float]:
        with self._lock:
            free = sum(1 for o in self._owners if o is None)
            shared = self._shared
        return {
            "slicepool.slices": float(self.capacity),
            "slicepool.free": float(free),
            "slicepool.shared_leases": float(shared),
            "slicepool.stranded_devices": float(self.stranded_devices),
        }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            owners = list(self._owners)
            shared = self._shared
        return {
            "slice_devices": self.slice_devices,
            "capacity": self.capacity,
            "free": sum(1 for o in owners if o is None),
            "owners": owners,
            "shared_leases": shared,
            "stranded_devices": self.stranded_devices,
        }

    def close(self) -> None:
        """Unregister the gauge provider (a Router that built its own
        pool closes it on shutdown; the weakref makes this optional for
        abandoned pools)."""
        profiling.unregister_gauges(self._gauge_key)
