#
# srml-router: multi-replica serving.
#
# Counterpart of spark_rapids_ml_tpu/serving/router.py: N ModelServer
# replicas per model over slice-pool leases (serving/slicepool.py) behind
# one Router that owns
#
#   ADMISSION   per-request priority classes with fill-fraction shedding
#               (serving/scheduler.admit — batch traffic sheds first),
#   DISPATCH    least-outstanding replica selection among replicas IN
#               ROTATION, with health-aware failover: a replica reporting
#               RECOVERING / UNHEALTHY / DEGRADED is pulled from rotation
#               and re-admitted when its supervisor restores it (re-warmed
#               on its new worker: zero new warm-ups); a request whose
#               replica dies after admitting it is re-routed to a survivor,
#   SWAP        zero-downtime rolling model swap: each replica's successor
#               warms its buckets BEFORE the atomic per-slot cut-over, the
#               old generation drains its in-flight requests, and the set
#               never loses more than one replica of capacity,
#   ELASTIC     scale_to(name, n) grows / shrinks the set replica by replica
#               (a new replica warms before it joins rotation; a removed one
#               leaves rotation, drains, then releases its lease), and
#               replace_replica() re-leases and re-warms a terminal replica
#               in its slot; serving/autoscale.py drives both.
# serve_multiplex deploys a set of MultiplexServers (serving/multiplex.py),
# and submit(..., model_id=) targets one of their tenants.
#
# The device count of a set's own pool is the port's device.devices(): on
# one card it is 1, so two replicas of a model are two shared leases of
# cuda:0, granted under allow_oversubscribe=True.  Replicas are named
# "<model>-r<i>": every per-server surface (serving.<n>.* counters,
# serve.<n>.* series, health states, restart supervision, the SRML_FAULTS
# serving.dispatch tag) applies per replica.  Router counters live under
# router.<model>.*; its gauges render as the srml_router Prometheus family.
#

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from .. import device as _device
from .. import profiling, sanitize, watch
from . import scheduler
from .batcher import ServerDraining
from .engine import (
    DEGRADED,
    READY,
    STATE_CODES,
    UNHEALTHY,
    ModelServer,
    ServerOverloaded,
    ServerRecovering,
    ServerUnhealthy,
)
from .entry import check_swap_compatible
from .scheduler import DEFAULT_CLASS, NoReplicaAvailable, RequestShed
from .slicepool import SlicePool

logger = logging.getLogger("spark_rapids_ml_tpu_torch.serving")

REPLICAS_ENV = "SRML_SERVE_REPLICAS"
_DEFAULT_REPLICAS = 2

# router replicas default to depth-2 continuous batching (the engine's
# assembly/dispatch pipeline); SRML_SERVE_INFLIGHT_DEPTH or the ctor knob
# override.  Plain ModelServer keeps depth 1 — the router is the opt-in.
_DEFAULT_ROUTER_INFLIGHT_DEPTH = 2


def _default_replicas() -> int:
    from ..utils import env_float

    return max(1, int(env_float(REPLICAS_ENV, _DEFAULT_REPLICAS)))


class _ReplicaSet:
    """One served model's replicas + routing policy state.  The replica
    list is swapped under the router lock; dispatch reads a snapshot, so a
    rolling swap never blocks traffic on the other slots.

    The set also carries its capacity bookkeeping: `leases[i]` is the
    SlicePool lease replica i runs on, `slots[i]` its stable slot id
    (replica names are "<model>-r<slot>"; a replaced or re-grown slot
    reuses its id so per-replica metric series and fault tags stay
    continuous), `factory` the ONE replica constructor shared by
    serve/swap/scale_to/replace_replica, and `scale_lock` the per-set mutex
    that serializes structural changes (scale/swap/repair) without ever
    blocking dispatch, which only takes the router state lock."""

    def __init__(
        self, name, priority, replicas, leases, slots, kwargs, factory,
        pool, owns_pool, allow_oversubscribe,
    ):
        self.name = name
        self.priority = priority
        self.replicas: List[ModelServer] = replicas
        self.leases = leases
        self.slots = slots
        self.kwargs = kwargs  # per-replica ModelServer kwargs (for swap)
        self.factory = factory  # (replica_name, mesh) -> server
        self.pool = pool
        self.owns_pool = owns_pool  # implicit per-set pool: close on unroute
        self.allow_oversubscribe = allow_oversubscribe
        self.scale_lock = sanitize.lockdep_lock("serve.router.scale")

    @property
    def slices(self):
        """Mesh per replica (lease view) — kept for callers that predate
        the slice pool."""
        return [lease.mesh for lease in self.leases]


class Router:
    """Health-aware request router over per-model replica sets.

    `serve(name, model)` carves `replicas` disjoint mesh slices and warms
    one ModelServer per slice; `submit`/`predict` admit (priority-class
    shedding), pick (least outstanding among READY replicas), and fail
    over; `swap(name, new_model)` is the zero-downtime rolling upgrade.
    Use as a context manager or call shutdown()."""

    def __init__(
        self,
        replicas: Optional[int] = None,
        inflight_depth: Optional[int] = None,
        pool: Optional[SlicePool] = None,
        **server_kwargs: Any,
    ):
        self._replicas_default = replicas or _default_replicas()
        # srml-elastic: a shared SlicePool makes slice ownership explicit
        # ACROSS models and leaves headroom for scale_to/autoscaling.
        # Without one, each serve() builds a private per-set pool sized so
        # the initial replica count covers every device — the historical
        # whole-fleet carve, byte-compatible with pre-pool routers.
        self._pool = pool
        from ..utils import env_float

        self._inflight_depth = max(
            1,
            int(
                inflight_depth
                if inflight_depth is not None
                else env_float(
                    "SRML_SERVE_INFLIGHT_DEPTH",
                    _DEFAULT_ROUTER_INFLIGHT_DEPTH,
                )
            ),
        )
        self._defaults = dict(server_kwargs)
        self._lock = sanitize.lockdep_lock("serve.router.state")
        self._sets: Dict[str, _ReplicaSet] = {}
        import weakref

        # weak gauge provider, same discipline as ModelRegistry: an
        # abandoned router must not be pinned alive by the gauge registry
        self._gauge_key = f"serving-router-{id(self):x}"
        ref = weakref.ref(self)

        def _provider():
            router = ref()
            return router._router_gauges() if router is not None else {}

        profiling.register_gauges(self._gauge_key, _provider)

    # -- deployment -----------------------------------------------------------
    def _deploy(
        self,
        name: str,
        priority: str,
        n: int,
        factory,
        kwargs: Dict[str, Any],
        allow_oversubscribe: bool,
    ) -> List[ModelServer]:
        """The ONE deployment path under serve()/serve_multiplex(): reserve
        the name, lease `n` disjoint slices from the pool, build a replica
        per lease through `factory`, install atomically.  The name is
        reserved before the (expensive) warmups, so a duplicate fails
        before paying any warm-up; a replica whose warmup fails tears
        down the ones already built and releases every lease.

        Slice accounting replaces the historical silent round-robin
        oversubscription: asking for more replicas than the pool can carve
        WITHOUT sharing devices raises the typed CapacityExhausted (a
        ValueError) unless allow_oversubscribe=True — opting in degrades
        the overflow replicas to single shared devices, which only
        contend."""
        scheduler.class_index(priority)  # typo'd class fails at deploy time
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        with self._lock:
            if name in self._sets:
                raise ValueError(f"model name {name!r} already routed")
            self._sets[name] = None  # reservation; filled below
        built: List[ModelServer] = []
        leases: List[Any] = []
        pool = self._pool
        owns_pool = pool is None
        try:
            if pool is None:
                # per-set pool reproducing the whole-fleet carve: n slices
                # of len(devices)//n (plus any headroom the division
                # leaves), group-major so none straddles a host group
                n_dev = len(_device.devices())
                pool = SlicePool(slice_devices=max(1, n_dev // n))
            for slot in range(n):
                leases.append(
                    pool.allocate(
                        f"{name}-r{slot}",
                        oversubscribe=allow_oversubscribe or None,
                    )
                )
            for slot, lease in enumerate(leases):
                built.append(factory(f"{name}-r{slot}", lease.mesh))
        except BaseException:
            for srv in built:
                try:
                    srv.shutdown(drain=False)
                except Exception:  # noqa: BLE001 - teardown of a half-built set
                    logger.warning(
                        "router: teardown of half-built replica %r failed",
                        srv.name,
                    )
            for lease in leases:
                pool.release(lease)
            if owns_pool and pool is not None:
                pool.close()
            with self._lock:
                self._sets.pop(name, None)
            raise
        rs = _ReplicaSet(
            name, priority, built, leases, list(range(n)), kwargs,
            factory, pool, owns_pool, allow_oversubscribe,
        )
        with self._lock:
            self._sets[name] = rs
        profiling.incr_counter(f"router.{name}.replicas_started", n)
        return built

    def serve(
        self,
        name: str,
        model: Any,
        replicas: Optional[int] = None,
        priority: str = DEFAULT_CLASS,
        allow_oversubscribe: bool = False,
        **overrides: Any,
    ) -> List[ModelServer]:
        """Deploy `model` under `name` as a replica set: lease disjoint
        mesh slices from the slice pool, then warm one ModelServer per
        slice ("<name>-r<i>").  More replicas than the pool can carve
        without sharing devices raises the typed CapacityExhausted unless
        `allow_oversubscribe=True` (see _deploy)."""
        kwargs = {
            "inflight_depth": self._inflight_depth,
            **self._defaults,
            **overrides,
        }

        def factory(replica_name: str, mesh) -> ModelServer:
            return ModelServer(replica_name, model, mesh=mesh, **kwargs)

        return self._deploy(
            name, priority, replicas or self._replicas_default, factory,
            kwargs, allow_oversubscribe,
        )

    def serve_multiplex(
        self,
        name: str,
        models: Dict[str, Any],
        replicas: Optional[int] = None,
        priority: str = DEFAULT_CLASS,
        *,
        resident_lanes: Optional[int] = None,
        allow_oversubscribe: bool = False,
        **overrides: Any,
    ) -> List[ModelServer]:
        """Deploy K same-shape model variants as a replica set of
        lane-batched MultiplexServers (srml-lanes): each replica stacks
        every resident variant into ONE parameter buffer on ITS mesh
        slice, and `submit(..., model_id=...)` routes tenants through the
        same admission/failover plane as dedicated sets.  Rolling swap()
        is a dedicated-server feature — upgrade a multiplexed set by
        deploying a successor set under a new name."""
        from .multiplex import MultiplexServer

        kwargs = {
            "inflight_depth": self._inflight_depth,
            **self._defaults,
            **overrides,
        }

        def factory(replica_name: str, mesh) -> ModelServer:
            return MultiplexServer(
                replica_name, models, mesh=mesh,
                resident_lanes=resident_lanes, **kwargs,
            )

        return self._deploy(
            name, priority, replicas or self._replicas_default, factory,
            kwargs, allow_oversubscribe,
        )

    # -- elastic actuation (serving/autoscale.py drives these) ---------------
    def _spawn_slot(self, name: str, rs: _ReplicaSet, slot: int):
        """Lease a slice and build the replica for `slot` through the
        set's shared factory.  Returns (replica, lease); on a build
        failure the lease is released before the error propagates.
        Caller holds rs.scale_lock (never the state lock — warmup is the
        expensive part and dispatch must keep flowing)."""
        lease = rs.pool.allocate(
            f"{name}-r{slot}", oversubscribe=rs.allow_oversubscribe or None
        )
        try:
            replica = rs.factory(f"{name}-r{slot}", lease.mesh)
        except BaseException:
            rs.pool.release(lease)
            raise
        return replica, lease

    def scale_to(
        self, name: str, n: int, *, drain_timeout_s: float = 30.0
    ) -> List[ModelServer]:
        """Resize the replica set to exactly `n` replicas — the elastic
        plane's actuator (serving/autoscale.py decides when; this makes
        it so).  Scale-UP leases a fresh pool slice per new slot, warms
        the replica through the set's factory (for a model class already
        served, every key of the warm cache is warm already: ZERO new
        warm-ups — the swap discipline), and
        admits it to rotation atomically; no free slice raises the typed
        retryable CapacityExhausted with the set unchanged mid-growth.
        Scale-DOWN removes the highest slot from rotation atomically,
        drains its in-flight work, then releases its slice back to the
        pool — admitted requests finish, new ones never see it.  Returns
        the post-scale replica snapshot."""
        rs = self._set(name)
        if n < 1:
            raise ValueError(
                f"router.{name}: cannot scale below 1 replica (got {n}); "
                "use unroute() to stop serving"
            )
        with rs.scale_lock:
            with profiling.span(f"router.{name}.scale", target=n):
                while True:
                    with self._lock:
                        if self._sets.get(name) is not rs:
                            raise KeyError(
                                f"routed model {name!r} was removed during "
                                "scale_to; aborting"
                            )
                        cur = len(rs.replicas)
                        if cur == n:
                            return list(rs.replicas)
                        if cur > n:
                            # atomic removal: highest slot leaves rotation
                            i = max(
                                range(len(rs.slots)), key=rs.slots.__getitem__
                            )
                            victim = rs.replicas.pop(i)
                            lease = rs.leases.pop(i)
                            rs.slots.pop(i)
                        else:
                            slot = next(
                                s for s in range(n) if s not in rs.slots
                            )
                    if cur > n:
                        try:
                            victim.drain(timeout_s=drain_timeout_s)
                        finally:
                            victim.shutdown(drain=False)
                            rs.pool.release(lease)
                        profiling.incr_counter(f"router.{name}.scaled_down")
                        continue
                    replica, lease = self._spawn_slot(name, rs, slot)
                    with self._lock:
                        if self._sets.get(name) is not rs:
                            installed = False
                        else:
                            rs.replicas.append(replica)
                            rs.leases.append(lease)
                            rs.slots.append(slot)
                            installed = True
                    if not installed:
                        replica.shutdown(drain=False)
                        rs.pool.release(lease)
                        raise KeyError(
                            f"routed model {name!r} was removed during "
                            "scale_to; aborting"
                        )
                    profiling.incr_counter(f"router.{name}.scaled_up")
                    profiling.incr_counter(f"router.{name}.replicas_started")

    def replace_replica(
        self, name: str, dead: ModelServer
    ) -> Optional[ModelServer]:
        """Replace one terminal replica in place — preemption as the
        common case (serving/autoscale.py's repair path).  The dead
        replica's slice goes back to the pool FIRST, a fresh lease is
        taken (possibly the same devices, possibly a re-slice), the
        successor warms through the set's factory (its keys are warm
        already: zero new warm-ups), and the slot cuts over atomically under the
        state lock — same discipline as swap(), minus the compat check
        (same factory, same model).  The dead replica is torn down
        without drain: its worker already died, and the engine already
        failed its in-flight futures with the typed retryable errors the
        router reroutes.  Returns the successor, or None if the replica
        had already been replaced/removed (repair paths may race)."""
        rs = self._set(name)
        with rs.scale_lock:
            with self._lock:
                if self._sets.get(name) is not rs:
                    return None
                try:
                    i = rs.replicas.index(dead)
                except ValueError:
                    return None  # already replaced or scaled away
                slot = rs.slots[i]
                old_lease = rs.leases[i]
            rs.pool.release(old_lease)
            incoming, lease = self._spawn_slot(name, rs, slot)
            with self._lock:
                installed = False
                if self._sets.get(name) is rs:
                    try:
                        i = rs.replicas.index(dead)
                    except ValueError:
                        i = -1
                    if i >= 0:
                        rs.replicas[i] = incoming  # atomic slot cut-over
                        rs.leases[i] = lease
                        installed = True
            if not installed:
                incoming.shutdown(drain=False)
                rs.pool.release(lease)
                return None
            try:
                dead.shutdown(drain=False)
            except Exception:  # noqa: BLE001 - teardown of a dead replica
                logger.warning(
                    "router.%s: teardown of replaced replica %r failed",
                    name, dead.name,
                )
            profiling.incr_counter(f"router.{name}.replicas_replaced")
            return incoming

    def _set(self, name: str) -> _ReplicaSet:
        with self._lock:
            rs = self._sets.get(name)
        if rs is None:  # absent OR reserved (still warming)
            raise KeyError(f"no routed model named {name!r}")
        return rs

    def names(self) -> list:
        with self._lock:
            return sorted(n for n, rs in self._sets.items() if rs is not None)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return self._sets.get(name) is not None

    def replicas(self, name: str) -> List[ModelServer]:
        """Snapshot of the current replica list (swap-safe copy)."""
        rs = self._set(name)
        with self._lock:
            return list(rs.replicas)

    # -- request path ---------------------------------------------------------
    def submit(
        self,
        name: str,
        features: Any,
        timeout_ms: Optional[float] = None,
        priority: Optional[str] = None,
        model_id: Optional[str] = None,
    ):
        """Admit, pick, dispatch: returns a ROUTED Future.  `model_id`
        targets one tenant of a multiplexed set (serve_multiplex) and is
        forwarded to the replica's submit.  Unlike a bare
        ModelServer future, a routed future absorbs replica failures: a
        replica that dies or is superseded after admitting the request
        resolves it with the typed retryable ServerRecovering/
        ServerUnhealthy, and the router re-routes to a survivor instead of
        surfacing that to the client (router.<name>.rerouted counts).  The
        future only carries an error when the WHOLE set cannot take the
        request — NoReplicaAvailable / ServerOverloaded, typed and
        retryable-with-backoff.  submit() itself raises only RequestShed
        (admission: this priority class is being shed under load) and
        KeyError (unknown name)."""
        rs = self._set(name)
        klass = priority if priority is not None else rs.priority
        reps = self.replicas(name)
        fill = scheduler.aggregate_fill(reps)
        if not scheduler.admit(klass, fill):
            profiling.incr_counter(f"router.{name}.shed")
            profiling.incr_counter(f"router.{name}.shed_{klass}")
            raise RequestShed(
                f"router.{name}: shedding {klass!r} traffic at "
                f"{fill:.0%} aggregate queue fill "
                f"({scheduler.SHED_FRACTIONS_ENV} ceilings "
                f"{scheduler.shed_fractions()})"
            )
        profiling.incr_counter(f"router.{name}.admitted")
        from concurrent.futures import Future

        from .batcher import resolve_future

        outer: "Future" = Future()
        # keyed by replica OBJECT identity, not name: a swap/restart puts a
        # healthy same-named successor in the slot, and a request rerouted
        # off the dying old generation must still be able to land on it
        tried: set = set()
        tried_names: list = []

        def attempt() -> None:
            """Route to the least-loaded in-rotation replica not yet
            tried.  SUBMIT-time rejections (overloaded/recovering/
            unhealthy) fail over inline; RESOLUTION-time replica failures
            (the worker died or was superseded AFTER admitting — the
            typed retryable ServerRecovering/ServerUnhealthy) re-route
            through the done-callback below, so a replica killed mid-
            batch is a p99 blip on the survivor, never a client-visible
            error.  Only when the WHOLE set rejects does the outer future
            carry the last typed (retryable) rejection."""
            last_exc: Optional[Exception] = None
            candidates = [
                r for r in self.replicas(name) if id(r) not in tried
            ]
            while candidates:
                try:
                    replica, mode = scheduler.pick(candidates)
                except NoReplicaAvailable as exc:
                    profiling.incr_counter(f"router.{name}.shed")
                    if last_exc is None:
                        profiling.incr_counter(f"router.{name}.no_replica")
                    resolve_future(outer, exc=last_exc or exc)
                    return
                if mode == "degraded":
                    profiling.incr_counter(f"router.{name}.degraded_mode")
                kw = {} if model_id is None else {"model_id": model_id}
                try:
                    fut = replica.submit(features, timeout_ms=timeout_ms, **kw)
                except (KeyError, ValueError) as exc:
                    # unknown tenant / bad request: a CLIENT error identical
                    # on every replica — resolve, never fail over (and never
                    # raise out of a done-callback re-route)
                    resolve_future(outer, exc=exc)
                    return
                except (
                    ServerDraining,  # racing a rolling-swap cut-over
                    ServerOverloaded,
                    ServerRecovering,
                    ServerUnhealthy,
                ) as exc:
                    last_exc = exc
                    profiling.incr_counter(f"router.{name}.failover")
                    candidates.remove(replica)
                    continue
                profiling.incr_counter(f"router.{name}.dispatched")
                fut.add_done_callback(lambda f, r=replica: on_done(f, r))
                return
            profiling.incr_counter(f"router.{name}.shed")
            # candidates can start EMPTY here: a rerouted request that has
            # already tried every replica re-enters with nothing left, and
            # last_exc is None — resolve with the typed retryable error,
            # never raise out of a done-callback (that would strand the
            # client future unresolved)
            resolve_future(
                outer,
                exc=last_exc
                or NoReplicaAvailable(
                    f"router.{name}: every replica failed this request "
                    f"after admission (tried {sorted(tried_names)})"
                ),
            )

        def on_done(fut: "Future", replica) -> None:
            # runs synchronously inside the resolving thread (a dispatch
            # worker's scatter, or a recovery thread's shed) — must only
            # enqueue/resolve, never block
            if fut.cancelled():
                outer.cancel()
                return
            exc = fut.exception()
            if exc is None:
                resolve_future(outer, fut.result(timeout=0))
                return
            if isinstance(exc, (ServerRecovering, ServerUnhealthy)):
                # the replica failed AFTER admission (death/wedge/shed):
                # re-route to a survivor — this retry is the router's job,
                # not the client's
                tried.add(id(replica))
                tried_names.append(replica.name)
                profiling.incr_counter(f"router.{name}.rerouted")
                attempt()
                return
            resolve_future(outer, exc=exc)

        attempt()
        return outer

    def predict(
        self,
        name: str,
        features: Any,
        timeout_ms: Optional[float] = None,
        priority: Optional[str] = None,
        model_id: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Blocking convenience around submit(), bounded like
        ModelServer.predict."""
        fut = self.submit(
            name, features, timeout_ms=timeout_ms, priority=priority,
            model_id=model_id,
        )
        wait_s = None
        if timeout_ms is not None and timeout_ms > 0:
            wait_s = timeout_ms / 1000.0 + 60.0  # dispatch slack
        return fut.result(timeout=wait_s)

    # -- zero-downtime rolling swap -------------------------------------------
    def swap(
        self,
        name: str,
        new_model: Any,
        *,
        drain_timeout_s: float = 60.0,
    ) -> List[ModelServer]:
        """Rolling model swap across the replica set: for each slot, warm
        the successor on the SAME mesh slice (for a same-shape model of
        the same class every key is warm already: zero new warm-ups —
        while the old replica still serves), verify
        the serving signature, atomically cut the slot over, then drain
        and tear down the old generation.  One slot at a time: capacity
        never drops below N-1 replicas, and traffic keeps flowing through
        the untouched slots — zero downtime.

        An incompatible model (entry.check_swap_compatible) fails BEFORE
        the first cut-over, leaving the set untouched.  A completed swap
        also updates the set's replica factory, so later scale_to()
        growth and preemption repairs spawn the NEW model."""
        rs = self._set(name)
        t0 = profiling.now()
        swapped: List[ModelServer] = []

        def factory(replica_name: str, mesh) -> ModelServer:
            return ModelServer(replica_name, new_model, mesh=mesh, **rs.kwargs)

        with rs.scale_lock, profiling.span(
            f"router.{name}.swap", replicas=len(rs.replicas)
        ):
            for i in range(len(rs.replicas)):
                with self._lock:
                    old = rs.replicas[i]
                    mesh_i = rs.leases[i].mesh
                incoming = factory(old.name, mesh_i)
                try:
                    check_swap_compatible(old._entry, incoming._entry, name)
                    with self._lock:
                        # re-check under the lock: a concurrent unroute()/
                        # shutdown() popped the set — cutting a slot over
                        # into the orphaned set would leak the incoming
                        # server's threads and buffers forever
                        if self._sets.get(name) is not rs:
                            raise KeyError(
                                f"routed model {name!r} was removed during "
                                "swap; aborting"
                            )
                        if rs.replicas[i] is not old:
                            # a concurrent swap() already cut this slot
                            # over; overwriting ITS replica would leak a
                            # fully-warmed server's threads and buffers
                            # (registry.swap has the same guard)
                            raise RuntimeError(
                                f"router.{name}: slot {i} was swapped "
                                "concurrently; aborting this swap"
                            )
                        rs.replicas[i] = incoming  # per-slot atomic cut-over
                except BaseException:
                    incoming.shutdown(drain=False)
                    raise
                swapped.append(incoming)
                profiling.incr_counter(f"router.{name}.replica_swaps")
                try:
                    old.drain(timeout_s=drain_timeout_s)
                finally:
                    old.shutdown(drain=False)
            with self._lock:
                rs.factory = factory  # scale-ups now spawn the new model
        profiling.incr_counter(f"router.{name}.swaps")
        profiling.record_duration(
            f"router.{name}.swap", profiling.now() - t0
        )
        return swapped

    def unroute(self, name: str, drain: bool = True) -> None:
        with self._lock:
            rs = self._sets.pop(name, None)
        if rs is None:
            return
        self._teardown_set(rs, drain=drain)

    def _teardown_set(self, rs: _ReplicaSet, drain: bool) -> None:
        """Shut every replica down and return its slice to the pool; an
        implicit per-set pool is closed outright (its gauge provider goes
        with it)."""
        for srv in rs.replicas:
            srv.shutdown(drain=drain)
        for lease in rs.leases:
            rs.pool.release(lease)
        if rs.owns_pool:
            rs.pool.close()

    # -- health / observability ----------------------------------------------
    def _model_health(self, rs: _ReplicaSet) -> Dict[str, Any]:
        """Capacity-aware rollup for one replica set: READY when every
        replica is in rotation, DEGRADED while ANY replica is out but
        traffic still flows (reduced capacity — the router's whole point
        is that this is an alert, not an outage), UNHEALTHY only when
        nothing is dispatchable."""
        with self._lock:
            reps = list(rs.replicas)
        health = {r.name: r.health() for r in reps}
        states = [scheduler._state_of(r) for r in reps]
        in_rotation = sum(1 for s in states if s == READY)
        dispatchable = in_rotation + sum(1 for s in states if s == DEGRADED)
        if in_rotation == len(reps):
            state = READY
        elif dispatchable > 0:
            state = DEGRADED
        else:
            state = UNHEALTHY
        return {
            "name": rs.name,
            "state": state,
            "state_code": STATE_CODES[state],
            "priority": rs.priority,
            "replicas": len(reps),
            "in_rotation": in_rotation,
            "fill": round(scheduler.aggregate_fill(reps), 6),
            # the autoscaler's signal surface, exported so operators see
            # exactly what the policy loop saw: fill_fraction is the
            # admission fill (queued rows / queue depth), occupancy the
            # busyness including rows in flight on the devices
            "fill_fraction": round(scheduler.aggregate_fill(reps), 6),
            "occupancy": round(scheduler.aggregate_occupancy(reps), 6),
            "restarts": sum(h.get("restarts", 0) for h in health.values()),
            "models": health,  # per-replica health, engine.health() shape
        }

    def health(self) -> Dict[str, Any]:
        """Router-plane health: per-model capacity-aware rollups plus the
        plane headline (worst model state in capacity terms) and the
        plane-wide restart total — the restart-storm signal across every
        replica of every model."""
        with self._lock:
            sets = {
                n: rs for n, rs in self._sets.items() if rs is not None
            }
        models = {n: self._model_health(rs) for n, rs in sorted(sets.items())}
        order = (READY, DEGRADED, UNHEALTHY)
        worst = max(
            (m["state"] for m in models.values()),
            key=order.index,
            default=READY,  # an empty router is idle, not unhealthy
        )
        return {
            "state": worst,
            "restarts": sum(m["restarts"] for m in models.values()),
            "models": models,
        }

    def stats(self) -> Dict[str, Any]:
        """Per-replica ModelServer.stats() plus the router.<model>.*
        counter families (admitted/shed/dispatched/failover/swaps)."""
        with self._lock:
            sets = {
                n: rs for n, rs in self._sets.items() if rs is not None
            }
        out: Dict[str, Any] = {}
        for name, rs in sorted(sets.items()):
            with self._lock:
                reps = list(rs.replicas)
            out[name] = {
                "priority": rs.priority,
                "replicas": {r.name: r.stats() for r in reps},
                "counters": profiling.counters(f"router.{name}."),
            }
        return out

    def _router_gauges(self) -> Dict[str, float]:
        """Gauge-provider view for export_metrics()/render_prometheus():
        router.<model>.{state_code,replicas,in_rotation,fill} (the
        srml_router family) plus per-replica health.<model>-r<i>.* through
        the shared srml-watch flattening (the srml_health family)."""
        out: Dict[str, float] = {}
        for name, m in self.health()["models"].items():
            out[f"router.{name}.state_code"] = float(m["state_code"])
            out[f"router.{name}.replicas"] = float(m["replicas"])
            out[f"router.{name}.in_rotation"] = float(m["in_rotation"])
            out[f"router.{name}.fill"] = float(m["fill"])
            out[f"router.{name}.fill_fraction"] = float(m["fill_fraction"])
            out[f"router.{name}.occupancy"] = float(m["occupancy"])
            out.update(watch.health_gauges(m["models"]))
        return out

    def telemetry(self, since: Optional[Any] = None) -> Any:
        """TelemetrySnapshot of the routed plane: router.<model>.* counters
        ride the same snapshot/delta/merge surface as the per-server
        serving.* families (ModelRegistry.telemetry documents the
        algebra)."""
        snap = profiling.TelemetrySnapshot(
            counters={
                **profiling.counters("router."),
                **profiling.counters("serving."),
            },
            durations=profiling.duration_digests("serve."),
        )
        return snap if since is None else snap.delta(since)

    def shutdown(self, drain: bool = True) -> None:
        profiling.unregister_gauges(self._gauge_key)
        with self._lock:
            sets = [rs for rs in self._sets.values() if rs is not None]
            self._sets.clear()
        for rs in sets:
            self._teardown_set(rs, drain=drain)

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
