#
# ModelRegistry: named ModelServers over fitted models.
#
# Counterpart of spark_rapids_ml_tpu/serving/registry.py.  Two admission
# paths: register(name, model) for models already in memory (a just-fitted
# estimator, a kNN model whose item frame lives in the process), and
# load(name, path), which reads any saved model through the port's core.load
# (models saved by the port, and those saved by the JAX package) and serves
# it.  Either way the server warms EVERY serving bucket at registration, so
# the first request is already steady state.  swap(name, model) is the
# zero-downtime hot swap.
#
# The registry is the single-server deployment surface (one ModelServer per
# name; multiplex(name, models) one MultiplexServer of K same-shape
# variants).  Replicated, capacity-managed serving (slice-pool leases,
# scale_to, autoscaling, preemption repair) is the router plane
# (serving/router.py + serving/slicepool.py + serving/autoscale.py).
#

from __future__ import annotations

from typing import Any, Dict, Optional

from .. import sanitize
from .engine import SEVERITY, STATE_CODES, WARMING, ModelServer


class ModelRegistry:
    """Thread-safe name -> ModelServer map with load-time warmup.

    `server_kwargs` are the defaults every server is built with
    (max_batch, max_wait_ms, queue_depth, ...); per-model overrides go on
    register/load.  Each registry registers a health gauge provider
    (srml-watch), so every server's state/attainment/burn flows through
    profiling.export_metrics() and the Prometheus rendering for as long as
    the registry lives."""

    def __init__(self, **server_kwargs: Any):
        self._defaults = dict(server_kwargs)
        self._lock = sanitize.lockdep_lock("serve.registry.state")
        self._servers: Dict[str, ModelServer] = {}
        import weakref

        from .. import profiling

        # the provider holds a WEAK reference: a registry abandoned without
        # shutdown() must not be pinned alive by the gauge registry (its
        # servers' __del__ backstops still run, and the provider degrades
        # to {} instead of scraping a ghost)
        self._gauge_key = f"serving-registry-{id(self):x}"
        ref = weakref.ref(self)

        def _provider():
            reg = ref()
            return reg._health_gauges() if reg is not None else {}

        profiling.register_gauges(self._gauge_key, _provider)

    def register(self, name: str, model: Any, **overrides: Any) -> ModelServer:
        """Serve an in-memory fitted model under `name` (warms buckets and
        starts the dispatch worker before returning).  The name is RESERVED
        before the warmup: a duplicate fails immediately instead of paying
        the whole warm-up first — and polluting the live server's
        serving.<name>.* metrics namespace with a doomed twin's warmup."""
        with self._lock:
            if name in self._servers:
                raise ValueError(f"model name {name!r} already registered")
            self._servers[name] = None  # reservation; filled below
        try:
            server = ModelServer(name, model, **{**self._defaults, **overrides})
        except BaseException:
            with self._lock:
                self._servers.pop(name, None)
            raise
        with self._lock:
            self._servers[name] = server
        return server

    def multiplex(
        self,
        name: str,
        models: Dict[str, Any],
        *,
        resident_lanes: Optional[int] = None,
        **overrides: Any,
    ) -> "ModelServer":
        """Serve K same-shape model variants behind ONE lane-batched server
        (srml-lanes): every micro-batch dispatches one lane kernel across
        the tenants' stacked parameters, and variants beyond
        `resident_lanes` page into the LRU'd device lanes on demand.  The
        returned server is a MultiplexServer (a ModelServer subclass);
        clients pass model_id to submit()/predict().  Name reservation
        mirrors register(): a failed init releases the name."""
        from .multiplex import MultiplexServer

        with self._lock:
            if name in self._servers:
                raise ValueError(f"model name {name!r} already registered")
            self._servers[name] = None  # reservation; filled below
        try:
            server = MultiplexServer(
                name,
                models,
                resident_lanes=resident_lanes,
                **{**self._defaults, **overrides},
            )
        except BaseException:
            with self._lock:
                self._servers.pop(name, None)
            raise
        with self._lock:
            self._servers[name] = server
        return server

    def load(self, name: str, path: str, **overrides: Any) -> ModelServer:
        """Load a saved model from `path` via core persistence and serve it.
        Estimators (no transform surface) are rejected with a clear error."""
        from ..core import _TpuModel, load as core_load

        obj = core_load(path)
        if not isinstance(obj, _TpuModel):
            raise TypeError(
                f"{path!r} holds a {type(obj).__name__}, not a fitted model; "
                "only models are servable"
            )
        return self.register(name, obj, **overrides)

    def swap(
        self,
        name: str,
        new_model: Any,
        *,
        drain_timeout_s: float = 60.0,
        **overrides: Any,
    ) -> ModelServer:
        """Zero-downtime hot swap: warm a NEW server for `new_model` (a
        same-shape model of the same class re-warms keys already in the
        warm cache: zero new warm-ups), verify the
        serving signature matches the old generation, atomically cut the
        name over, then drain the old generation so its in-flight requests
        complete before teardown.  Traffic admitted after the cut-over
        lands on the new model; traffic admitted before it completes on
        the old one — no request is dropped, no submit window is closed.

        Raises KeyError for unknown/still-warming names and ValueError
        (from entry.check_swap_compatible) for a model whose feature
        width, dtype, or output columns differ — an incompatible upgrade
        is a register-under-a-new-name event, not a swap."""
        from .. import profiling
        from .entry import check_swap_compatible

        with self._lock:
            old = self._servers.get(name)
        if old is None:
            raise KeyError(f"no served model named {name!r} to swap")
        t0 = profiling.now()
        with profiling.span(f"serve.{name}.swap"):
            # warm BEFORE cut-over: the warm-up is paid while the old
            # generation still serves all traffic
            incoming = ModelServer(
                name, new_model, **{**self._defaults, **overrides}
            )
            try:
                check_swap_compatible(old._entry, incoming._entry, name)
                with self._lock:
                    if self._servers.get(name) is not old:
                        raise KeyError(
                            f"serving entry {name!r} changed during swap "
                            "(concurrent unregister/swap); aborting"
                        )
                    self._servers[name] = incoming  # the atomic cut-over
            except BaseException:
                incoming.shutdown(drain=False)
                raise
            # old generation: in-flight + already-queued requests drain to
            # completion, then clean teardown.  A drain timeout still tears
            # the old server down — the name already points at the new one.
            try:
                old.drain(timeout_s=drain_timeout_s)
            finally:
                old.shutdown(drain=False)
        profiling.incr_counter(f"serving.{name}.swaps")
        profiling.record_duration(f"serve.{name}.swap", profiling.now() - t0)
        return incoming

    def get(self, name: str) -> ModelServer:
        with self._lock:
            server = self._servers.get(name)
        if server is None:  # absent OR still warming (reservation)
            raise KeyError(f"no served model named {name!r}")
        return server

    def names(self) -> list:
        with self._lock:
            return sorted(n for n, s in self._servers.items() if s is not None)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return self._servers.get(name) is not None

    def unregister(self, name: str, drain: bool = True) -> None:
        with self._lock:
            server = self._servers.pop(name, None)
        if server is not None:
            server.shutdown(drain=drain)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            servers = {n: s for n, s in self._servers.items() if s is not None}
        return {name: s.stats() for name, s in sorted(servers.items())}

    def health(self) -> Dict[str, Any]:
        """Health of the whole serving plane: per-server SLO-scored health
        (serving/engine.ModelServer.health) plus the registry's overall
        state — the WORST server state, so one wedged worker turns the
        whole plane's headline red.  Servers still warming (reservations)
        report WARMING."""
        with self._lock:
            snapshot = dict(self._servers)
        models: Dict[str, Any] = {}
        for name, server in sorted(snapshot.items()):
            if server is None:  # reserved: register/load still warming
                models[name] = {
                    "name": name,
                    "state": WARMING,
                    "state_code": STATE_CODES[WARMING],
                }
            else:
                models[name] = server.health()
        # worst-state rollup over the SEVERITY order (not the stable gauge
        # codes): one wedged worker turns the whole plane's headline red,
        # and a RECOVERING server outranks a draining one
        worst = max(
            (m["state"] for m in models.values()),
            key=SEVERITY.index,
            default=WARMING,  # an empty registry is not unhealthy, just idle
        )
        return {
            "state": worst,
            # srml-shield rollup: total supervised restarts across the
            # plane — a restart-storm signal no single server's counter
            # shows (docs/robustness.md)
            "restarts": sum(m.get("restarts", 0) for m in models.values()),
            "models": models,
        }

    def _health_gauges(self) -> Dict[str, float]:
        """Gauge-provider view of health() for export_metrics()/Prometheus:
        health.<model>.{state_code,attainment,burn,p99_ms,queued_rows,
        restarts} — flattened by the shared srml-watch rule, so registry
        servers and router replicas render identically."""
        from .. import watch

        return watch.health_gauges(self.health()["models"])

    def telemetry(self, since: Optional[Any] = None) -> Any:
        """TelemetrySnapshot of the whole serving plane: every
        serving.<name>.* counter plus mergeable digests of the serve.<name>.*
        duration series.  Pass a previous snapshot as `since` for a delta —
        counter differences and count/sum duration deltas — so a scrape loop
        (or a live-Spark executor shipping its registry state to the coordinator)
        reports "what moved this window" instead of process history.
        Snapshots from many processes merge() associatively on the coordinator,
        exactly like fit telemetry."""
        from .. import profiling

        snap = profiling.TelemetrySnapshot(
            counters=profiling.counters("serving."),
            durations=profiling.duration_digests("serve."),
        )
        return snap if since is None else snap.delta(since)

    def shutdown(self, drain: bool = True) -> None:
        from .. import profiling

        profiling.unregister_gauges(self._gauge_key)
        with self._lock:
            servers = [s for s in self._servers.values() if s is not None]
            self._servers.clear()
        for s in servers:
            s.shutdown(drain=drain)

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


_default: Optional[ModelRegistry] = None
_default_lock = sanitize.lockdep_lock("serve.registry.default")


def default_registry() -> ModelRegistry:
    """Process-wide registry for embedders that want one shared serving
    plane."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ModelRegistry()
        return _default
