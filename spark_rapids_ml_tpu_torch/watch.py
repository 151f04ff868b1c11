#
# srml-watch: the always-on health plane.
#
# Counterpart of spark_rapids_ml_tpu/watch.py:
#
#   1. FLIGHT RECORDER: a fixed-size ring of recent span open / close,
#      counter and exception events, always on (SRML_WATCH=0 opts out), fed
#      by profiling.span() and profiling.incr_counter() through the
#      profiling._flight hook; dump() writes it as Chrome-trace JSON
#      (flight-<tag>-*.json under SRML_TRACE_DIR).  It also keeps every
#      thread's open span stack: what a hang dump shows.
#   2. STALL DETECTION: HeartbeatPublisher and StallWatchdog over a control
#      plane's publish_health / read_health, and start_fit_health to start
#      both for a barrier fit (parallel/runner.DistributedFitSession.fit
#      calls it on every rank of a multi-process fit; the Spark barrier
#      tasks around it are ROADMAP A14c-2).  The serving engine's wedge
#      detection uses stall_threshold_s (SRML_WATCH_STALL_S).
#   3. DEVICE MEMORY: torch.cuda.memory_allocated / max_memory_allocated
#      summed over the port's CUDA devices, sampled at span boundaries and
#      exported as gauges.  Watch never initialises CUDA: it samples only
#      once torch.cuda.is_initialized() (the JAX module waits for jax to be
#      imported the same way).
#   4. HEALTH SURFACE: health_gauges flattens the serving plane's per-server
#      health into the gauge keys of the srml_health Prometheus family.
#
# Everything here is observability: a failure inside watch never fails the
# work it watches.
#

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from . import profiling, sanitize

_log = logging.getLogger("spark_rapids_ml_tpu_torch.watch")

WATCH_ENV = "SRML_WATCH"                    # "0" disables the flight recorder
RING_ENV = "SRML_WATCH_RING"                # ring capacity (events)
MAX_DUMPS_ENV = "SRML_WATCH_MAX_DUMPS"      # per-process dump bound
HEARTBEAT_ENV = "SRML_WATCH_HEARTBEAT_S"    # per-rank heartbeat period
STALL_ENV = "SRML_WATCH_STALL_S"            # stall threshold (0 = off)

_DEFAULT_RING = 4096
_DEFAULT_MAX_DUMPS = 32
_DEFAULT_HEARTBEAT_S = 1.0


from .utils import env_float as _env_float  # noqa: E402 - knob parsing


def stall_threshold_s() -> float:
    """SRML_WATCH_STALL_S: seconds of frozen progress before a rank or a
    serving worker is declared stalled.  0 (the default) disables stall
    detection — a first kernel build (nvcc) can freeze span progress for
    minutes, so the threshold is deployment policy, not a constant."""
    return _env_float(STALL_ENV, 0.0)


def heartbeat_interval_s() -> float:
    """SRML_WATCH_HEARTBEAT_S: the per-rank heartbeat period.  This is the
    ONE liveness cadence the health plane is expressed in — the srml-wire
    membership lease defaults to 1.5x this value (netplane.lease_interval_s),
    which is what makes "a lost rank is named within 2 heartbeat intervals"
    a contract instead of a coincidence."""
    return _env_float(HEARTBEAT_ENV, _DEFAULT_HEARTBEAT_S)


# -- the flight recorder ------------------------------------------------------

_wtls = threading.local()


class FlightRecorder:
    """Fixed-size, lock-cheap ring of recent observability events plus a
    registry of every thread's currently-OPEN span stack.

    Ring entries (tuples, kind first):
      ("span", name, t0, t1, ident, tname, depth, error)
      ("ctr",  name, amount, total, t, ident)
      ("exc",  tag, t, ident, tname, etype, message, failing_span)

    The per-thread open stack lives in the owning thread's TLS and is
    REGISTERED here so other threads (watchdogs, heartbeat publishers,
    dump()) can read "what is thread X inside right now".  Owner-writes /
    reader-snapshots under the GIL; readers copy before iterating."""

    def __init__(self, cap: Optional[int] = None):
        # clamped >= 1: a zero/negative SRML_WATCH_RING must degrade to a
        # tiny ring, never to IndexError inside every span/counter the
        # recorder watches (observability must not fail the work)
        raw = cap if cap is not None else _env_float(RING_ENV, _DEFAULT_RING)
        self.cap = max(1, int(raw))
        self._ring: List[Optional[tuple]] = [None] * self.cap
        self._idx = 0
        self._total = 0
        self._lock = sanitize.lockdep_lock("watch.ring")
        # ident -> [thread_obj, open_stack(list of (name, t_open)), closes]
        self._threads: Dict[int, list] = {}
        self._mem_lock = sanitize.lockdep_lock("watch.mem")
        self._phase_mem: Dict[str, list] = {}  # name -> [count, peak, sum_delta]
        self._mem_sampler: Optional[Callable[[], Optional[Tuple[float, float]]]] = None
        self._mem_probed = False

    # -- thread registry -----------------------------------------------------
    def _thread_slot(self) -> list:
        # keyed by RECORDER identity too: a thread whose TLS slot belongs
        # to a previous recorder (disable/enable cycle, test fixtures) gets
        # a fresh slot registered HERE, so open_spans()/progress() always
        # describe this recorder's own bookkeeping
        if getattr(_wtls, "rec", None) is self:
            return _wtls.slot
        th = threading.current_thread()
        slot = [th, [], 0]
        _wtls.slot = slot
        _wtls.rec = self
        _wtls.err_span = None
        # registration + prune under the ring lock: every instrumented
        # thread passes through here, and a concurrent insert during the
        # prune's items() scan would raise (dict changed size) — caught by
        # graftlint R12; the TLS fast path above keeps this once-per-thread
        with self._lock:
            self._threads[th.ident] = slot
            if len(self._threads) > 256:  # prune dead threads, bounded
                for ident in [
                    i for i, s in self._threads.items() if not s[0].is_alive()
                ]:
                    del self._threads[ident]
        return slot

    # -- event intake (called from profiling hooks) --------------------------
    def on_span_open(self, name: str) -> None:
        slot = self._thread_slot()
        mem = None
        if self._mem_sampler is not None:
            try:
                mem = self._mem_sampler()
            except Exception:
                mem = None
        elif not self._mem_probed:
            self._probe_memory()
        slot[1].append((name, profiling.now(), mem))

    def on_span_close(self, name: str, t0: float, t1: float, error: bool) -> None:
        slot = self._thread_slot()
        stack = slot[1]
        mem_open = None
        if stack and stack[-1][0] == name:
            mem_open = stack.pop()[2]
        depth = len(stack)
        slot[2] += 1  # progress: the liveness signal heartbeats publish
        if error:
            if getattr(_wtls, "err_span", None) is None:
                _wtls.err_span = name  # innermost failing span
        else:
            _wtls.err_span = None
        if mem_open is not None and self._mem_sampler is not None:
            try:
                now_mem = self._mem_sampler()
            except Exception:
                now_mem = None
            if now_mem is not None:
                in_use0, _peak0 = mem_open
                _in_use1, peak1 = now_mem
                with self._mem_lock:
                    agg = self._phase_mem.setdefault(name, [0, 0.0, 0.0])
                    agg[0] += 1
                    agg[1] = max(agg[1], float(peak1))
                    agg[2] += max(0.0, float(peak1) - float(in_use0))
        th = slot[0]
        self._append(("span", name, t0, t1, th.ident, th.name, depth, error))

    def on_counter(self, name: str, amount: int, total: int) -> None:
        self._append(
            ("ctr", name, amount, total, profiling.now(),
             threading.get_ident())
        )

    def record_exception(self, exc: BaseException, tag: str) -> None:
        """Ring-record an unhandled exception with the innermost failing
        span (the first span that closed with the error in flight)."""
        th = threading.current_thread()
        failing = getattr(_wtls, "err_span", None)
        if failing is None:
            stack = getattr(_wtls, "slot", [None, []])[1]
            failing = stack[-1][0] if stack else None
        # counter first: the exception instant must be the ring's (and the
        # dump's) LAST event, so "what failed" is the end of the timeline
        profiling.incr_counter("watch.exceptions")
        self._append(
            ("exc", tag, profiling.now(), th.ident, th.name,
             type(exc).__name__, str(exc)[:512], failing)
        )

    def _append(self, rec: tuple) -> None:
        with self._lock:
            self._ring[self._idx] = rec
            self._idx = (self._idx + 1) % self.cap
            self._total += 1

    # -- read surface --------------------------------------------------------
    def records(self) -> List[tuple]:
        """Ring contents, oldest first."""
        with self._lock:
            if self._total < self.cap:
                return [r for r in self._ring[: self._idx]]
            return [
                r
                for r in self._ring[self._idx :] + self._ring[: self._idx]
                if r is not None
            ]

    def event_count(self) -> int:
        """Lifetime events recorded (ring holds the most recent cap)."""
        with self._lock:
            return self._total

    def open_spans(self) -> Dict[int, Tuple[str, List[str]]]:
        """{thread ident: (thread name, open span names, outer->inner)} for
        every registered live thread — the hang-time question."""
        out: Dict[int, Tuple[str, List[str]]] = {}
        for ident, slot in list(self._threads.items()):
            th, stack = slot[0], list(slot[1])
            if th.is_alive():
                out[ident] = (th.name, [s[0] for s in stack])
        return out

    def innermost(self, ident: Optional[int] = None) -> Optional[str]:
        """Innermost open span of `ident` (default: calling thread)."""
        slot = self._threads.get(
            ident if ident is not None else threading.get_ident()
        )
        if not slot or not slot[1]:
            return None
        return slot[1][-1][0]

    def progress(self, ident: int) -> int:
        """Span closes observed on thread `ident` — the heartbeat liveness
        counter (a wedged thread's progress freezes even while other
        threads keep the process looking busy)."""
        slot = self._threads.get(ident)
        return slot[2] if slot else 0

    # -- memory sampling -----------------------------------------------------
    def set_memory_sampler(
        self, fn: Optional[Callable[[], Optional[Tuple[float, float]]]]
    ) -> None:
        """Install `fn() -> (bytes_in_use, peak_bytes)` as the span-boundary
        sampler (tests inject a fake; real backends get _device_mem)."""
        self._mem_sampler = fn
        self._mem_probed = True

    def _probe_memory(self) -> None:
        """One-time capability probe, deferred until CUDA is initialised
        (watch never initialises it): without a CUDA device the sampler
        stays None, at no cost a span."""
        if not _cuda_initialized():
            return
        self._mem_probed = True
        try:
            stats = _device_mem()
        except Exception:
            stats = None
        if stats is not None:
            self._mem_sampler = _device_mem

    def phase_memory(self) -> Dict[str, Dict[str, float]]:
        """{span name: {count, peak_bytes, sum_delta_bytes}} — per-phase
        peak-delta attribution accumulated over the process lifetime."""
        with self._mem_lock:
            return {
                k: {"count": v[0], "peak_bytes": v[1], "sum_delta_bytes": v[2]}
                for k, v in self._phase_mem.items()
            }

    def telemetry_memory(self) -> Dict[str, Dict[str, float]]:
        """The mergeable memory section a TelemetrySnapshot carries:
        per-phase attribution under mem.phase.*, device and host watermarks
        under mem.hbm / mem.host.  Merge algebra: count sums, peak_bytes
        maxes, sum_delta_bytes sums (see TelemetrySnapshot.merge)."""
        out: Dict[str, Dict[str, float]] = {}
        for name, d in self.phase_memory().items():
            out[f"mem.phase.{name}"] = d
        dev = None
        try:
            dev = _device_mem() if _cuda_initialized() else None
        except Exception:
            dev = None
        if dev is not None:
            out["mem.hbm"] = {
                "count": 1,
                "peak_bytes": float(dev[1]),
                "sum_delta_bytes": float(dev[0]),
            }
        host = _host_mem()
        if host is not None:
            out["mem.host"] = {
                "count": 1,
                "peak_bytes": float(host[1]),
                "sum_delta_bytes": float(host[0]),
            }
        return out


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _device_mem() -> Optional[Tuple[float, float]]:
    """(bytes allocated, peak bytes allocated) summed over the port's CUDA
    devices, or None without one."""
    import torch

    from . import device as _device

    try:
        devs = {d for d in _device.devices() if d.type == "cuda"}
    except RuntimeError:  # no CUDA device requested or available
        return None
    if not devs:
        return None
    in_use = peak = 0.0
    for d in devs:
        in_use += float(torch.cuda.memory_allocated(d))
        peak += float(torch.cuda.max_memory_allocated(d))
    return in_use, peak


def _host_mem() -> Optional[Tuple[float, float]]:
    """(current RSS bytes, peak RSS bytes) for this process, best-effort."""
    try:
        import resource

        peak = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024.0
    except Exception:
        return None
    cur = 0.0
    try:
        with open("/proc/self/statm") as f:
            cur = float(f.read().split()[1]) * float(os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        cur = peak
    return (cur, peak)


# -- module-level recorder + install ------------------------------------------

_recorder: Optional[FlightRecorder] = None
_install_lock = sanitize.lockdep_lock("watch.install")


def recorder() -> Optional[FlightRecorder]:
    """The installed process-wide recorder (None when SRML_WATCH=0)."""
    return _recorder


def failing_span() -> Optional[str]:
    """The calling thread's innermost FAILING span (the first span that
    closed with an error in flight), falling back to its innermost OPEN
    span, or None without a recorder.  This is what the srml-shield abort
    marker names: when TpuContext.__exit__ broadcasts an abort, surviving
    ranks' RemoteRankError quotes this span — "rank 1 failed in
    exchange.ring" — instead of a bare exception type."""
    err = getattr(_wtls, "err_span", None)
    if err is not None:
        return err
    rec = _recorder
    if rec is None:
        return None
    return rec.innermost()


def install() -> Optional[FlightRecorder]:
    """Install the flight recorder as profiling's span/counter hook and
    register the watch gauges.  Idempotent; called from profiling at import
    time so the recorder is on for every process that touches the package
    (SRML_WATCH=0 opts out)."""
    global _recorder
    with _install_lock:
        if _recorder is not None:
            return _recorder
        if os.environ.get(WATCH_ENV, "1") == "0":
            return None
        _recorder = FlightRecorder()
        profiling._flight = _recorder
        profiling.register_gauges("watch", _watch_gauges)
        return _recorder


def disable() -> None:
    """Detach the recorder (tests / embedders that want the pre-watch
    zero-hook span path).  enable() or install() re-attaches."""
    global _recorder
    with _install_lock:
        profiling._flight = None
        profiling.unregister_gauges("watch")
        _recorder = None


def enable() -> Optional[FlightRecorder]:
    return install()


def _watch_gauges() -> Dict[str, float]:
    """Memory watermarks + flight-recorder and warm-cache gauges for
    export_metrics()/render_prometheus().  Best-effort: a gauge that cannot
    be read is omitted, never raised."""
    out: Dict[str, float] = {}
    host = _host_mem()
    if host is not None:
        out["mem.host.rss_bytes"] = host[0]
        out["mem.host.peak_rss_bytes"] = host[1]
    try:
        dev = _device_mem() if _cuda_initialized() else None
    except Exception:
        dev = None
    if dev is not None:
        out["mem.device.bytes_in_use"] = dev[0]
        out["mem.device.peak_bytes_in_use"] = dev[1]
    rec = _recorder
    if rec is not None:
        out["watch.flight_events"] = float(rec.event_count())
    pre = sys.modules.get("spark_rapids_ml_tpu_torch.ops.precompile")
    if pre is not None:
        out["precompile.warm.entries"] = float(pre.warm_cache_stats()["entries"])
    return out


# -- serving health-plane gauge flattening ------------------------------------
# The ONE rule turning per-server/per-replica health dicts
# (serving/engine.ModelServer.health shape) into gauge keys for the
# srml_health Prometheus family.  ModelRegistry and the srml-router both
# ride it, so a dashboard keyed on health.<name>.* reads a flat registry
# and a replicated router identically — replicas just carry their
# "<model>-r<i>" names, and per-replica restart counts flow as
# health.<name>.restarts (the restart-storm signal per REPLICA, which the
# plane-wide rollup total hides).
def health_gauges(
    models: Dict[str, Dict[str, Any]], prefix: str = "health"
) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, h in models.items():
        out[f"{prefix}.{name}.state_code"] = float(h["state_code"])
        if "attainment" in h:
            out[f"{prefix}.{name}.attainment"] = float(h["attainment"])
            out[f"{prefix}.{name}.burn"] = float(h["burn"])
            out[f"{prefix}.{name}.queued_rows"] = float(h["queued_rows"])
            if h.get("p99_ms") is not None:
                out[f"{prefix}.{name}.p99_ms"] = float(h["p99_ms"])
        if "restarts" in h:
            out[f"{prefix}.{name}.restarts"] = float(h["restarts"])
    return out


# -- flight dump --------------------------------------------------------------

_dump_lock = sanitize.lockdep_lock("watch.dump")
_dump_seq = 0


def dump(tag: str = "flight", path: Optional[str] = None) -> Optional[str]:
    """Write the flight ring (plus every thread's currently-open spans) as
    one Chrome-trace-compatible JSON file: `flight-<tag>-<pid>-<seq>.json`
    under SRML_TRACE_DIR, or to an explicit `path`.  Returns the written
    path, or None when no recorder / no target dir / dump budget spent.
    Best-effort by design — a dump failure is logged, never raised."""
    global _dump_seq
    rec = _recorder
    if rec is None:
        return None
    if path is None:
        out_dir = os.environ.get(profiling.TRACE_ENV)
        if not out_dir:
            return None
        with _dump_lock:
            if _dump_seq >= int(_env_float(MAX_DUMPS_ENV, _DEFAULT_MAX_DUMPS)):
                return None
            _dump_seq += 1
            seq = _dump_seq
        safe = profiling._safe_tag(tag)
        path = os.path.join(
            out_dir, f"flight-{safe}-{os.getpid()}-{seq:04d}.json"
        )
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        doc = _flight_trace_doc(rec)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        profiling.incr_counter("watch.dumps")
        _log.warning("flight recorder dumped %d event(s) -> %s",
                     len(doc["traceEvents"]), path)
        return path
    except Exception as exc:  # noqa: BLE001 - observability never fails work
        _log.warning("flight dump for %r failed: %s", tag, exc)
        return None


def _flight_trace_doc(rec: FlightRecorder) -> Dict[str, Any]:
    """Chrome trace-event document from the ring: closed spans as complete
    ("X") events, counters as counter ("C") events, exceptions as instant
    ("i") events, plus begin ("B") events for every span still OPEN at dump
    time (a hang dump shows where each thread is wedged) and thread_name
    metadata.  Timestamps are microseconds relative to the profiling epoch,
    the same base trace_session exports use."""
    pid = os.getpid()
    epoch = profiling._EPOCH
    tid_of: Dict[int, int] = {}
    names: Dict[int, str] = {}

    def tid(ident: int, tname: Optional[str] = None) -> int:
        t = tid_of.setdefault(ident, len(tid_of) + 1)
        if tname:
            names.setdefault(t, tname)
        return t

    events: List[Dict[str, Any]] = []
    for r in rec.records():
        kind = r[0]
        if kind == "span":
            _, name, t0, t1, ident, tname, depth, error = r
            args: Dict[str, Any] = {"depth": depth}
            if error:
                args["error"] = True
            events.append({
                "name": name, "cat": "srml-watch", "ph": "X",
                "ts": (t0 - epoch) * 1e6, "dur": (t1 - t0) * 1e6,
                "pid": pid, "tid": tid(ident, tname), "args": args,
            })
        elif kind == "ctr":
            _, name, _amount, total, t, ident = r
            events.append({
                "name": name, "cat": "srml-watch", "ph": "C",
                "ts": (t - epoch) * 1e6, "pid": pid, "tid": tid(ident),
                "args": {"value": total},
            })
        elif kind == "exc":
            _, tag, t, ident, tname, etype, msg, failing = r
            events.append({
                "name": "exception", "cat": "srml-watch", "ph": "i",
                "s": "t", "ts": (t - epoch) * 1e6,
                "pid": pid, "tid": tid(ident, tname),
                "args": {
                    "tag": tag, "type": etype, "message": msg,
                    "failing_span": failing,
                },
            })
    # open spans: B events at their open time so the wedged phase renders
    for ident, slot in list(rec._threads.items()):
        th, stack = slot[0], list(slot[1])
        if not th.is_alive():
            continue
        for name, t_open, _mem in stack:
            events.append({
                "name": name, "cat": "srml-watch", "ph": "B",
                "ts": (t_open - epoch) * 1e6,
                "pid": pid, "tid": tid(ident, th.name),
                "args": {"open": True},
            })
    events.sort(key=lambda e: e["ts"])
    meta = [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": t,
         "args": {"name": n}}
        for t, n in sorted(names.items())
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


@contextlib.contextmanager
def flight_scope(tag: str) -> Iterator[None]:
    """Record-and-dump guard for a unit of work: an exception escaping the
    scope is ring-recorded (with the innermost failing span) and triggers a
    flight dump before propagating unchanged.  Wraps every top-level fit
    (core / parallel runner) and the serving dispatch path."""
    try:
        yield
    except BaseException as exc:
        rec = _recorder
        if rec is not None:
            try:
                rec.record_exception(exc, tag)
                dump(tag)
            except Exception:  # noqa: BLE001 - never mask the real error
                pass
        raise


# -- per-rank heartbeats + stall watchdog -------------------------------------


class HeartbeatPublisher:
    """Daemon thread publishing this rank's liveness through the control
    plane every SRML_WATCH_HEARTBEAT_S: payload carries the watched FIT
    thread's innermost open span and its span-close count (progress).  The
    publisher itself staying alive proves nothing — the watchdog keys on
    `progress`, which only the fit thread advances."""

    def __init__(
        self,
        control_plane: Any,
        rank: int,
        watch_ident: Optional[int] = None,
        interval_s: Optional[float] = None,
    ):
        self.cp = control_plane
        self.rank = int(rank)
        self.ident = (
            watch_ident if watch_ident is not None else threading.get_ident()
        )
        self.interval_s = (
            interval_s if interval_s is not None else heartbeat_interval_s()
        )
        self._stop = threading.Event()
        self._seq = 0
        self._thread = threading.Thread(
            target=self._run, name=f"srml-watch-hb-r{self.rank}", daemon=True
        )
        self._thread.start()

    def _payload(self) -> str:
        rec = _recorder
        return json.dumps({
            "rank": self.rank,
            "seq": self._seq,
            "span": rec.innermost(self.ident) if rec is not None else None,
            "progress": rec.progress(self.ident) if rec is not None else 0,
        })

    def _run(self) -> None:
        while True:
            try:
                self._seq += 1
                self.cp.publish_health(self._payload())
            except Exception as exc:  # noqa: BLE001 - observability only
                _log.debug("heartbeat publish failed: %s", exc)
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


class StallWatchdog:
    """Coordinator-side watchdog over control-plane heartbeats: a rank whose
    `progress` counter has not advanced for `stall_s` (or that never
    heartbeats at all) is reported ONCE per stall episode — by rank and by
    the innermost open span its last heartbeat named: a hung collective
    becomes a one-line diagnosis instead of a silent hang; firing also dumps the local flight ring."""

    def __init__(
        self,
        control_plane: Any,
        nranks: int,
        stall_s: Optional[float] = None,
        poll_s: Optional[float] = None,
        on_stall: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.cp = control_plane
        self.nranks = int(nranks)
        self.stall_s = stall_s if stall_s is not None else stall_threshold_s()
        self.poll_s = poll_s if poll_s is not None else max(
            0.05, min(1.0, self.stall_s / 4.0 or 1.0)
        )
        self.on_stall = on_stall
        self.reports: List[Dict[str, Any]] = []
        self._last: Dict[int, Tuple[int, float, Dict[str, Any]]] = {}
        self._fired: Dict[int, bool] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="srml-watch-dog", daemon=True
        )
        self._start_t = profiling.now()
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self._check()
            except Exception as exc:  # noqa: BLE001 - the dog must not die
                _log.debug("watchdog check failed: %s", exc)

    def _check(self) -> None:
        now = profiling.now()
        raw = self.cp.read_health()
        for r in range(self.nranks):
            payload: Dict[str, Any] = {}
            if r in raw:
                try:
                    payload = json.loads(raw[r])
                except (ValueError, TypeError):
                    payload = {}
            progress = int(payload.get("progress", -1))
            prev = self._last.get(r)
            if prev is None or prev[0] != progress:
                self._last[r] = (progress, now, payload)
                self._fired[r] = False
                continue
            age = now - prev[1]
            if age > self.stall_s and not self._fired.get(r):
                self._fired[r] = True
                span = payload.get("span") if payload else None
                report = {
                    "rank": r,
                    "span": span if span else "<no open span>",
                    "age_s": round(age, 3),
                    "reason": (
                        "no heartbeat" if not payload else "progress frozen"
                    ),
                }
                self.reports.append(report)
                profiling.incr_counter("watch.stalls")
                _log.error(
                    "watchdog: rank %d stalled for %.1fs in span %r (%s) — "
                    "dumping flight recorder",
                    r, age, report["span"], report["reason"],
                )
                dump(f"stall-rank{r}")
                if self.on_stall is not None:
                    try:
                        self.on_stall(report)
                    except Exception:  # noqa: BLE001
                        pass

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


class _FitHealth:
    """Handle bundling the per-rank heartbeat publisher and (on rank 0) the
    coordinator's watchdog for one barrier fit; stop() tears both down."""

    def __init__(self, publisher=None, watchdog=None):
        self.publisher = publisher
        self.watchdog = watchdog

    def stop(self) -> None:
        if self.publisher is not None:
            self.publisher.stop()
        if self.watchdog is not None:
            self.watchdog.stop()


def start_fit_health(
    control_plane: Any, rank: int, nranks: int
) -> _FitHealth:
    """Liveness plumbing for one barrier fit task: every rank publishes
    heartbeats (when the control plane supports the non-collective
    publish/read surface), and rank 0 additionally runs the stall watchdog
    when SRML_WATCH_STALL_S > 0.  No-op handle single-controller, when the
    plane is gather-only (live Spark's BarrierTaskContext), or when the
    recorder is off."""
    if (
        nranks <= 1
        or _recorder is None
        or not hasattr(control_plane, "publish_health")
        or heartbeat_interval_s() <= 0
    ):
        return _FitHealth()
    publisher = HeartbeatPublisher(control_plane, rank)
    watchdog = None
    if rank == 0 and stall_threshold_s() > 0 and hasattr(
        control_plane, "read_health"
    ):
        watchdog = StallWatchdog(control_plane, nranks)
    return _FitHealth(publisher, watchdog)


# -- introspection ------------------------------------------------------------


def ring_stats() -> Dict[str, Any]:
    """Flight-recorder self-description: capacity, lifetime events, open
    spans per live thread — the `watch` section of a health report."""
    rec = _recorder
    if rec is None:
        return {"enabled": False}
    return {
        "enabled": True,
        "capacity": rec.cap,
        "events": rec.event_count(),
        "open_spans": {
            name: spans for _i, (name, spans) in rec.open_spans().items()
        },
        "dumps": _dump_seq,
    }


# Self-install at module bottom.  profiling's own bootstrap covers the
# common import order (profiling first), but when THIS module is imported
# first its `from . import profiling` triggers that bootstrap against a
# partially-initialized watch namespace — install() does not exist yet and
# the bootstrap degrades to a warning.  Installing here (idempotent, honors
# SRML_WATCH=0 inside install()) makes the recorder always-on regardless of
# which module the embedding application touches first.
install()
