#
# Process-wide counters, phase timers, duration series, spans and the
# metrics export.
#
# Counterpart of spark_rapids_ml_tpu/profiling.py (this package's own copy):
#   - incr_counter / counter / counters: process-wide monotonic counters (the
#     exchange sections count their calls, bytes and time here, the exact kNN
#     search the exchange route each block took, the serving engine its
#     requests, batches and warm-ups);
#   - phase(name, device): a torch.profiler.record_function range that also
#     adds its wall seconds to phase_times(), the card synchronised at its end
#     so the seconds hold the device work launched inside it (the
#     CrossValidator's stages);
#   - now(): the one monotonic clock of the serving plane;
#   - record_duration / durations / percentiles / duration_digests: bounded
#     per-name duration series (the serving latency surface); series_stats
#     describes the registry's own footprint;
#   - record_event / events: a per-thread ordered event log;
#   - span(name, **attrs): a record_function range that, while a trace
#     session is open, appends one hierarchical record; trace_session(tag)
#     writes those records as the same Chrome trace-event JSON the JAX
#     module writes (under SRML_TRACE_DIR); collect_spans() collects them
#     without a file and span_records() reads them;
#   - TelemetrySnapshot, register_gauges / collect_gauges, export_metrics and
#     render_prometheus: the mergeable rollup and the pull surface;
#   - maybe_trace(tag): the opt-in whole-fit capture, a torch.profiler trace
#     of the region (host ranges, and the card's kernels and copies on a
#     card) written as Chrome trace JSON under $SRML_PROFILE/<tag>; a no-op
#     when the variable is unset.  The JAX module's is an xprof capture;
#   - with_benchmark(name, fn), spread_attribution(phase_runs, median_s) and
#     device_step_annotation(step): the benchmark harness's helpers, the
#     last a record_function range "step <n>" while torch.profiler records
#     (the JAX module's StepTraceAnnotation), a null context otherwise.
# Unlike the JAX module, a span does not add to phase_times(): the port's
# phases are their own ranges, process-wide, and their callers read them as
# such.  The flight recorder of watch.py hooks spans and counters through
# _flight; it is installed at the bottom of this module (SRML_WATCH=0 opts
# out).
#

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

_log = logging.getLogger("spark_rapids_ml_tpu_torch.profiling")

TRACE_ENV = "SRML_TRACE_DIR"
PROFILE_ENV = "SRML_PROFILE"
METRIC_TTL_ENV = "SRML_METRIC_TTL_S"

_lock = threading.Lock()
_counters: Dict[str, int] = {}
_phases: Dict[str, float] = {}
_phase_counts: Dict[str, int] = {}
_tls = threading.local()

# the flight recorder (watch.install sets it); None restores the hook-free
# path
_flight: Optional[Any] = None


def now() -> float:
    """The one monotonic clock (time.perf_counter) of the serving plane."""
    return time.perf_counter()


# perf_counter at import: trace timestamps are relative to it
_EPOCH = time.perf_counter()


# -- counters ----------------------------------------------------------------


def incr_counter(name: str, amount: int = 1) -> None:
    """Add `amount` to the process-wide counter `name` (created at 0)."""
    with _lock:
        total = _counters.get(name, 0) + amount
        _counters[name] = total
    fr = _flight
    if fr is not None:
        fr.on_counter(name, amount, total)


def counter(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def counters(prefix: str = "") -> Dict[str, int]:
    """Snapshot of the counters whose names start with `prefix`."""
    with _lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def counter_deltas(before: Dict[str, int], prefix: str = "") -> Dict[str, int]:
    """Nonzero differences of the current counters against a
    counters(prefix) snapshot."""
    now_ = counters(prefix)
    keys = set(now_) | set(before)
    return {k: now_.get(k, 0) - before.get(k, 0) for k in sorted(keys) if now_.get(k, 0) != before.get(k, 0)}


def reset_counters(prefix: str = "") -> None:
    """Drop the counters whose names start with `prefix`."""
    with _lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            del _counters[k]


# -- phases --------------------------------------------------------------------


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
        _phase_counts[name] = _phase_counts.get(name, 0) + 1


def phase_times() -> Dict[str, float]:
    """Seconds spent in each phase since the last reset_phase_times()."""
    with _lock:
        return dict(_phases)


def phase_stats(prefix: str = "") -> Dict[str, Dict[str, float]]:
    """{name: {"count", "total_s"}} of the phases since the last reset."""
    with _lock:
        return {k: {"count": int(_phase_counts.get(k, 0)), "total_s": float(v)}
                for k, v in _phases.items() if k.startswith(prefix)}


def reset_phase_times() -> None:
    with _lock:
        _phases.clear()
        _phase_counts.clear()


# -- duration series -----------------------------------------------------------
# Capped per name (a ring past the cap), so a long-lived server's latency
# series is a sliding window over recent traffic; lifetime [count, sum, min,
# max] per series stay monotonic for exact snapshot deltas.

_DURATION_CAP = 65536
_TTL_SWEEP_EVERY = 256

_durations_lock = threading.Lock()
_durations: Dict[str, list] = {}
_duration_next: Dict[str, int] = {}
_duration_stats: Dict[str, list] = {}
_duration_touched: Dict[str, float] = {}
_ttl_record_count = 0


def metric_ttl_s() -> float:
    """SRML_METRIC_TTL_S: seconds a duration series may go untouched before
    it is evicted (0, the default, keeps every series)."""
    try:
        return float(os.environ.get(METRIC_TTL_ENV, "") or 0.0)
    except ValueError:
        return 0.0


def _evict_stale_series_locked(ttl: float, now_t: float, keep: str) -> None:
    for k in list(_durations):
        if k == keep:
            continue
        touched = _duration_touched.get(k)
        if touched is None:
            _duration_touched[k] = now_t
        elif now_t - touched > ttl:
            del _durations[k]
            _duration_next.pop(k, None)
            _duration_stats.pop(k, None)
            _duration_touched.pop(k, None)


def record_duration(name: str, seconds: float) -> None:
    """Append one sample (seconds) to the process-wide series `name`."""
    global _ttl_record_count
    s = float(seconds)
    ttl = metric_ttl_s()
    with _durations_lock:
        series = _durations.setdefault(name, [])
        if len(series) < _DURATION_CAP:
            series.append(s)
        else:
            cur = _duration_next.get(name, 0)
            series[cur] = s
            _duration_next[name] = (cur + 1) % _DURATION_CAP
        stats = _duration_stats.get(name)
        if stats is None:
            _duration_stats[name] = [1, s, s, s]
        else:
            stats[0] += 1
            stats[1] += s
            stats[2] = min(stats[2], s)
            stats[3] = max(stats[3], s)
        if ttl > 0:
            now_t = time.perf_counter()
            _duration_touched[name] = now_t
            _ttl_record_count += 1
            if _ttl_record_count % _TTL_SWEEP_EVERY == 0:
                _evict_stale_series_locked(ttl, now_t, keep=name)


def series_stats() -> Dict[str, Any]:
    """The duration registry's own footprint: series count, ring samples,
    estimated resident bytes, the TTL, and each series' ring samples,
    lifetime count and seconds since it was last touched (None where the
    TTL is off) — for a long-lived serving process to watch its metrics."""
    now_t = time.perf_counter()
    with _durations_lock:
        per = {}
        total_samples = 0
        for k, v in _durations.items():
            total_samples += len(v)
            stats = _duration_stats.get(k) or [len(v), 0.0, 0.0, 0.0]
            touched = _duration_touched.get(k)
            per[k] = {
                "ring_samples": len(v),
                "lifetime_count": int(stats[0]),
                "age_s": round(now_t - touched, 3) if touched is not None else None,
            }
        return {
            "series_count": len(per),
            "ring_samples": total_samples,
            "est_bytes": total_samples * 8,
            "ttl_s": metric_ttl_s(),
            "series": per,
        }


def durations(prefix: str = "") -> Dict[str, list]:
    """Copy of every duration series whose name starts with `prefix`."""
    with _durations_lock:
        return {k: list(v) for k, v in _durations.items() if k.startswith(prefix)}


def reset_durations(prefix: str = "") -> None:
    with _durations_lock:
        for k in [k for k in _durations if k.startswith(prefix)]:
            del _durations[k]
            _duration_next.pop(k, None)
            _duration_stats.pop(k, None)
            _duration_touched.pop(k, None)


def percentiles(prefix: str = "") -> Dict[str, float]:
    """count / mean / p50 / p95 / p99 / max over every sample of the series
    whose names start with `prefix`, merged into one distribution ({} when
    there is none); numpy's linear interpolation."""
    merged: list = []
    with _durations_lock:
        for k, v in _durations.items():
            if k.startswith(prefix):
                merged.extend(v)
    return _percentile_digest(merged)


def _percentile_digest(samples: list) -> Dict[str, float]:
    if not samples:
        return {}
    import numpy as np

    arr = np.asarray(samples, dtype=np.float64)
    p50, p95, p99 = np.percentile(arr, [50.0, 95.0, 99.0])
    return {"count": int(arr.size), "mean": float(arr.mean()), "p50": float(p50), "p95": float(p95),
            "p99": float(p99), "max": float(arr.max())}


def duration_digests(prefix: str = "") -> Dict[str, Dict[str, float]]:
    """Mergeable per-series lifetime digests {name: {count, sum_s, min_s,
    max_s}}."""
    with _durations_lock:
        return {k: {"count": s[0], "sum_s": s[1], "min_s": s[2], "max_s": s[3]}
                for k, s in _duration_stats.items() if k.startswith(prefix)}


# -- per-thread ordered event log ----------------------------------------------

_EVENT_CAP = 4096


def _event_log() -> list:
    log = getattr(_tls, "events", None)
    if log is None:
        log = _tls.events = []
    return log


def record_event(name: str, **meta: Any) -> None:
    """Append (name, meta) to this thread's event log (dropped past the
    cap)."""
    log = _event_log()
    if len(log) < _EVENT_CAP:
        log.append((name, meta))


def events(prefix: str = "") -> list:
    """This thread's events in record order, optionally prefix-filtered."""
    return [(n, m) for n, m in _event_log() if n.startswith(prefix)]


def reset_events() -> None:
    _event_log().clear()


# -- hierarchical spans -----------------------------------------------------------
# While a trace session is open every completed span appends one record
# (name, t0, t1, thread ident, thread name, span id, parent id, attrs) to a
# bounded process-wide buffer; with none open a span is its record_function
# range and the flight recorder's two ring events.

_TRACE_CAP = 131072

_trace_lock = threading.Lock()
_trace_records: List[tuple] = []
_collect_depth = 0
_span_ids = itertools.count(1)
_session_seq = itertools.count(1)


class _SpanHandle:
    """Yielded by span(): set(**kv) attaches attributes to the record (a
    no-op when no session collects)."""

    __slots__ = ("attrs",)

    def __init__(self, attrs: Optional[Dict[str, Any]]):
        self.attrs = attrs

    def set(self, **kv: Any) -> None:
        if self.attrs is not None:
            self.attrs.update(kv)


_NULL_SPAN = _SpanHandle(None)


def _span_stack() -> list:
    stack = getattr(_tls, "span_stack", None)
    if stack is None:
        stack = _tls.span_stack = []
    return stack


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[_SpanHandle]:
    """A named range: a torch.profiler record_function range (so a profiler
    trace carries the name) plus, while a trace session is open, one span
    record with its parent and `attrs`."""
    from torch.profiler import record_function

    collecting = _collect_depth > 0
    if collecting:
        sid = next(_span_ids)
        stack = _span_stack()
        parent = stack[-1] if stack else 0
        stack.append(sid)
        handle = _SpanHandle(dict(attrs))
    else:
        handle = _NULL_SPAN
    fr = _flight
    if fr is not None:
        fr.on_span_open(name)
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield handle
    finally:
        t1 = time.perf_counter()
        if collecting:
            stack.pop()
            th = threading.current_thread()
            with _trace_lock:
                if len(_trace_records) < _TRACE_CAP:
                    _trace_records.append((name, t0, t1, th.ident, th.name, sid, parent, handle.attrs))
        if fr is not None:
            fr.on_span_close(name, t0, t1, sys.exc_info()[0] is not None)


def span_records() -> List[tuple]:
    """Copy of the collected span records (name, t0, t1, thread ident,
    thread name, span id, parent id, attrs)."""
    with _trace_lock:
        return list(_trace_records)


@contextlib.contextmanager
def collect_spans() -> Iterator[None]:
    """Collect span records for the enclosed region without writing a
    trace file (trace_session adds the file).  Reentrant; the buffer clears
    when the last collecting scope exits."""
    global _collect_depth
    with _trace_lock:
        _collect_depth += 1
    try:
        yield
    finally:
        with _trace_lock:
            _collect_depth -= 1
            if _collect_depth == 0:
                _trace_records.clear()


def _safe_tag(tag: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "-" for c in tag)


def _write_chrome_trace(path: str, records: List[tuple]) -> None:
    """Span records as Chrome trace-event JSON: one complete ("X") event per
    span, microseconds from the module's epoch, and thread_name metadata."""
    pid = os.getpid()
    tid_of: Dict[int, int] = {}
    names: Dict[int, str] = {}
    events_out: List[Dict[str, Any]] = []
    for name, t0, t1, ident, tname, sid, parent, attrs in records:
        tid = tid_of.setdefault(ident, len(tid_of) + 1)
        names.setdefault(tid, tname)
        args: Dict[str, Any] = {"span_id": sid}
        if parent:
            args["parent_id"] = parent
        if attrs:
            args.update(attrs)
        events_out.append({"name": name, "cat": "srml", "ph": "X", "ts": (t0 - _EPOCH) * 1e6,
                           "dur": (t1 - t0) * 1e6, "pid": pid, "tid": tid, "args": args})
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": tname}}
            for tid, tname in sorted(names.items())]
    doc = {"traceEvents": meta + events_out, "displayTimeUnit": "ms"}
    tmp = f"{path}.tmp{pid}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


@contextlib.contextmanager
def trace_session(tag: str = "session") -> Iterator[Optional[str]]:
    """Collect spans for the enclosed region and write them as one Chrome
    trace-event JSON file under $SRML_TRACE_DIR, yielding its path; yields
    None and collects nothing when the variable is unset or the directory
    is not writable."""
    out_dir = os.environ.get(TRACE_ENV)
    if not out_dir:
        yield None
        return
    try:
        os.makedirs(out_dir, exist_ok=True)
    except OSError as exc:
        _log.warning("%s=%r is not writable (%s); tracing disabled for %r", TRACE_ENV, out_dir, exc, tag)
        yield None
        return
    path = os.path.join(out_dir, f"{_safe_tag(tag)}-{os.getpid()}-{next(_session_seq):04d}.trace.json")
    global _collect_depth
    with _trace_lock:
        _collect_depth += 1
    t_start = time.perf_counter()
    try:
        yield path
    finally:
        with _trace_lock:
            records = [r for r in _trace_records if r[1] >= t_start]
            _collect_depth -= 1
            if _collect_depth == 0:
                _trace_records.clear()
        try:
            _write_chrome_trace(path, records)
        except Exception as exc:  # noqa: BLE001 - the export never replaces the work's result
            _log.warning("trace export for %r failed: %s", tag, exc)


@contextlib.contextmanager
def maybe_trace(tag: str = "fit") -> Iterator[None]:
    """With SRML_PROFILE=<dir> set, capture the enclosed region with
    torch.profiler (the CPU, and the card when there is one) and write it
    as one Chrome trace JSON file under <dir>/<tag>.  A no-op otherwise."""
    out_dir = os.environ.get(PROFILE_ENV)
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    target = os.path.join(out_dir, _safe_tag(tag))
    os.makedirs(target, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(target, f"{os.getpid()}-{next(_session_seq):04d}.pt.trace.json")
    prof.export_chrome_trace(path)
    _log.info("torch.profiler trace for %r written to %s", tag, path)


def with_benchmark(name: str, fn: Callable[[], Any]) -> Tuple[Any, float]:
    """Run fn and return (its result, elapsed seconds), logging the time."""
    t0 = time.perf_counter()
    result = fn()
    dt = time.perf_counter() - t0
    _log.info("-" * 100)
    _log.info("%s took: %s sec", name, dt)
    return result, dt


def device_step_annotation(step: int) -> contextlib.AbstractContextManager:
    """A torch.profiler range "step <step>" around one iteration of a
    benchmark loop while the profiler records; a null context otherwise."""
    import torch

    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(f"step {int(step)}")


def spread_attribution(
    phase_runs: List[Dict[str, float]],
    median_s: float,
    floor_pct: float = 1.0,
    top: int = 5,
) -> Dict[str, float]:
    """Attribute a spread of repeated timings to phases: for each phase
    name across `phase_runs` (one phase_times() dict a timed repeat), its
    max - min as a percentage of the median run `median_s`, rounded to 0.1.
    Phases under `floor_pct` are dropped and the `top` largest kept,
    largest first."""
    if len(phase_runs) < 2 or median_s <= 0:
        return {}
    names = set().union(*(set(p) for p in phase_runs))
    out = {}
    for n in names:
        vals = [float(p.get(n, 0.0)) for p in phase_runs]
        pct = 100.0 * (max(vals) - min(vals)) / median_s
        if pct >= floor_pct:
            out[n] = round(pct, 1)
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


# -- mergeable telemetry snapshots -------------------------------------------------


class TelemetrySnapshot:
    """Serializable rollup of phase stats, counters, duration digests and
    memory watermarks.  merge() is associative and commutative (sums, mins,
    maxes); delta(since) is what moved between two snapshots."""

    __slots__ = ("phases", "counters", "durations", "memory", "meta")

    def __init__(
        self,
        phases: Optional[Dict[str, Dict[str, float]]] = None,
        counters: Optional[Dict[str, int]] = None,
        durations: Optional[Dict[str, Dict[str, float]]] = None,
        memory: Optional[Dict[str, Dict[str, float]]] = None,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.phases = dict(phases or {})
        self.counters = dict(counters or {})
        self.durations = dict(durations or {})
        self.memory = dict(memory or {})
        self.meta = dict(meta or {})
        self.meta.setdefault("ranks", [])

    @classmethod
    def capture(
        cls,
        counters_before: Optional[Dict[str, int]] = None,
        counter_prefix: str = "",
        duration_prefix: Optional[str] = None,
        rank: Optional[int] = None,
    ) -> "TelemetrySnapshot":
        """The phase stats, the counters (the delta against
        `counters_before` when given), the duration digests under
        `duration_prefix`, and the flight recorder's memory section."""
        ctr = counter_deltas(counters_before, counter_prefix) if counters_before is not None \
            else counters(counter_prefix)
        dur = duration_digests(duration_prefix) if duration_prefix is not None else {}
        mem: Dict[str, Dict[str, float]] = {}
        fr = _flight
        if fr is not None:
            try:
                mem = fr.telemetry_memory()
            except Exception:  # noqa: BLE001 - observability never fails the work
                mem = {}
        return cls(phases=phase_stats(), counters=ctr, durations=dur, memory=mem,
                   meta={"ranks": [int(rank)] if rank is not None else []})

    def merge(self, other: "TelemetrySnapshot") -> "TelemetrySnapshot":
        phases: Dict[str, Dict[str, float]] = {}
        for src in (self.phases, other.phases):
            for k, v in src.items():
                agg = phases.setdefault(k, {"count": 0, "total_s": 0.0})
                agg["count"] += int(v.get("count", 0))
                agg["total_s"] += float(v.get("total_s", 0.0))
        ctr: Dict[str, int] = dict(self.counters)
        for k, v in other.counters.items():
            ctr[k] = ctr.get(k, 0) + v
        dur: Dict[str, Dict[str, float]] = {}
        for src in (self.durations, other.durations):
            for k, v in src.items():
                agg = dur.get(k)
                if agg is None:
                    dur[k] = dict(v)
                else:
                    agg["count"] += v["count"]
                    agg["sum_s"] += v["sum_s"]
                    agg["min_s"] = min(agg["min_s"], v["min_s"])
                    agg["max_s"] = max(agg["max_s"], v["max_s"])
        mem: Dict[str, Dict[str, float]] = {}
        for src in (self.memory, other.memory):
            for k, v in src.items():
                agg = mem.get(k)
                if agg is None:
                    mem[k] = dict(v)
                else:
                    agg["count"] += v.get("count", 0)
                    agg["peak_bytes"] = max(agg.get("peak_bytes", 0.0), v.get("peak_bytes", 0.0))
                    agg["sum_delta_bytes"] = agg.get("sum_delta_bytes", 0.0) + v.get("sum_delta_bytes", 0.0)
        meta = {"ranks": sorted(set(self.meta.get("ranks", [])) | set(other.meta.get("ranks", [])))}
        return TelemetrySnapshot(phases=phases, counters=ctr, durations=dur, memory=mem, meta=meta)

    def delta(self, since: "TelemetrySnapshot") -> "TelemetrySnapshot":
        """Counter differences (unchanged keys dropped) and count / sum
        duration deltas; min / max keep the current extremes."""
        ctr = {k: v - since.counters.get(k, 0) for k, v in self.counters.items() if v != since.counters.get(k, 0)}
        dur: Dict[str, Dict[str, float]] = {}
        for k, d in self.durations.items():
            prev = since.durations.get(k)
            if prev is None:
                dur[k] = dict(d)
                continue
            dc = d["count"] - prev["count"]
            if dc > 0:
                dur[k] = {"count": dc, "sum_s": d["sum_s"] - prev["sum_s"], "min_s": d["min_s"], "max_s": d["max_s"]}
        return TelemetrySnapshot(counters=ctr, durations=dur)

    def phase_seconds(self, prefix: str = "") -> Dict[str, float]:
        return {k: float(v.get("total_s", 0.0)) for k, v in self.phases.items() if k.startswith(prefix)}

    def to_dict(self) -> Dict[str, Any]:
        return {"schema": "srml-scope/v1", "phases": self.phases, "counters": self.counters,
                "durations": self.durations, "memory": self.memory, "meta": self.meta}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TelemetrySnapshot":
        return cls(phases=d.get("phases"), counters=d.get("counters"), durations=d.get("durations"),
                   memory=d.get("memory"), meta=d.get("meta"))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, TelemetrySnapshot) and self.to_dict() == other.to_dict()

    def __repr__(self) -> str:
        return (f"TelemetrySnapshot(phases={len(self.phases)}, counters={len(self.counters)}, "
                f"durations={len(self.durations)}, ranks={self.meta.get('ranks', [])})")


# -- export surface -------------------------------------------------------------------
# Gauge providers: named callables returning {gauge name: float}, sampled at
# export time (memory watermarks, serving health, slice-pool capacity).

_gauges_lock = threading.Lock()
_gauge_providers: Dict[str, Callable[[], Dict[str, float]]] = {}


def register_gauges(key: str, fn: Callable[[], Dict[str, float]]) -> None:
    """Register (or replace) gauge provider `key`."""
    with _gauges_lock:
        _gauge_providers[key] = fn


def unregister_gauges(key: str) -> None:
    with _gauges_lock:
        _gauge_providers.pop(key, None)


def collect_gauges(prefix: str = "") -> Dict[str, float]:
    """Sample every gauge provider; a provider that raises is skipped."""
    with _gauges_lock:
        providers = list(_gauge_providers.values())
    out: Dict[str, float] = {}
    for fn in providers:
        try:
            sampled = fn()
        except Exception:  # noqa: BLE001 - export over a sick subsystem
            continue
        for k, v in sampled.items():
            if k.startswith(prefix):
                try:
                    out[k] = float(v)
                except (TypeError, ValueError):
                    continue
    return dict(sorted(out.items()))


def export_metrics(prefix: str = "") -> Dict[str, Any]:
    """One JSON document: counters, per-series percentile digests, phase
    stats and sampled gauges, optionally prefix-filtered."""
    with _durations_lock:
        series = {k: list(v) for k, v in _durations.items() if k.startswith(prefix)}
    return {
        "schema": "srml-scope/v1",
        "counters": counters(prefix),
        "durations": {k: _percentile_digest(v) for k, v in series.items()},
        "phases": phase_stats(prefix),
        "gauges": collect_gauges(prefix),
    }


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"')


def render_prometheus(metrics: Optional[Dict[str, Any]] = None) -> str:
    """Prometheus text exposition of export_metrics(): the same families and
    labels as the JAX module's."""
    m = metrics if metrics is not None else export_metrics()
    lines = ["# TYPE srml_counter counter"]
    for k, v in sorted(m.get("counters", {}).items()):
        lines.append(f'srml_counter{{name="{_prom_escape(k)}"}} {v}')
    lines.append("# TYPE srml_phase_seconds_total counter")
    lines.append("# TYPE srml_phase_count_total counter")
    for k, v in sorted(m.get("phases", {}).items()):
        n = _prom_escape(k)
        lines.append(f'srml_phase_seconds_total{{name="{n}"}} {v["total_s"]}')
        lines.append(f'srml_phase_count_total{{name="{n}"}} {v["count"]}')
    lines.append("# TYPE srml_duration_seconds summary")
    for k, d in sorted(m.get("durations", {}).items()):
        if not d:
            continue
        n = _prom_escape(k)
        for q_label, q_key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(f'srml_duration_seconds{{name="{n}",quantile="{q_label}"}} {d[q_key]}')
        lines.append(f'srml_duration_seconds_sum{{name="{n}"}} {d["mean"] * d["count"]}')
        lines.append(f'srml_duration_seconds_count{{name="{n}"}} {d["count"]}')
    gauges = m.get("gauges", {})
    if gauges:
        fams: Dict[str, list] = {"srml_memory_bytes": [], "srml_health": [], "srml_router": [],
                                 "srml_elastic": [], "srml_gauge": []}
        link_entries = []
        for k, v in sorted(gauges.items()):
            if k.startswith("exchange.link."):
                link_entries.append((k[len("exchange.link."):].removesuffix("_bytes"), v))
            elif k.startswith("mem."):
                fams["srml_memory_bytes"].append((k, v))
            elif k.startswith("health."):
                fams["srml_health"].append((k, v))
            elif k.startswith("router."):
                fams["srml_router"].append((k, v))
            elif k.startswith(("slicepool.", "autoscale.")):
                fams["srml_elastic"].append((k, v))
            else:
                fams["srml_gauge"].append((k, v))
        if link_entries:
            lines.append("# TYPE srml_exchange_bytes gauge")
            for link, v in link_entries:
                lines.append(f'srml_exchange_bytes{{link="{_prom_escape(link)}"}} {v}')
        for fam, entries in fams.items():
            if not entries:
                continue
            lines.append(f"# TYPE {fam} gauge")
            for k, v in entries:
                lines.append(f'{fam}{{name="{_prom_escape(k)}"}} {v}')
    return "\n".join(lines) + "\n"


# -- the flight recorder ------------------------------------------------------------
# Installed at the bottom, so watch's `from . import profiling` sees a whole
# namespace.


def _bootstrap_watch() -> None:
    if os.environ.get("SRML_WATCH", "1") == "0":
        return
    from . import watch

    watch.install()


_bootstrap_watch()
