# The port's health plane (spark_rapids_ml_tpu_torch.watch and the export
# surface of its profiling module) against the JAX package's, on the CPU:
# the scenarios of tests/test_watch.py that need no control plane of the
# runner (the stall watchdog runs over a small in-memory plane here), the
# Prometheus rendering and snapshot algebra on the same inputs, and the
# port's own rule that watch never initialises CUDA.
import json
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu import watch as ref_watch

import spark_rapids_ml_tpu_torch.serving as port_serving
from spark_rapids_ml_tpu_torch import profiling, watch
from spark_rapids_ml_tpu_torch.device import use_device

PAIRS = {"jax": (ref_profiling, ref_watch), "port": (profiling, watch)}


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture
def fresh_recorder():
    prev = profiling._flight
    rec = watch.FlightRecorder(cap=64)
    profiling._flight = rec
    try:
        yield rec
    finally:
        profiling._flight = prev


class Echo:
    def __init__(self, n_cols=4):
        self.n_cols = n_cols
        self.block = threading.Event()
        self.release = threading.Event()

    def _serving_entry(self, mesh=None):
        def call(batch):
            if self.block.is_set():
                assert self.release.wait(30.0)
            return {"echo": batch.sum(axis=1)}

        return port_serving.ServingEntry(name="serve.echo", n_cols=self.n_cols, dtype=np.dtype(np.float32),
                                         out_cols=["echo"], call=call, warm=lambda b: [])


def _until(pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while not pred() and time.monotonic() < deadline:
        threading.Event().wait(0.01)
    return pred()


def test_flight_recorder_always_on_without_any_session(fresh_recorder):
    rec = fresh_recorder
    with profiling.span("w.outer"):
        with profiling.span("w.inner"):
            profiling.incr_counter("w.ctr", 3)
    kinds = [r[0] for r in rec.records()]
    assert kinds == ["ctr", "span", "span"]
    assert rec.records()[0][1:3] == ("w.ctr", 3)
    inner, outer = rec.records()[1], rec.records()[2]
    assert (inner[1], inner[6], outer[1], outer[6]) == ("w.inner", 1, "w.outer", 0)
    assert not inner[7] and not outer[7]


def test_flight_ring_is_bounded(fresh_recorder):
    rec = fresh_recorder
    for _ in range(rec.cap * 2):
        profiling.incr_counter("w.ring", 1)
    recs = rec.records()
    assert len(recs) == rec.cap and rec.event_count() == rec.cap * 2
    assert recs[0][3] - recs[-1][3] == 1 - rec.cap


def test_open_spans_and_innermost_cross_thread(fresh_recorder):
    rec = fresh_recorder
    entered, release = threading.Event(), threading.Event()

    def wedged():
        with profiling.span("w.fit"):
            with profiling.span("w.fit.collective"):
                entered.set()
                release.wait(10.0)

    th = threading.Thread(target=wedged, name="w-wedged")
    th.start()
    try:
        assert entered.wait(10.0)
        spans = {name: stack for name, stack in rec.open_spans().values()}
        assert spans.get("w-wedged") == ["w.fit", "w.fit.collective"]
        assert rec.innermost(th.ident) == "w.fit.collective" and rec.progress(th.ident) == 0
    finally:
        release.set()
        th.join(timeout=10.0)
    assert not th.is_alive() and rec.progress(th.ident) == 2


def test_ring_cap_clamps_to_one_never_crashes():
    rec = watch.FlightRecorder(cap=0)
    assert rec.cap == 1
    prev = profiling._flight
    profiling._flight = rec
    try:
        with profiling.span("w.tiny"):
            profiling.incr_counter("w.tiny.ctr")
    finally:
        profiling._flight = prev
    assert rec.event_count() == 2 and len(rec.records()) == 1


@pytest.mark.parametrize("first", ["watch", "profiling"])
def test_recorder_installs_regardless_of_import_order(first):
    other = "profiling" if first == "watch" else "watch"
    code = (f"import spark_rapids_ml_tpu_torch.{first}; import spark_rapids_ml_tpu_torch.{other}; "
            "from spark_rapids_ml_tpu_torch import profiling, watch; import torch; "
            "assert watch.recorder() is not None and profiling._flight is watch.recorder(); "
            "assert not torch.cuda.is_initialized(); print('installed')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "installed" in out.stdout


def test_disabled_recorder_restores_the_hook_free_path(monkeypatch):
    monkeypatch.setattr(profiling, "_flight", None)
    with profiling.span("w.off"):
        profiling.incr_counter("w.off.ctr")
    assert profiling._flight is None


def test_flight_dump_noop_without_trace_dir(monkeypatch):
    monkeypatch.delenv(profiling.TRACE_ENV, raising=False)
    assert watch.dump("w-none") is None


def test_worker_death_dumps_flight_with_the_exception_last(monkeypatch, tmp_path):
    from spark_rapids_ml_tpu_torch.parallel import faults

    monkeypatch.setenv(profiling.TRACE_ENV, str(tmp_path))
    monkeypatch.setenv(faults.FAULTS_ENV, "serving.dispatch:tag=w_died:call=1:action=kill")
    faults.reload()
    try:
        srv = port_serving.ModelServer("w_died", Echo(), max_batch=4, max_wait_ms=1)
        try:
            with pytest.raises(port_serving.ServerRecovering):
                srv.predict(np.ones(4, np.float32))
        finally:
            srv.shutdown(drain=False)
    finally:
        monkeypatch.delenv(faults.FAULTS_ENV)
        faults.reload()
    dumps = sorted(tmp_path.glob("flight-serve-died-w_died-*.json"))
    assert dumps
    events = json.loads(dumps[0].read_text())["traceEvents"]
    last = [e for e in events if e.get("ph") != "M"][-1]
    assert last["name"] == "exception" and last["args"]["type"] == "InjectedWorkerDeath"


class _MemoryPlane:
    """Heartbeat surface of a control plane (publish_health / read_health),
    one view a rank over a shared dict."""

    def __init__(self, board, rank):
        self.board, self.rank = board, rank

    def publish_health(self, payload):
        self.board[self.rank] = payload

    def read_health(self):
        return dict(self.board)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_watchdog_names_the_stuck_rank_and_its_innermost_span(pkg):
    prof, w = PAIRS[pkg]
    board = {}
    done, entered, release = threading.Event(), threading.Event(), threading.Event()

    def rank0():
        hb = w.HeartbeatPublisher(_MemoryPlane(board, 0), 0, interval_s=0.05)
        try:
            while not done.wait(0.01):
                with prof.span("fit.work"):
                    pass
        finally:
            hb.stop()

    def rank1():
        hb = w.HeartbeatPublisher(_MemoryPlane(board, 1), 1, interval_s=0.05)
        try:
            with prof.span("runner.fit"):
                with prof.span("fit.wedge.block"):
                    entered.set()
                    release.wait(30.0)
        finally:
            hb.stop()

    threads = [threading.Thread(target=rank0), threading.Thread(target=rank1)]
    for t in threads:
        t.start()
    dog = None
    try:
        assert entered.wait(10.0)
        reports = []
        dog = w.StallWatchdog(_MemoryPlane(board, 0), nranks=2, stall_s=0.5, poll_s=0.1, on_stall=reports.append)
        assert _until(lambda: bool(reports))
        assert (reports[0]["rank"], reports[0]["span"], reports[0]["reason"]) == (1, "fit.wedge.block",
                                                                                  "progress frozen")
        assert all(r["rank"] == 1 for r in dog.reports)
    finally:
        if dog is not None:
            dog.stop()
        done.set()
        release.set()
        for t in threads:
            t.join(timeout=10.0)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_start_fit_health_noops_when_unsupported(pkg):
    _prof, w = PAIRS[pkg]

    class GatherOnlyPlane:
        def allGather(self, message):
            return [message]

    h = w.start_fit_health(GatherOnlyPlane(), rank=0, nranks=2)
    assert h.publisher is None and h.watchdog is None
    h.stop()
    assert w.start_fit_health(object(), rank=0, nranks=1).publisher is None


def test_phase_memory_attribution_with_injected_sampler(fresh_recorder):
    rec = fresh_recorder
    samples = iter([(100.0, 100.0), (150.0, 400.0)])
    rec.set_memory_sampler(lambda: next(samples, (150.0, 400.0)))
    with profiling.span("w.mem.phase"):
        pass
    mem = rec.phase_memory()["w.mem.phase"]
    assert (mem["count"], mem["peak_bytes"], mem["sum_delta_bytes"]) == (1, 400.0, 300.0)
    telem = rec.telemetry_memory()
    assert telem["mem.phase.w.mem.phase"]["peak_bytes"] == 400.0 and "mem.host" in telem


def test_telemetry_snapshots_merge_as_in_jax():
    parts = [
        dict(phases={"p": {"count": 1, "total_s": 0.5}}, counters={"c": 2},
             durations={"d": {"count": 2, "sum_s": 0.3, "min_s": 0.1, "max_s": 0.2}},
             memory={"mem.hbm": {"count": 1, "peak_bytes": 70.0, "sum_delta_bytes": 30.0}}, meta={"ranks": [0]}),
        dict(phases={"p": {"count": 2, "total_s": 1.5}, "q": {"count": 1, "total_s": 0.1}}, counters={"c": 1, "e": 4},
             durations={"d": {"count": 1, "sum_s": 0.4, "min_s": 0.4, "max_s": 0.4}},
             memory={"mem.hbm": {"count": 2, "peak_bytes": 50.0, "sum_delta_bytes": 25.0}}, meta={"ranks": [1]}),
    ]
    out = {}
    for name, (prof, _w) in PAIRS.items():
        a, b = (prof.TelemetrySnapshot(**p) for p in parts)
        m = a.merge(b)
        assert m == b.merge(a)
        assert prof.TelemetrySnapshot.from_dict(json.loads(json.dumps(m.to_dict()))) == m
        out[name] = (m.to_dict(), m.delta(a).to_dict(), m.phase_seconds())
    assert out["port"] == out["jax"]


def test_prometheus_rendering_matches_jax():
    metrics = {
        "counters": {"serving.a.requests": 3, 'x."q"': 1},
        "phases": {"fit": {"count": 2, "total_s": 1.25}},
        "durations": {"serve.a.latency": {"count": 4, "mean": 0.01, "p50": 0.009, "p95": 0.02, "p99": 0.03,
                                          "max": 0.04}, "empty": {}},
        "gauges": {"mem.host.rss_bytes": 1e9, "health.a.state_code": 1.0, "router.m.replicas": 2.0,
                   "slicepool.free": 1.0, "exchange.link.ici_bytes": 10.0, "precompile.warm.entries": 3.0},
    }
    assert profiling.render_prometheus(metrics) == ref_profiling.render_prometheus(metrics)
    assert watch.health_gauges({"m": {"state_code": 0, "attainment": 0.5, "burn": 0.5, "queued_rows": 3,
                                      "p99_ms": 12.5, "restarts": 2}, "bare": {"state_code": 4}}) == \
        ref_watch.health_gauges({"m": {"state_code": 0, "attainment": 0.5, "burn": 0.5, "queued_rows": 3,
                                       "p99_ms": 12.5, "restarts": 2}, "bare": {"state_code": 4}})


def test_duration_percentiles_match_jax():
    samples = [0.003, 0.001, 0.002, 0.010, 0.004]
    got = {}
    for name, (prof, _w) in PAIRS.items():
        prof.reset_durations("w.pct.")
        for s in samples:
            prof.record_duration("w.pct.a", s)
        got[name] = (prof.percentiles("w.pct."), prof.duration_digests("w.pct."))
    assert got["port"] == got["jax"]


def test_trace_session_writes_chrome_trace(monkeypatch, tmp_path):
    monkeypatch.setenv(profiling.TRACE_ENV, str(tmp_path))
    with profiling.trace_session("w-sess") as path:
        with profiling.span("w.parent", rows=3):
            with profiling.span("w.child"):
                pass
    doc = json.loads(open(path).read())
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert spans["w.child"]["args"]["parent_id"] == spans["w.parent"]["args"]["span_id"]
    assert spans["w.parent"]["args"]["rows"] == 3
    assert profiling._collect_depth == 0


def test_server_lifecycle_states_and_slo_health(monkeypatch):
    with port_serving.ModelServer("w_slo", Echo(), max_batch=16, max_wait_ms=1) as srv:
        assert srv.state() == port_serving.READY
        for _ in range(8):
            srv.predict(np.ones(4, np.float32))
        monkeypatch.setenv("SRML_SERVE_SLO_MS", "60000")
        h = srv.health()
        assert (h["state"], h["attainment"], h["burn"]) == ("READY", 1.0, 0.0)
        assert h["window_count"] >= 8 and h["p99_ms"] is not None
        monkeypatch.setenv("SRML_SERVE_SLO_MS", "0.000001")
        h = srv.health()
        assert h["state"] == "DEGRADED" and h["burn"] > 0.9
        monkeypatch.delenv("SRML_SERVE_SLO_MS")
        assert srv.health()["attainment"] == 1.0
        srv.drain()
        assert srv.state() == port_serving.DRAINING


def test_wedged_server_flips_unhealthy_and_sheds_then_recovers(monkeypatch):
    monkeypatch.setenv("SRML_SERVE_MAX_RESTARTS", "0")
    model = Echo()
    srv = port_serving.ModelServer("w_wedge", model, max_batch=16, max_wait_ms=1)
    try:
        model.block.set()
        monkeypatch.setenv("SRML_WATCH_STALL_S", "0.2")
        fut = srv.submit(np.ones(4, np.float32))
        assert _until(lambda: srv.state() == port_serving.UNHEALTHY)
        with pytest.raises(port_serving.ServerUnhealthy):
            srv.submit(np.ones(4, np.float32))
        assert profiling.counter("serving.w_wedge.unhealthy") >= 1
        model.release.set()
        assert fut.result(timeout=30.0)["echo"][0] == 4.0
        assert _until(lambda: srv.state() == port_serving.READY)
        assert profiling.counter("serving.w_wedge.recovered") >= 1
    finally:
        model.release.set()
        monkeypatch.setenv("SRML_WATCH_STALL_S", "0")
        srv.shutdown(drain=False)


def test_registry_health_export_and_prometheus_round_trip():
    with port_serving.ModelRegistry(max_batch=16, max_wait_ms=1) as reg:
        reg.register("w_rt", Echo())
        reg.get("w_rt").predict(np.ones(4, np.float32))
        h = reg.health()
        assert h["state"] == "READY" and h["models"]["w_rt"]["attainment"] >= 0
        m = profiling.export_metrics()
        assert json.loads(json.dumps(m)) == m
        g = m["gauges"]
        assert g["health.w_rt.state_code"] == 1.0 and any(k.startswith("mem.host.") for k in g)
        txt = profiling.render_prometheus(m)
        assert "# TYPE srml_health gauge" in txt and "# TYPE srml_memory_bytes gauge" in txt
        assert 'srml_health{name="health.w_rt.state_code"} 1.0' in txt
    assert not any(k.startswith("health.w_rt.") for k in profiling.export_metrics()["gauges"])
    assert port_serving.ModelRegistry().health()["state"] == "WARMING"


def test_ring_stats_and_device_memory_without_cuda():
    stats = watch.ring_stats()
    assert stats["enabled"] is True and stats["capacity"] > 0 and isinstance(stats["open_spans"], dict)
    assert watch._device_mem() is None  # the CPU device list: nothing to sample
    assert "mem.device.bytes_in_use" not in watch._watch_gauges()
    assert not torch.cuda.is_initialized()
