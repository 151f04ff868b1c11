"""The metric readers' arithmetic on fixed runs and traces, the null of an
incomplete trace included."""

from types import SimpleNamespace

import pytest

from portbench import cell, peaks
from portbench.trace import Trace

KNN_CFG = {"data": {"rows": 400_000, "cols": 3000}, "params": {"k": 200}}
KM_CFG = {"data": {"rows": 1_000_000, "cols": 3000}, "params": {"k": 1000}}


def read(name, **kw):
    base = dict(calls=[], window_s=1.0, setup_s=0.0, counters={}, launches={}, trace=None, config=KNN_CFG)
    return cell.metric_reader(name).read(SimpleNamespace(**{**base, **kw}))


def trace(device, host=(), window=(0.0, 100.0), counted=0, port=None):
    return Trace(window=window, device=list(device), host=list(host), launches_counted=counted,
                 port_events=port or {})


def test_busy_union_and_idle_share():
    t = trace([("k1", -5.0, 10.0), ("k2", 5.0, 20.0), ("Memcpy HtoD", 40.0, 50.0), ("k3", 90.0, 120.0)])
    assert t.busy_us == pytest.approx(20.0 + 10.0 + 10.0)
    for name in ("device_idle_share.fit", "device_idle_share.knn_batch", "device_idle_share.knn_online"):
        assert read(name, trace=t) == pytest.approx(60.0)


def test_incomplete_trace_reads_nothing():
    t = trace([("k", 0.0, 50.0)], counted=2, port={"knn_topm_tile_kernel": [50.0]})
    assert not t.complete
    assert read("device_idle_share.knn_batch", trace=t) is None
    assert read("b5_roofline", trace=t, calls=[{"ok": True, "rows": 16384}]) is None
    assert read("device_idle_share.fit", trace=None) is None


def test_b5_roofline_from_launch_shapes():
    # two launches of 8,192 queries, 450 ms each: 2 * 8192 * 400000 * 3000
    # operations over 67 TFLOP/s is 293.4 ms a launch
    t = trace([], counted=2, port={"knn_topm_tile_kernel": [450e3, 450e3]})
    got = read("b5_roofline", trace=t, calls=[{"ok": True, "rows": 16384}])
    bound = 2.0 * 8192 * 400_000 * 3000 / peaks.FP32_FLOPS
    assert got == pytest.approx(100.0 * bound / 0.450)
    assert 65.0 < got < 65.3
    assert read("b5_roofline.online", trace=t, calls=[{"ok": True, "rows": 16384}]) == got
    assert read("b5_roofline", trace=trace([], port={})) is None


def test_b5_candidates_follow_the_ports_rule():
    b5 = cell.metric_reader("b5_roofline")
    assert b5.candidates(200, 400_000) == 9 and b5.candidates(200, 100_000) == 15


def test_idle_gaps_named_by_innermost_range():
    host = [("portbench.window", 0.0, 100.0), ("portbench.call", 0.0, 50.0), ("knn.collect", 10.0, 20.0)]
    t = trace([("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 60.0, 100.0)], host=host)
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"knn.collect": 10e-6, "portbench.call": 30e-6})
    assert t.device_ops() == [["k", pytest.approx(60e-6)]]


def test_end_to_end_readers():
    calls = [{"ok": True, "start": i * 0.01, "end": i * 0.01 + (i + 1) * 1e-3, "rows": 64} for i in range(100)]
    assert read("knn_call_p95_ms", calls=calls) == pytest.approx(95.0)
    assert read("kneighbors_rows_per_s", calls=calls, window_s=2.0) == pytest.approx(3200.0)
    fits = [{"ok": True, "fits": 1, "rows": 10, "n_iter": 10}] * 4 + [{"ok": False, "rows": 0}]
    assert read("fit_s", calls=fits, window_s=10.0) == pytest.approx(2.5)
    assert read("fit_s", calls=[], window_s=10.0) is None
    mfu = read("mfu.fit", calls=fits, window_s=10.0, config=KM_CFG)
    assert mfu == pytest.approx(100.0 * 4 * 2.0 * 1e6 * 3000 * 1000 * 10 / 10.0 / 67e12)
    assert read("mfu.knn", calls=calls[:1], window_s=1.0) == pytest.approx(
        100.0 * 2.0 * 64 * 400_000 * 3000 / 67e12)
    assert read("setup_s", setup_s=12.5) == 12.5
    # the online cell's names read what the batch cell's do
    assert read("kneighbors_rows_per_s.online", calls=calls, window_s=2.0) == pytest.approx(3200.0)
    assert read("mfu.knn_online", calls=calls[:1]) == read("mfu.knn", calls=calls[:1])


def test_ingest_seconds_a_fit():
    host = [("core.ingest", 10.0, 1_000_010.0), ("core.ingest", 2e6, 3.5e6), ("core.ingest", 9e9, 9e9 + 1)]
    t = trace([], host=host, window=(0.0, 5e6))
    fits = [{"ok": True, "fits": 1, "n_iter": 1}] * 2
    assert read("ingest_s.fit", trace=t, calls=fits) == pytest.approx(1.25)
    assert read("ingest_s.fit", trace=None, calls=fits) is None
