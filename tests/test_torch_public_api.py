# The port's last public functions against the JAX package's, on the CPU:
# profiling's harness helpers (with_benchmark, spread_attribution,
# series_stats, span_records, collect_spans, device_step_annotation), the
# DataFrame's relational and execution methods with Row, and
# TypeConverters.toListFloat / toListInt.  Each is called the same way on
# both packages and must give the same values (a vector cell compared as
# its array; the JAX frame's partitions are pandas, the port's numpy).
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.dataframe import Row as RefRow
from spark_rapids_ml_tpu.params import TypeConverters as RefTypeConverters

from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.dataframe import DataFrame, Row
from spark_rapids_ml_tpu_torch.params import TypeConverters

PACKAGES = {"jax": (RefDataFrame, RefRow, ref_profiling, RefTypeConverters),
            "port": (DataFrame, Row, profiling, TypeConverters)}


# -- profiling -------------------------------------------------------------------


def test_with_benchmark_returns_the_result_and_its_seconds():
    for prof in (ref_profiling, profiling):
        out, seconds = prof.with_benchmark("step", lambda: 41 + 1)
        assert out == 42 and isinstance(seconds, float) and seconds >= 0.0


@pytest.mark.parametrize("runs,median,floor,top", [
    ([{"a": 1.0, "b": 2.0}, {"a": 1.5, "b": 2.0, "c": 0.4}, {"a": 0.9, "b": 2.6}], 4.0, 1.0, 5),
    ([{"a": 1.0, "b": 2.0}, {"a": 1.5, "b": 2.9}], 4.0, 15.0, 1),
    ([{"a": 1.0}], 4.0, 1.0, 5),
    ([{"a": 1.0}, {"a": 2.0}], 0.0, 1.0, 5),
], ids=["three_runs", "floor_and_top", "one_run", "zero_median"])
def test_spread_attribution_equals_jax(runs, median, floor, top):
    want = ref_profiling.spread_attribution(runs, median, floor_pct=floor, top=top)
    got = profiling.spread_attribution(runs, median, floor_pct=floor, top=top)
    assert got == want and list(got) == list(want)


def test_series_stats_equals_jax():
    out = {}
    for name, prof in (("jax", ref_profiling), ("port", profiling)):
        prof.reset_durations("api_test.")
        for s in (0.1, 0.2, 0.3):
            prof.record_duration("api_test.a", s)
        prof.record_duration("api_test.b", 1.0)
        stats = prof.series_stats()
        out[name] = {k: v for k, v in stats["series"].items() if k.startswith("api_test.")}
        assert stats["ttl_s"] == 0.0 and stats["est_bytes"] == 8 * stats["ring_samples"]
        assert stats["series_count"] == len(stats["series"])
        prof.reset_durations("api_test.")
    assert out["port"] == out["jax"]
    assert out["port"]["api_test.a"] == {"ring_samples": 3, "lifetime_count": 3, "age_s": None}


def test_collect_spans_and_span_records_equal_jax():
    """Spans inside collect_spans become (name, t0, t1, thread ident,
    thread name, span id, parent id, attrs) records, a child naming its
    parent; outside it nothing is kept, and the buffer clears when the
    last scope exits."""
    shapes = {}
    for name, prof in (("jax", ref_profiling), ("port", profiling)):
        with prof.span("api_test.outside"):
            pass
        assert prof.span_records() == []
        with prof.collect_spans():
            with prof.collect_spans():
                with prof.span("api_test.outer", rows=3) as h:
                    with prof.span("api_test.inner"):
                        pass
                    h.set(done=True)
            recs = prof.span_records()
        assert prof.span_records() == []
        by = {r[0]: r for r in recs}
        outer, inner = by["api_test.outer"], by["api_test.inner"]
        assert inner[6] == outer[5] and outer[6] == 0
        assert outer[1] <= inner[1] <= inner[2] <= outer[2]
        shapes[name] = [(r[0], len(r), r[7]) for r in recs]
    assert shapes["port"] == shapes["jax"]
    assert shapes["port"][-1] == ("api_test.outer", 8, {"rows": 3, "done": True})


def test_device_step_annotation_names_the_step_under_the_profiler():
    """A null context while no profiler records (the JAX package's is a
    StepTraceAnnotation, a no-op without a trace); under torch.profiler the
    iteration is the range "step <n>"."""
    with ref_profiling.device_step_annotation(3):
        pass
    import contextlib

    assert isinstance(profiling.device_step_annotation(3), contextlib.nullcontext)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.device_step_annotation(3):
            torch.ones(4).sum()
    assert "step 3" in {e.key for e in prof.key_averages()}


# -- DataFrame -------------------------------------------------------------------


def _frame(pkg, n=10, parts=3):
    X = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
    y = (np.arange(n) % 3).astype(np.float64)
    return PACKAGES[pkg][0].from_numpy(X, y, num_partitions=parts)


def _cells(df):
    """Every row as a dict of plain values (vector cells as lists)."""
    rows = []
    for r in df.collect():
        rows.append({k: (np.asarray(v).tolist() if np.ndim(v) else v) for k, v in r.asDict().items()})
    return rows


def _same(fn):
    got, want = fn("port"), fn("jax")
    assert got == want
    return got


def test_dtypes_schema_of_and_is_empty():
    _same(lambda p: (_frame(p).dtypes, _frame(p).schema_of("label"), _frame(p).schema_of("features")))
    assert _same(lambda p: _frame(p).isEmpty()) is False
    assert _same(lambda p: _frame(p).filter(lambda part: part["label"] > 5).isEmpty()) is True


@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_repartition_and_coalesce(n):
    sizes = _same(lambda p: [len(part) for part in _frame(p).repartition(n).partitions])
    assert sum(sizes) == 10
    _same(lambda p: _cells(_frame(p).repartition(n)))
    _same(lambda p: ([len(part) for part in _frame(p).coalesce(n).partitions], _cells(_frame(p).coalesce(n))))


def test_select_drop_and_rename():
    _same(lambda p: (_frame(p).select("label").columns, _cells(_frame(p).select(["label", "features"]))))
    _same(lambda p: (_frame(p).drop("label", "absent").columns, _cells(_frame(p).drop("label"))))
    _same(lambda p: (_frame(p).withColumnRenamed("label", "y").columns,
                     _cells(_frame(p).withColumnRenamed("label", "y"))))


def test_filter_takes_a_predicate_on_the_partition():
    _same(lambda p: _cells(_frame(p).filter(lambda part: part["label"] > 0)))
    _same(lambda p: [len(part) for part in _frame(p).filter(lambda part: part["label"] == 2).partitions])


def test_union_collect_and_first():
    rows = _same(lambda p: _cells(_frame(p).union(_frame(p, n=4, parts=1))))
    assert len(rows) == 14
    _same(lambda p: [len(part) for part in _frame(p).union(_frame(p)).partitions])
    first = _same(lambda p: {k: np.asarray(v).tolist() for k, v in _frame(p).first().asDict().items()})
    assert first == {"features": [0.0, 1.0], "label": 0.0}
    assert _same(lambda p: _frame(p).filter(lambda part: part["label"] > 5).first()) is None


def test_map_in_pandas():
    def fn(batches):
        for b in batches:
            if len(b) and b["label"].iloc[0] == 0:
                yield b.assign(z=b["label"] * 2)

    out = _same(lambda p: (_frame(p).mapInPandas(fn).columns,
                           [len(part) for part in _frame(p).mapInPandas(fn).partitions],
                           _frame(p).mapInPandas(fn).toPandas()["z"].tolist()))
    assert out[0] == ["features", "label", "z"]


def test_to_arrow_and_cache():
    pa = pytest.importorskip("pyarrow")
    tables = [PACKAGES[p][0].from_numpy(np.eye(3, dtype=np.float32), np.arange(3.0)).to_arrow() for p in PACKAGES]
    assert all(isinstance(t, pa.Table) for t in tables)
    assert tables[0].equals(tables[1])
    for pkg in PACKAGES:
        df = _frame(pkg)
        assert df.cache() is df


def test_row_access():
    for Cls in (RefRow, Row):
        r = Cls({"a": 1, "b": [2, 3]})
        assert r.a == 1 and r["b"] == [2, 3] and r[0] == 1 and r.asDict() == {"a": 1, "b": [2, 3]}
        assert repr(r) == "Row(a=1, b=[2, 3])" and r == Cls({"a": 1, "b": [2, 3]}) and r != Cls({"a": 2})
        with pytest.raises(AttributeError):
            r.c


# -- TypeConverters ------------------------------------------------------------------


@pytest.mark.parametrize("value", [[1, 2.0, 3], (4, 5), np.array([1.0, 2.0]), np.array([3, 4])],
                         ids=["list", "tuple", "float_array", "int_array"])
def test_list_converters_equal_jax(value):
    for name in ("toListFloat", "toListInt"):
        want = getattr(RefTypeConverters, name)(value)
        got = getattr(TypeConverters, name)(value)
        assert got == want and [type(v) for v in got] == [type(v) for v in want]


@pytest.mark.parametrize("value", [[1.5], [True], "12", 3, [None]], ids=["fraction", "bool", "string", "scalar",
                                                                        "none"])
def test_list_converters_reject_as_jax_does(value):
    for name in ("toListFloat", "toListInt"):
        try:
            want = getattr(RefTypeConverters, name)(value)
        except TypeError:
            with pytest.raises(TypeError):
                getattr(TypeConverters, name)(value)
        else:
            assert getattr(TypeConverters, name)(value) == want
