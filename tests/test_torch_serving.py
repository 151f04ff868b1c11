# The port's served models (spark_rapids_ml_tpu_torch.serving over the
# models' _serving_entry hooks) against the JAX package's, on the CPU.
#
# Every arm the JAX serving tests serve is fitted by the JAX package at the
# model_zoo size (96 x 5, seed 7, tests/conftest.py), carried across with
# convert.*_from_reference, and the same rows are served through both
# packages' ModelServers.  Tolerances: labels, ids and tree outputs equal;
# floats within rtol 1e-5, atol 1e-5 (tests/test_serving.py's), distances
# as squares with atol 1e-5 of the squared-norm scale (the cancellation
# noise of the expanded distance, as tests/test_torch_ann.py); exact kNN on
# integer rows, where both packages' (d2, position) order fixes every id.
# Then the port alone: served == its own batch transform / kneighbors, the
# steady state adds zero warm-ups, a recovered worker adds none, the
# registry loads models saved by either package, the live index's
# mutations show in served searches; serving a model with no serving entry
# (UMAP) raises what the JAX package raises, and the multiplexed hooks of
# ROADMAP A13b answer (tests/test_torch_multiplex.py holds them to the JAX
# package).
import json

import numpy as np
import pytest

import spark_rapids_ml_tpu as ref
import spark_rapids_ml_tpu.serving as ref_serving
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame

import spark_rapids_ml_tpu_torch as port
import spark_rapids_ml_tpu_torch.serving as port_serving
from spark_rapids_ml_tpu_torch import convert, profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.parallel import faults as port_faults

RTOL = ATOL = 1e-5
SERVED_ARMS = ["kmeans", "pca", "linreg", "logreg", "rf_clf", "rf_reg", "knn", "ann", "ivfpq", "ivfpq_opq"]
CLASS_ARMS = {"kmeans", "logreg", "rf_clf"}  # their prediction is a label


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


@pytest.fixture
def arm_port(monkeypatch):
    def _arm(spec):
        monkeypatch.setenv(port_faults.FAULTS_ENV, spec)
        port_faults.reload()

    yield _arm
    monkeypatch.delenv(port_faults.FAULTS_ENV, raising=False)
    port_faults.reload()


def _attrs(model):
    return {k: (np.asarray(v) if isinstance(v, (list, tuple)) else v) for k, v in model._get_model_attributes().items()}


_CONVERT = {
    "kmeans": convert.kmeans_model_from_reference,
    "pca": convert.pca_model_from_reference,
    "linreg": convert.linear_regression_model_from_reference,
    "logreg": convert.logistic_regression_model_from_reference,
    "rf_clf": convert.random_forest_model_from_reference,
    "rf_reg": convert.random_forest_model_from_reference,
}
_ANN_PARAMS = {
    "ann": {"algorithm": "ivfflat", "algoParams": {"nlist": 4, "nprobe": 4}},
    "ivfpq": {"algorithm": "ivfpq", "algoParams": {"nlist": 4, "nprobe": 4, "M": 2, "n_bits": 4}},
    "ivfpq_opq": {"algorithm": "ivfpq", "algoParams": {"nlist": 4, "nprobe": 4, "M": 2, "n_bits": 4, "opq": True}},
}


def _integer_rows():
    rng = np.random.default_rng(7)
    return rng.integers(-4, 5, size=(96, 5)).astype(np.float32)


_KNN = {}


def _pair(arm, model_zoo):
    """(JAX model, port model, rows to serve) for one arm."""
    if arm == "knn":
        if "knn" not in _KNN:
            X = _integer_rows()
            jax_model = ref.NearestNeighbors(k=4).setFeaturesCol("features").fit(
                RefDataFrame.from_numpy(X, feature_layout="array", num_partitions=2))
            items = jax_model._item_df.toPandas()
            port_model = convert.nearest_neighbors_model_from_reference(
                np.stack(items["features"].to_numpy()), items["unique_id"].to_numpy(), {"k": 4})
            _KNN["knn"] = (jax_model, port_model, X)
        return _KNN["knn"]
    jax_model, X = model_zoo(arm)
    if arm in _ANN_PARAMS:
        port_model = convert.approximate_nearest_neighbors_model_from_reference(
            _attrs(jax_model), {"k": 4, **_ANN_PARAMS[arm]})
    else:
        port_model = _CONVERT[arm](_attrs(jax_model))
        if arm == "pca":
            port_model.setOutputCol(jax_model.getOrDefault("outputCol"))
    return jax_model, port_model, X


def _assert_columns_equal(got, want, arm, X):
    assert sorted(got) == sorted(want), arm
    for col in want:
        g, w = np.asarray(got[col]), np.asarray(want[col])
        assert g.shape == w.shape, (arm, col)
        if col == "indices" or (col == "prediction" and arm in CLASS_ARMS):
            np.testing.assert_array_equal(g, w, err_msg=f"{arm}: {col}")
        elif col == "distances":
            # squared, as both packages compute them: the expansion
            # |x|^2 - 2 x.c + |c|^2 cancels to a noise of ~1e-7 of its
            # scale, which a square root lifts to 1e-3 near 0
            scale = 2.0 * float((X.astype(np.float64) ** 2).sum(axis=1).max())
            np.testing.assert_allclose(g.astype(np.float64) ** 2, w.astype(np.float64) ** 2, rtol=RTOL,
                                       atol=ATOL * scale, err_msg=f"{arm}: {col}")
        else:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{arm}: {col}")


@pytest.mark.parametrize("arm", SERVED_ARMS)
def test_served_outputs_match_jax(arm, model_zoo):
    jax_model, port_model, X = _pair(arm, model_zoo)
    rows = [X[:10], X[10], X[11:40]]
    with ref_serving.ModelServer(f"tsv_{arm}", jax_model, max_batch=32, max_wait_ms=2) as jsrv:
        want = [jsrv.predict(r) for r in rows]
    with port_serving.ModelServer(f"tsv_{arm}", port_model, max_batch=32, max_wait_ms=2) as psrv:
        got = [psrv.predict(r) for r in rows]
        psrv.drain()
        psrv.assert_steady_state()
    for g, w in zip(got, want):
        _assert_columns_equal(g, w, arm, X)


def _port_batch(arm, model, X):
    df = port.DataFrame.from_numpy(X, num_partitions=1)
    if arm in ("knn", "ann", "ivfpq", "ivfpq_opq"):
        part = model.kneighbors(df)[2].partitions[0]
        return {"indices": part["indices"], "distances": part["distances"]}
    part = model.transform(df).partitions[0]
    return {c: part[c] for c in model._out_columns()}


@pytest.mark.parametrize("arm", SERVED_ARMS)
def test_served_outputs_match_port_batch(arm, model_zoo):
    _jax_model, port_model, X = _pair(arm, model_zoo)
    want = _port_batch(arm, port_model, X[:24])
    with port_serving.ModelServer(f"tpb_{arm}", port_model, max_batch=32, max_wait_ms=2) as srv:
        futs = [srv.submit(X[i : i + 3]) for i in range(0, 24, 3)]
        got = [f.result(timeout=60) for f in futs]
    merged = {c: np.concatenate([g[c] for g in got]) for c in got[0]}
    _assert_columns_equal(merged, want, arm, X)


def test_steady_state_zero_new_warmups(model_zoo):
    _jax_model, model, X = _pair("kmeans", model_zoo)
    srv = port_serving.ModelServer("tsv_steady", model, max_batch=64, max_wait_ms=2)
    try:
        assert profiling.counter("serving.tsv_steady.warmed_buckets") == len(srv.buckets) == 3
        before = profiling.counters("precompile.")
        rng = np.random.default_rng(3)
        for size in (1, 1, 3, 17, 33, 64, 5, 1, 64):
            srv.predict(rng.standard_normal((size, X.shape[1])).astype(np.float32))
        assert profiling.counter_deltas(before, "precompile.") == {}
        srv.drain()
        srv.assert_steady_state()
        stats = srv.stats()
        assert stats["buckets"] == [16, 32, 64] and stats["latency"]["count"] >= 9
        assert sum(stats["dispatch_by_bucket"][b].get("count", 0) for b in (16, 32, 64)) >= 5
    finally:
        srv.shutdown()


def test_worker_death_recovery_adds_zero_new_warmups(model_zoo, arm_port):
    _jax_model, model, X = _pair("kmeans", model_zoo)
    srv = port_serving.ModelServer("tsv_shield", model, max_batch=32, max_wait_ms=2)
    try:
        srv.predict(X[:3])
        arm_port("serving.dispatch:tag=tsv_shield:call=1:action=kill")
        before = profiling.counters("precompile.")
        with pytest.raises(port_serving.ServerRecovering):
            srv.predict(X[:3])
        import time

        deadline = time.monotonic() + 30
        while (srv.state() != port_serving.READY or profiling.counter("serving.tsv_shield.restarts") < 1) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.state() == port_serving.READY
        assert srv.predict(X[:3])["prediction"].shape == (3,)
        assert profiling.counter_deltas(before, "precompile.") == {}
        # the new worker re-warmed every bucket on its own thread
        assert len(profiling.durations("serve.tsv_shield.warm_dispatch")["serve.tsv_shield.warm_dispatch"]) \
            == 2 * len(srv.buckets)
        assert profiling.percentiles("serve.tsv_shield.recovery")["count"] == 1
        srv.drain()
        srv.assert_steady_state()
    finally:
        srv.shutdown(drain=False)


def test_registry_loads_models_saved_by_either_package(model_zoo, tmp_path):
    jax_model, port_model, X = _pair("linreg", model_zoo)
    jax_model.save(str(tmp_path / "jax"))
    port_model.save(str(tmp_path / "port"))
    want = port_model.transform(port.DataFrame.from_numpy(X[:5])).partitions[0]["prediction"]
    with port_serving.ModelRegistry(max_batch=16, max_wait_ms=1) as reg:
        for name in ("jax", "port"):
            reg.load(f"tsv_load_{name}", str(tmp_path / name))
            got = reg.get(f"tsv_load_{name}").predict(X[:5])["prediction"]
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert reg.names() == ["tsv_load_jax", "tsv_load_port"]
        port.LinearRegression().save(str(tmp_path / "est"))
        with pytest.raises(TypeError, match="not a fitted model"):
            reg.load("tsv_est", str(tmp_path / "est"))
        assert "tsv_est" not in reg


def test_registry_telemetry_snapshot_and_delta(model_zoo):
    _jax_model, model, X = _pair("kmeans", model_zoo)
    with port_serving.ModelRegistry(max_batch=16, max_wait_ms=1) as reg:
        reg.register("tsv_tel", model)
        reg.get("tsv_tel").predict(X[0])
        snap1 = reg.telemetry()
        for i in range(3):
            reg.get("tsv_tel").predict(X[i])
        delta = reg.telemetry(since=snap1)
        assert delta.counters["serving.tsv_tel.requests"] == 3
        assert delta.durations["serve.tsv_tel.latency"]["count"] == 3
        round_trip = profiling.TelemetrySnapshot.from_dict(json.loads(json.dumps(delta.to_dict())))
        assert round_trip == delta


def test_unservable_and_a13b_hooks_raise(model_zoo):
    class NoHook:
        pass

    errors = {}
    for pkg, S, umap_cls in (("jax", ref_serving, ref.UMAPModel), ("port", port_serving, port.UMAPModel)):
        with pytest.raises(TypeError, match="not a servable model") as ei:
            S.ModelServer("tsv_nohook", NoHook())
        umap = umap_cls(embedding_=np.zeros((4, 2), np.float32), raw_data_=np.zeros((4, 3), np.float32),
                        n_cols=3, dtype="float32")
        with pytest.raises(NotImplementedError, match="has no serving entry") as ei_umap:
            S.ModelServer("tsv_umap", umap)
        errors[pkg] = (type(ei.value).__name__, str(ei.value), type(ei_umap.value).__name__, str(ei_umap.value))
    assert errors["port"] == errors["jax"]  # UMAP: what the JAX package raises, word for word
    for arm in ("kmeans", "pca", "linreg", "logreg"):
        jax_model, port_model, _X = _pair(arm, model_zoo)
        port_sig = port_serving.lane_signature(port_serving.lane_entry_for(port_model))
        assert port_sig == ref_serving.lane_signature(ref_serving.lane_entry_for(jax_model)), arm
    assert sorted(port_serving.__all__) == sorted(ref_serving.__all__)


def test_failed_warmup_raises_and_releases_the_trace_scope(model_zoo, monkeypatch, tmp_path):
    class Broken:
        n_cols = 3

        def _serving_entry(self, mesh=None):
            def call(batch):
                raise RuntimeError("cannot dispatch")

            return port_serving.ServingEntry(name="serve.broken", n_cols=3, dtype=np.dtype(np.float32),
                                             out_cols=["x"], call=call, warm=lambda b: [])

    monkeypatch.setenv(profiling.TRACE_ENV, str(tmp_path))
    with pytest.raises(RuntimeError, match="cannot dispatch"):
        port_serving.ModelServer("tsv_broken", Broken(), max_batch=4)
    assert profiling._collect_depth == 0
    assert list(tmp_path.glob("serve-tsv_broken-*.trace.json"))


def test_sanitize_scope_fails_a_nan_batch(monkeypatch):
    class NaNs:
        def _serving_entry(self, mesh=None):
            def call(batch):
                out = batch.sum(axis=1)
                if batch[0, 0] < 0:
                    out[0] = np.nan
                return {"s": out}

            return port_serving.ServingEntry(name="serve.nans", n_cols=2, dtype=np.dtype(np.float32),
                                             out_cols=["s"], call=call, warm=lambda b: [])

    with port_serving.ModelServer("tsv_nan", NaNs(), max_batch=4, max_wait_ms=1) as srv:
        assert np.isnan(srv.predict(np.array([-1.0, 0.0], np.float32))["s"][0])  # unarmed: served as is
        monkeypatch.setenv("SRML_SANITIZE", "1")
        with pytest.raises(FloatingPointError, match="NaN in output"):
            srv.predict(np.array([-1.0, 0.0], np.float32))
        assert srv.predict(np.array([1.0, 2.0], np.float32))["s"][0] == 3.0


def test_live_index_mutations_show_in_served_searches(model_zoo):
    """The flat entry reads the live holder's snapshot each batch: an add
    after registration is found by the next served search, and a delete
    disappears from it, without re-registering the model."""
    _jax_model, model, X = _pair("ann", model_zoo)
    holder = model.mutable_index()
    with port_serving.ModelServer("tsv_live", model, max_batch=16, max_wait_ms=1) as srv:
        before = srv.predict(X[:2])["indices"]
        new = (X[:2] + 0.001).astype(np.float32)
        holder.add_items(new, np.array([1000, 1001]))
        after = srv.predict(new)["indices"]
        assert list(after[:, 0]) == [1000, 1001]
        holder.delete_items(np.array([1000]))
        assert 1000 not in srv.predict(new)["indices"]
        assert before.shape == (2, 4)
