# fit() of a live pyspark DataFrame in the port trains in a Spark barrier
# stage (spark/adapter.barrier_fit_estimator -> parallel/runner.
# run_distributed_fit), as in the JAX package, never collecting the frame.
# pyspark is not installed, so the surface run_barrier_fit touches
# (repartition / mapInPandas / rdd.barrier / collect, BarrierTaskContext) is
# a fake with one barrier task, this file's own copy of the JAX package's
# tests/test_spark_barrier_fit.py fake; the same frame goes through both
# packages.  Gates: each port barrier fit (KMeans, PCA, LinearRegression,
# LogisticRegression, both forests, UMAP) is bit for bit the port's local
# fit of the same rows, and agrees with the JAX package's barrier fit by the
# estimator's parity contract of its own port test (KMeans inits draw from
# a torch.Generator in the port, threefry in the JAX package, so the two
# are compared after convergence on separable blobs).
import sys
import types

import numpy as np
import pandas as pd
import pytest

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.spark.adapter import NUM_WORKERS_CONF

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.core import TELEMETRY_ATTR
from spark_rapids_ml_tpu_torch.device import use_device


class _FakeBarrierTaskContext:
    _current = None

    def __init__(self, rank: int):
        self._rank = rank

    @classmethod
    def get(cls):
        return cls._current

    def partitionId(self):
        return self._rank

    def allGather(self, message):
        return [message]

    def barrier(self):
        return None


class _FakeRdd:
    def __init__(self, partitions, udf=None):
        self._partitions = partitions
        self._udf = udf
        self.stages = 0

    def getNumPartitions(self):
        return len(self._partitions)

    def barrier(self):
        return self

    def mapPartitions(self, f):
        return self

    def withResources(self, profile):
        return self

    def collect(self):
        rows = []
        for rank, part in enumerate(self._partitions):
            _FakeBarrierTaskContext._current = _FakeBarrierTaskContext(rank)
            try:
                for out in self._udf(iter([part])):
                    for _, r in out.iterrows():
                        rows.append({"model_attributes": r["model_attributes"]})
            finally:
                _FakeBarrierTaskContext._current = None
        _FakeSparkDataFrame.tasks_run.append(len(self._partitions))
        return rows


class _FakeConf:
    def __init__(self, conf=None):
        self._conf = {"spark.master": "local[1]", **(conf or {})}

    def get(self, key, default=None):
        return self._conf.get(key, default)


class _FakeSparkSession:
    version = "3.5.0"

    def __init__(self, conf=None):
        self.sparkContext = types.SimpleNamespace(getConf=lambda: _FakeConf(conf))


class _FakeSparkDataFrame:
    """Just enough of pyspark.sql.DataFrame for run_barrier_fit; its module
    name routes it to the barrier stage.  No toPandas: a driver collect
    fails."""

    tasks_run = []

    def __init__(self, partitions, udf=None, conf=None):
        self._partitions = partitions
        self._udf = udf
        self._conf = conf
        self.sparkSession = _FakeSparkSession(conf)

    def repartition(self, n):
        if n == len(self._partitions):
            return self
        whole = pd.concat(self._partitions, ignore_index=True)
        idx = np.array_split(np.arange(len(whole)), n)
        return _FakeSparkDataFrame([whole.iloc[ix].reset_index(drop=True) for ix in idx], conf=self._conf)

    def sample(self, fraction=None, seed=None, withReplacement=None):
        rng = np.random.default_rng(seed)
        return _FakeSparkDataFrame(
            [p[rng.random(len(p)) < fraction].reset_index(drop=True) for p in self._partitions], conf=self._conf
        )

    def mapInPandas(self, udf, schema=None):
        return _FakeSparkDataFrame(self._partitions, udf=udf, conf=self._conf)

    @property
    def rdd(self):
        return _FakeRdd(self._partitions, self._udf)

    @property
    def columns(self):
        return list(self._partitions[0].columns)


_FakeSparkDataFrame.__module__ = "pyspark.sql.dataframe"


@pytest.fixture(autouse=True)
def fake_pyspark(monkeypatch):
    mod = types.ModuleType("pyspark")
    mod.BarrierTaskContext = _FakeBarrierTaskContext
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    monkeypatch.delenv("SRML_SPARK_COLLECT", raising=False)
    _FakeSparkDataFrame.tasks_run.clear()
    with use_device("cpu"):
        yield


def _blobs(n=600, d=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X[: n // 2] += 6.0
    y = (X @ rng.standard_normal(d).astype(np.float32) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    y_cls = (X[:, 1] + 0.3 * X[:, 2] > 0).astype(np.float32)
    return X, y, y_cls


def _frames(X, y=None, n_parts=2, conf=None):
    """The same rows as a fake pyspark frame and as each package's frame."""
    parts = []
    for ix in np.array_split(np.arange(len(X)), n_parts):
        pdf = pd.DataFrame({"features": list(X[ix])})
        if y is not None:
            pdf["label"] = y[ix]
        parts.append(pdf)
    return (
        _FakeSparkDataFrame(parts, conf=conf),
        port.DataFrame.from_numpy(X, y, num_partitions=n_parts),
        RefDataFrame.from_numpy(X, y, num_partitions=n_parts),
    )


def _match(a, b):
    """Index of the nearest row of b for each row of a."""
    return np.argmin(((a[:, None, :] - b[None]) ** 2).sum(-1), axis=1)


def _same_model(got, want, names):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


# -- each estimator: barrier == local (bits), barrier ~ JAX barrier --------------


def test_kmeans_barrier_fit():
    X, _, _ = _blobs()
    sdf, df, _ = _frames(X)
    model = port.KMeans(k=2, maxIter=15, seed=5).fit(sdf)
    _same_model(model, port.KMeans(k=2, maxIter=15, seed=5).fit(df), ["cluster_centers_", "inertia_", "n_iter_"])
    ref_model = ref.KMeans(k=2, maxIter=15, seed=5).fit(sdf)
    perm = _match(ref_model.cluster_centers_, model.cluster_centers_)
    assert sorted(perm) == [0, 1]
    np.testing.assert_allclose(model.cluster_centers_[perm], ref_model.cluster_centers_, atol=1e-4)
    np.testing.assert_allclose(model.inertia_, ref_model.inertia_, rtol=1e-4)
    assert _FakeSparkDataFrame.tasks_run == [1, 1]


def test_pca_barrier_fit():
    rng = np.random.default_rng(7)
    X = (rng.standard_normal((400, 3)) @ rng.standard_normal((3, 12)) + 0.01 * rng.standard_normal((400, 12)))
    X = X.astype(np.float32)
    sdf, df, _ = _frames(X)
    model = port.PCA(k=3).fit(sdf)
    names = ["mean_", "components_", "explained_variance_", "explained_variance_ratio_", "singular_values_"]
    _same_model(model, port.PCA(k=3).fit(df), names)
    ref_model = ref.PCA(k=3).fit(sdf)
    np.testing.assert_allclose(model.explained_variance_, ref_model.explained_variance_, rtol=1e-4)
    np.testing.assert_allclose(np.abs((model.components_ * ref_model.components_).sum(1)), 1.0, atol=1e-4)


@pytest.mark.parametrize("params", [{}, {"regParam": 0.05, "elasticNetParam": 0.5, "maxIter": 200}],
                         ids=["ols", "elastic_net"])
def test_linear_regression_barrier_fit(params):
    X, y, _ = _blobs()
    sdf, df, _ = _frames(X, y)
    model = port.LinearRegression(**params).fit(sdf)
    _same_model(model, port.LinearRegression(**params).fit(df), ["coef_", "intercept_"])
    ref_model = ref.LinearRegression(**params).fit(sdf)
    np.testing.assert_allclose(model.coefficients, ref_model.coefficients, atol=1e-4)
    np.testing.assert_allclose(model.intercept, ref_model.intercept, atol=1e-3)


def test_logistic_regression_barrier_fit():
    X, _, y_cls = _blobs()
    sdf, df, _ = _frames(X, y_cls)
    model = port.LogisticRegression(regParam=0.01, tol=1e-7).fit(sdf)
    _same_model(model, port.LogisticRegression(regParam=0.01, tol=1e-7).fit(df), ["coef_", "intercept_", "classes_"])
    ref_model = ref.LogisticRegression(regParam=0.01, tol=1e-7).fit(sdf)
    np.testing.assert_array_equal(model.classes_, ref_model.classes_)
    np.testing.assert_allclose(model.coef_, ref_model.coef_, atol=2e-3)
    np.testing.assert_allclose(model.intercept_, ref_model.intercept_, atol=2e-3)


FOREST = dict(numTrees=2, maxDepth=5, maxBins=8, featureSubsetStrategy="all", bootstrap=False, seed=5)


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_random_forest_barrier_fit(kind):
    X, y, y_cls = _blobs(n=500)
    labels = y_cls if kind == "classifier" else y
    sdf, df, _ = _frames(X, labels)
    name = "RandomForestClassifier" if kind == "classifier" else "RandomForestRegressor"
    model = getattr(port, name)(**FOREST).fit(sdf)
    local = getattr(port, name)(**FOREST).fit(df)
    _same_model(model, local, ["features_", "thresholds_", "leaf_values_", "node_counts_", "impurities_"])
    ref_model = getattr(ref, name)(**FOREST).fit(sdf)
    assert model.features_.shape == ref_model.features_.shape
    assert (model.features_[:, :7] == ref_model.features_[:, :7]).mean() >= 0.97
    pred = np.concatenate([p["prediction"] for p in model.transform(df).partitions])
    pred_ref = ref_model.transform(RefDataFrame.from_numpy(X)).toPandas()["prediction"].to_numpy()
    if kind == "classifier":
        assert abs((pred == labels).mean() - (pred_ref == labels).mean()) < 0.03
    else:
        assert abs(((pred - labels) ** 2).mean() - ((pred_ref - labels) ** 2).mean()) / labels.var() < 0.03


def test_fit_multiple_single_pass_over_the_barrier():
    X, y, _ = _blobs()
    sdf, df, _ = _frames(X, y)
    est, ref_est = port.LinearRegression(maxIter=50), ref.LinearRegression(maxIter=50)
    maps = [{est.getParam("regParam"): 0.0}, {est.getParam("regParam"): 0.5}]
    ref_maps = [{ref_est.getParam("regParam"): 0.0}, {ref_est.getParam("regParam"): 0.5}]
    models = est.fit(sdf, maps)
    assert _FakeSparkDataFrame.tasks_run == [1]  # one barrier stage fits every map
    local = est.fit(df, maps)
    ref_models = ref_est.fit(sdf, ref_maps)
    for m, lm, rm in zip(models, local, ref_models):
        _same_model(m, lm, ["coef_", "intercept_"])
        np.testing.assert_allclose(m.coef_, rm.coef_, rtol=1e-4, atol=1e-5)
        assert m.getOrDefault("regParam") == rm.getOrDefault("regParam")
    assert not np.allclose(models[0].coef_, models[1].coef_, rtol=1e-3)


def test_barrier_fit_carries_the_merged_telemetry():
    X, _, _ = _blobs()
    sdf, _, _ = _frames(X)
    est = port.KMeans(k=2, maxIter=5, seed=5)
    model = est.fit(sdf)
    t = model._fit_telemetry
    assert t is not None
    assert t.phases["runner.fit"]["count"] == 1 and t.phases["runner.fit"]["total_s"] > 0.0
    assert "runner.build_inputs" in t.phases
    assert t.meta["ranks"] == [0]
    assert est._last_fit_phase_times.get("runner.fit", 0.0) > 0.0
    assert TELEMETRY_ATTR not in model._get_model_attributes()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_missing_input_column_fails_on_the_driver(package):
    X, _, _ = _blobs(n=60)
    sdf, _, _ = _frames(X)
    est = (port if package == "port" else ref).KMeans(k=2, maxIter=5).setFeaturesCol("nope")
    with pytest.raises(ValueError, match="nope"):
        est.fit(sdf)
    assert _FakeSparkDataFrame.tasks_run == []


def test_umap_cluster_fit_is_one_task_sampled_before_the_coalesce():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((400, 5)).astype(np.float32)
    sdf, _, _ = _frames(X, n_parts=4, conf={NUM_WORKERS_CONF: "2"})
    assert port.UMAP._cluster_fit_single_task is True
    params = dict(n_neighbors=5, n_epochs=30, random_state=7)
    est = port.UMAP(sample_fraction=0.5, **params)
    model = est.fit(sdf)
    assert _FakeSparkDataFrame.tasks_run == [1]
    assert est.getSampleFraction() == 0.5  # the caller's estimator is untouched
    ref_model = ref.UMAP(sample_fraction=0.5, **params).fit(sdf)
    # Spark sampled the same rows for both packages' single fit task
    n_fit = model.raw_data_.shape[0]
    assert n_fit == np.asarray(ref_model.raw_data_).shape[0] and 120 <= n_fit <= 280
    np.testing.assert_array_equal(np.asarray(model.raw_data_), np.asarray(ref_model.raw_data_))
    # and the task's fit is the local fit of those rows, bit for bit
    local = port.UMAP(**params).fit(port.DataFrame.from_numpy(np.asarray(model.raw_data_)))
    np.testing.assert_array_equal(model.embedding_, local.embedding_)


def _single_process(module, name):
    """A KMeans subclass that cannot fit across processes (and has no
    single-task route)."""
    return type(name, (module.KMeans,), {"_supports_multicontroller_fit": False})


def test_multi_process_refusal_is_the_jax_message():
    X, _, _ = _blobs(n=60)
    sdf, _, _ = _frames(X, conf={NUM_WORKERS_CONF: "2"})
    messages = []
    for module in (port, ref):
        with pytest.raises(NotImplementedError) as err:
            _single_process(module, "OneProcessKMeans")(k=2).fit(sdf)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "does not yet support multi-process" in messages[0]
    assert _FakeSparkDataFrame.tasks_run == []


def test_collect_override_takes_the_driver_local_route(monkeypatch):
    """SRML_SPARK_COLLECT=1 collects the frame (the fake has no toPandas,
    so the route shows as the collect's error), in both packages."""
    monkeypatch.setenv("SRML_SPARK_COLLECT", "1")
    X, _, _ = _blobs(n=60)
    sdf, _, _ = _frames(X)
    for module in (port, ref):
        with pytest.raises((AttributeError, TypeError)):
            module.KMeans(k=2, maxIter=5).fit(sdf)
    assert _FakeSparkDataFrame.tasks_run == []
