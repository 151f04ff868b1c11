# Evaluation and cross validation of a live pyspark DataFrame in the port,
# against the JAX package through the same fakes: Evaluator.evaluate of a
# pyspark prediction frame runs on the executors (spark/adapter.
# executor_evaluate: regression, multiclass, binary, and the two-pass
# silhouette), and CrossValidator.fit folds with Spark (randomSplit +
# union), fits each fold through the barrier stage, scores on the executors
# and unpersists each fold once scored.  spark_to_facade is patched to fail,
# so no route collects the frame.  pyspark is not installed; the fake is
# this file's own copy of the JAX package's tests/test_spark_cv.py fake,
# whose randomSplit is the facade's seeded permutation, so the cluster CV is
# held bit for bit to the port's local fold loop on the same folds, and to
# the JAX package's cluster CV by each estimator's parity contract.
import contextlib
import sys
import types

import numpy as np
import pandas as pd
import pytest

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu import evaluation as ref_evaluation
from spark_rapids_ml_tpu import tuning as ref_tuning
from spark_rapids_ml_tpu.spark import adapter as ref_adapter

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import evaluation, tuning
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.spark import adapter


class _FakeBarrierTaskContext:
    _current = None

    def __init__(self, rank):
        self._rank = rank

    @classmethod
    def get(cls):
        return cls._current

    def partitionId(self):
        return self._rank

    def allGather(self, message=""):
        return [message]

    def barrier(self):
        return None


class _FakeRdd:
    def __init__(self, df):
        self._df = df

    def barrier(self):
        return self

    def mapPartitions(self, f):
        return self

    def withResources(self, profile):
        return self

    def collect(self):
        rows = []
        for rank, part in enumerate(self._df._partitions):
            _FakeBarrierTaskContext._current = _FakeBarrierTaskContext(rank)
            try:
                for out in self._df._udf(iter([part])):
                    rows.extend(out.to_dict("records"))
            finally:
                _FakeBarrierTaskContext._current = None
        return rows


class _FakeField:
    def __init__(self, name, ddl):
        self.name = name
        self.dataType = types.SimpleNamespace(simpleString=lambda d=ddl: d)


class _FakeConf:
    def get(self, key, default=None):
        return {"spark.master": "local[1]"}.get(key, default)


class _FakeSparkSession:
    version = "3.5.0"

    def __init__(self):
        self.sparkContext = types.SimpleNamespace(getConf=lambda: _FakeConf())


def _split_pandas(pdf, n):
    idx = np.array_split(np.arange(len(pdf)), max(1, n))
    return [pdf.iloc[ix].reset_index(drop=True) for ix in idx]


class _FakeSparkDataFrame:
    """Fold ops (randomSplit / union / cache / unpersist), the barrier fit's
    ops and the executor ops; no toPandas.  `events` logs every cache and
    unpersist by frame id."""

    events = []

    def __init__(self, partitions, udf=None):
        self._partitions = partitions
        self._udf = udf
        self.sparkSession = _FakeSparkSession()

    def _whole(self):
        return pd.concat(self._partitions, ignore_index=True)

    @property
    def columns(self):
        return list(self._partitions[0].columns)

    @property
    def schema(self):
        ddl = {"features": "array<float>", "label": "double"}
        return types.SimpleNamespace(fields=[_FakeField(c, ddl.get(c, "double")) for c in self.columns])

    @property
    def rdd(self):
        return _FakeRdd(self)

    def randomSplit(self, weights, seed=0):
        # the facade's seeded-permutation split
        whole = self._whole()
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(whole))
        total = float(sum(weights))
        bounds = np.cumsum([w / total for w in weights])[:-1]
        cut = (bounds * len(whole)).astype(int)
        nparts = max(1, len(self._partitions))
        return [
            _FakeSparkDataFrame(_split_pandas(whole.iloc[np.sort(g)].reset_index(drop=True), nparts))
            for g in np.split(perm, cut)
        ]

    def union(self, other):
        assert self.columns == other.columns
        return _FakeSparkDataFrame(self._partitions + other._partitions)

    def cache(self):
        _FakeSparkDataFrame.events.append(("cache", id(self)))
        return self

    def unpersist(self):
        _FakeSparkDataFrame.events.append(("unpersist", id(self)))
        return self

    def repartition(self, n):
        if n == len(self._partitions):
            return self
        return _FakeSparkDataFrame(_split_pandas(self._whole(), n))

    def mapInPandas(self, udf, schema=None):
        if self._udf is None:
            return _FakeSparkDataFrame(self._partitions, udf=udf)
        # a mapInPandas over a udf-bearing frame applies to the previous
        # stage's output, partition by partition (lazy pyspark)
        prev = self._udf

        def chained(part_iter):
            def gen():
                for part in part_iter:
                    yield from prev(iter([part]))

            return udf(gen())

        return _FakeSparkDataFrame(self._partitions, udf=chained)

    def collect(self):
        rows = []
        for part in self._partitions:
            for out in self._udf(iter([part])):
                rows.extend(out.to_dict("records"))
        return rows


_FakeSparkDataFrame.__module__ = "pyspark.sql.dataframe"


@pytest.fixture(autouse=True)
def fake_pyspark(monkeypatch):
    mod = types.ModuleType("pyspark")
    mod.BarrierTaskContext = _FakeBarrierTaskContext
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    monkeypatch.delenv("SRML_SPARK_COLLECT", raising=False)
    # the JAX package's local CV: the fold loop, as its cluster route
    monkeypatch.setenv("SRML_SWEEP_BATCH", "0")

    def _boom(sdf):
        raise AssertionError("the dataset was collected to the driver")

    monkeypatch.setattr(adapter, "spark_to_facade", _boom)
    monkeypatch.setattr(ref_adapter, "spark_to_facade", _boom)
    _FakeSparkDataFrame.events.clear()
    with use_device("cpu"):
        yield


def _data(n=600, d=6, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = (X @ w + 0.1 * rng.standard_normal(n)).astype(np.float32)
    y_cls = (X @ w > 0).astype(np.float32)
    return X, y, y_cls


def _frames(pdf, n_parts=3):
    """The same rows as a fake pyspark frame and as a port frame of the same
    partitions."""
    parts = _split_pandas(pdf, n_parts)
    return _FakeSparkDataFrame(parts), port.DataFrame([port.dataframe.partition_of(p) for p in parts])


# -- executor-side evaluation --------------------------------------------------------


def _prediction_frame(kind, n=300, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "regression":
        label = rng.standard_normal(n)
        return pd.DataFrame({"label": label, "prediction": label + 0.3 * rng.standard_normal(n)})
    if kind in ("multiclass", "binary"):
        classes = 3 if kind == "multiclass" else 2
        label = rng.integers(0, classes, n).astype(np.float64)
        logits = rng.standard_normal((n, classes)) + 2.0 * np.eye(classes)[label.astype(int)]
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return pd.DataFrame({"label": label, "prediction": probs.argmax(1).astype(np.float64),
                             "probability": list(probs), "rawPrediction": list(logits)})
    centers = np.array([[0.0, 0.0, 0.0], [6.0, 0.0, 1.0], [0.0, 7.0, -2.0]])
    pred = rng.integers(0, 3, n)
    X = centers[pred] + rng.standard_normal((n, 3))
    return pd.DataFrame({"features": list(X), "prediction": pred.astype(np.float64)})


EVALUATORS = {
    "rmse": ("regression", "RegressionEvaluator", {"metricName": "rmse"}),
    "r2": ("regression", "RegressionEvaluator", {"metricName": "r2"}),
    "f1": ("multiclass", "MulticlassClassificationEvaluator", {"metricName": "f1"}),
    "logLoss": ("multiclass", "MulticlassClassificationEvaluator", {"metricName": "logLoss"}),
    "accuracy": ("multiclass", "MulticlassClassificationEvaluator", {"metricName": "accuracy"}),
    "areaUnderROC": ("binary", "BinaryClassificationEvaluator", {"metricName": "areaUnderROC"}),
    "areaUnderPR": ("binary", "BinaryClassificationEvaluator", {"metricName": "areaUnderPR"}),
    "silhouette": ("clustering", "ClusteringEvaluator", {}),
}


@pytest.mark.parametrize("name", sorted(EVALUATORS))
def test_executor_evaluate_matches_local_and_the_jax_package(name):
    kind, cls, params = EVALUATORS[name]
    sdf, df = _frames(_prediction_frame(kind))
    got = getattr(evaluation, cls)(**params).evaluate(sdf)
    local = getattr(evaluation, cls)(**params).evaluate(df)
    want = getattr(ref_evaluation, cls)(**params).evaluate(sdf)
    if kind == "clustering":
        # the two-pass partials against the local one-pass score; the cache
        # is released after the passes
        np.testing.assert_allclose(got, local, rtol=1e-12)
        assert [e for e, _ in _FakeSparkDataFrame.events].count("unpersist") == 2  # both packages
    else:
        assert got == local
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_single_cluster_prediction_frame_raises_like_pyspark():
    pdf = _prediction_frame("clustering")
    pdf["prediction"] = 0.0
    sdf, _ = _frames(pdf)
    for module in (evaluation, ref_evaluation):
        with pytest.raises(AssertionError, match="greater than one"):
            module.ClusteringEvaluator().evaluate(sdf)


# -- cross validation on the cluster -------------------------------------------------


def _cv(module, est, grid_param, values, evaluator, folds, seed):
    grid = module.ParamGridBuilder().addGrid(est.getParam(grid_param), values).build()
    return module.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=evaluator, numFolds=folds,
                                 seed=seed)


def _assert_folds_released(folds):
    """The 2 x folds frames _kFold_spark caches up front are each
    unpersisted."""
    events = list(_FakeSparkDataFrame.events)
    assert [e for e, _ in events[: 2 * folds]] == ["cache"] * (2 * folds)
    for _, fid in events[: 2 * folds]:
        assert ("unpersist", fid) in events


CV_CASES = {
    "linreg": ("LinearRegression", dict(maxIter=30), "regParam", [0.0, 0.1, 1.0], "RegressionEvaluator", {}, 3, 17),
    "logreg": ("LogisticRegression", dict(maxIter=40), "regParam", [0.01, 0.5],
               "MulticlassClassificationEvaluator", {"metricName": "logLoss"}, 2, 5),
    # Spark's defaults (bootstrap, feature subsets): the port's folds fit on
    # 8 shards, the scatter engine on the JAX package's 8 CPU devices' draws
    "rf": ("RandomForestClassifier", dict(numTrees=3, seed=7), "maxDepth", [2, 3],
           "MulticlassClassificationEvaluator", {"metricName": "accuracy"}, 2, 11),
    # the JAX test's seed: both packages' k-means|| draw the same rows
    "kmeans": ("KMeans", dict(seed=4, maxIter=20), "k", [2, 3], "ClusteringEvaluator", {}, 2, 13),
}


def _cv_frame(case):
    if case == "kmeans":
        rng = np.random.default_rng(2)
        centers = rng.normal(size=(3, 6)) * 6
        X = np.concatenate([rng.normal(size=(120, 6)) + c for c in centers]).astype(np.float32)
        rng.shuffle(X)
        return pd.DataFrame({"features": list(X)})
    X, y, y_cls = _data(n=400 if case == "logreg" else (200 if case == "rf" else 600), d=4 if case == "rf" else 6,
                        seed=9 if case == "rf" else 21)
    label = y if case == "linreg" else y_cls
    return pd.DataFrame({"features": list(X), "label": label.astype(np.float64)})


@pytest.mark.parametrize("case", sorted(CV_CASES))
def test_cross_validation_runs_on_the_cluster(case):
    est_name, est_params, grid_param, values, eva_name, eva_params, folds, seed = CV_CASES[case]
    sdf, df = _frames(_cv_frame(case))

    def cv(module, tuning_module, eval_module):
        est = getattr(module, est_name)(**est_params)
        return _cv(tuning_module, est, grid_param, values, getattr(eval_module, eva_name)(**eva_params), folds,
                   seed)

    with use_device(["cpu"] * 8) if case == "rf" else contextlib.nullcontext():
        got = cv(port, tuning, evaluation).fit(sdf)
        _assert_folds_released(folds)
        local = cv(port, tuning, evaluation)._fit(df, batched=False)
    want = cv(ref, ref_tuning, ref_evaluation).fit(sdf)
    # the cluster route is the port's local fold loop on the same folds
    if case == "kmeans":
        np.testing.assert_allclose(got.avgMetrics, local.avgMetrics, rtol=1e-12)
    else:
        assert got.avgMetrics == local.avgMetrics and got.stdMetrics == local.stdMetrics
    best = {"linreg": "regParam", "logreg": "regParam", "kmeans": "k"}.get(case)
    if best is not None:
        assert got.bestModel.getOrDefault(best) == want.bestModel.getOrDefault(best)
    tol = {"linreg": 1e-4, "logreg": 1e-3, "rf": 0.05, "kmeans": 1e-3}[case]
    np.testing.assert_allclose(got.avgMetrics, want.avgMetrics, rtol=tol, atol=tol if case == "rf" else 0)


def test_each_fold_is_released_before_the_next_fold_fits(monkeypatch):
    sdf, _ = _frames(_cv_frame("linreg"))
    est = port.LinearRegression(maxIter=30)
    cv = _cv(tuning, est, "regParam", [0.0, 1.0], evaluation.RegressionEvaluator(), 3, 17)
    fits = []
    fit = type(est)._fit_internal

    def counting(self, dataset, paramMaps):
        fits.append(len(_FakeSparkDataFrame.events))
        return fit(self, dataset, paramMaps)

    monkeypatch.setattr(type(est), "_fit_internal", counting)
    cv.fit(sdf)
    events = _FakeSparkDataFrame.events
    # 3 folds x (train, valid) cached up front; fold i's two unpersists come
    # before fold i + 1's fit (the last fit is the best map's refit)
    assert [e for e, _ in events[:6]] == ["cache"] * 6
    for i in range(1, 3):
        assert [e for e, _ in events[: fits[i]]].count("unpersist") >= 2 * i
