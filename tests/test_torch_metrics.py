# The port's metric modules (spark_rapids_ml_tpu_torch.metrics) and
# evaluators (evaluation.py) against the JAX package's on the same
# predictions, on the CPU: each metric's value from partition partials
# merged equals its value over the whole column, and equals the JAX
# package's, to 1e-12 relative (both are the same float64 numpy code; only
# the merge order of partials can move the last bits).
from functools import reduce

import numpy as np
import pytest

from spark_rapids_ml_tpu import evaluation as ref_evaluation
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.metrics import binary as ref_binary
from spark_rapids_ml_tpu.metrics import clustering as ref_clustering
from spark_rapids_ml_tpu.metrics import multiclass as ref_multiclass
from spark_rapids_ml_tpu.metrics import regression as ref_regression

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import evaluation
from spark_rapids_ml_tpu_torch.metrics import binary, clustering, multiclass, regression

RTOL = 1e-12
PARTS = 3


def _close(a, b):
    assert abs(a - b) <= RTOL * max(1.0, abs(b)), (a, b)


def _frames(cols):
    """The same columns as a port frame and a JAX-package frame of PARTS
    partitions (2-D columns become the JAX package's vector columns)."""
    import pandas as pd

    pdf = pd.DataFrame({k: list(v) if v.ndim == 2 else v for k, v in cols.items()})
    return port.DataFrame.from_pandas(pdf, PARTS), RefDataFrame.from_pandas(pdf, PARTS)


def _merged(module_cls, *arrays, **kw):
    parts = zip(*(np.array_split(a, PARTS) for a in arrays))
    return reduce(lambda a, b: a.merge(b), (module_cls.from_arrays(*p, **kw) for p in parts))


@pytest.mark.parametrize("name", ["rmse", "mse", "r2", "mae", "var"])
def test_regression_metrics_match_reference(name):
    rng = np.random.default_rng(0)
    labels = rng.normal(size=500) * 3 + 1
    preds = labels + rng.normal(size=500)
    ours_e = evaluation.RegressionEvaluator(metricName=name)
    theirs_e = ref_evaluation.RegressionEvaluator(metricName=name)
    merged = _merged(regression.RegressionMetrics, labels, preds).evaluate(ours_e)
    _close(merged, regression.RegressionMetrics.from_arrays(labels, preds).evaluate(ours_e))
    _close(merged, _merged(ref_regression.RegressionMetrics, labels, preds).evaluate(theirs_e))
    df, ref_df = _frames({"label": labels, "prediction": preds})
    _close(ours_e.evaluate(df), theirs_e.evaluate(ref_df))


MULTICLASS_METRICS = [
    "f1", "accuracy", "weightedPrecision", "weightedRecall", "weightedTruePositiveRate",
    "weightedFalsePositiveRate", "weightedFMeasure", "truePositiveRateByLabel", "falsePositiveRateByLabel",
    "precisionByLabel", "recallByLabel", "fMeasureByLabel", "hammingLoss", "logLoss",
]


@pytest.mark.parametrize("name", MULTICLASS_METRICS)
def test_multiclass_metrics_match_reference(name):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 3, size=400).astype(np.float64)
    probs = rng.dirichlet(np.ones(3), size=400)
    probs[np.arange(400), labels.astype(int)] += 0.5
    probs /= probs.sum(axis=1, keepdims=True)
    preds = probs.argmax(axis=1).astype(np.float64)
    kw = dict(metricName=name, metricLabel=1.0, beta=0.5)
    ours_e, theirs_e = evaluation.MulticlassClassificationEvaluator(**kw), ref_evaluation.MulticlassClassificationEvaluator(**kw)
    merged = _merged(multiclass.MulticlassMetrics, labels, preds, probs, eps=1e-15).evaluate(ours_e)
    _close(merged, multiclass.MulticlassMetrics.from_arrays(labels, preds, probs, eps=1e-15).evaluate(ours_e))
    _close(merged, _merged(ref_multiclass.MulticlassMetrics, labels, preds, probs, eps=1e-15).evaluate(theirs_e))
    df, ref_df = _frames({"label": labels, "prediction": preds, "probability": probs})
    _close(ours_e.evaluate(df), theirs_e.evaluate(ref_df))


def test_log_loss_eps():
    assert evaluation.MulticlassClassificationEvaluator().getEps() == 1e-15
    probs = np.array([[1.0, 0.0], [0.0, 1.0]])
    labels = np.array([1.0, 1.0])
    assert multiclass.log_loss(labels, probs, 1e-15) == ref_multiclass.log_loss(labels, probs, 1e-15)


@pytest.mark.parametrize("name", ["areaUnderROC", "areaUnderPR"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_binary_metrics_match_reference(name, weighted):
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 2, size=600).astype(np.float64)
    scores = np.round(labels + rng.normal(size=600), 1)  # ties across partitions
    w = rng.uniform(0.5, 2.0, size=600) if weighted else None
    ours_e = evaluation.BinaryClassificationEvaluator(metricName=name)
    theirs_e = ref_evaluation.BinaryClassificationEvaluator(metricName=name)
    args = (labels, scores) if w is None else (labels, scores, w)
    merged = _merged(binary.BinaryClassificationMetrics, *args).evaluate(ours_e)
    _close(merged, binary.BinaryClassificationMetrics.from_arrays(*args).evaluate(ours_e))
    _close(merged, _merged(ref_binary.BinaryClassificationMetrics, *args).evaluate(theirs_e))
    raw = np.stack([-scores, scores], axis=1)
    cols = {"label": labels, "rawPrediction": raw}
    if weighted:
        cols["weight"] = w
        ours_e.set(ours_e.getParam("weightCol"), "weight")
        theirs_e.set(theirs_e.getParam("weightCol"), "weight")
    df, ref_df = _frames(cols)
    _close(ours_e.evaluate(df), theirs_e.evaluate(ref_df))


def test_silhouette_matches_reference():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(4, 5)) * 5
    preds = rng.integers(0, 4, size=300)
    X = centers[preds] + rng.normal(size=(300, 5))
    feats, labels = np.array_split(X, PARTS), np.array_split(preds, PARTS)
    ours = clustering.silhouette_score(feats, labels, 4)
    _close(ours, ref_clustering.silhouette_score(feats, labels, 4))
    stats = reduce(lambda a, b: a.merge(b), (clustering.ClusterStats.from_arrays(f, p, 4) for f, p in zip(feats, labels)))
    whole = clustering.ClusterStats.from_arrays(X, preds, 4)
    np.testing.assert_allclose(stats.s, whole.s, rtol=RTOL)
    np.testing.assert_array_equal(stats.n, whole.n)
    df, ref_df = _frames({"features": X, "prediction": preds.astype(np.float64)})
    _close(evaluation.ClusteringEvaluator().evaluate(df), ref_evaluation.ClusteringEvaluator().evaluate(ref_df))


class _FakeSparkFrame:
    """A live pyspark prediction frame: pandas partitions behind mapInPandas
    (chained stages) / collect / cache / unpersist."""

    def __init__(self, parts, udf=None):
        self._parts, self._udf = parts, udf

    def mapInPandas(self, udf, schema=None):
        if self._udf is None:
            return _FakeSparkFrame(self._parts, udf)
        prev = self._udf
        return _FakeSparkFrame(self._parts, lambda it: udf(x for p in it for x in prev(iter([p]))))

    def collect(self):
        return [r for p in self._parts for out in self._udf(iter([p])) for r in out.to_dict("records")]

    def cache(self):
        return self

    def unpersist(self):
        return self


_FakeSparkFrame.__module__ = "pyspark.sql.dataframe"


def test_live_spark_frames_are_refused():
    # a live frame is no longer refused (ROADMAP A14c-2): both packages score
    # it on the executors (spark/adapter.executor_evaluate), the port as its
    # local evaluate of the same partitions
    import pandas as pd

    rng = np.random.default_rng(4)
    n = 240
    label = rng.integers(0, 2, n).astype(np.float64)
    raw = rng.standard_normal((n, 2)) + 1.5 * np.eye(2)[label.astype(int)]
    centers = np.array([[0.0, 0.0], [5.0, 1.0]])
    pdf = pd.DataFrame({"label": label, "prediction": raw.argmax(1).astype(np.float64),
                        "probability": list(np.exp(raw) / np.exp(raw).sum(1, keepdims=True)),
                        "rawPrediction": list(raw), "features": list(centers[label.astype(int)] + rng.normal(size=(n, 2)))})
    parts = [pdf.iloc[ix].reset_index(drop=True) for ix in np.array_split(np.arange(n), PARTS)]
    frame = _FakeSparkFrame(parts)
    local = port.DataFrame([port.dataframe.partition_of(p) for p in parts])
    for name in ("RegressionEvaluator", "MulticlassClassificationEvaluator", "BinaryClassificationEvaluator"):
        got = getattr(evaluation, name)().evaluate(frame)
        assert got == getattr(evaluation, name)().evaluate(local)
        _close(got, getattr(ref_evaluation, name)().evaluate(frame))
    got = evaluation.ClusteringEvaluator().setPredictionCol("label").evaluate(frame)
    _close(got, evaluation.ClusteringEvaluator().setPredictionCol("label").evaluate(local))
    _close(got, ref_evaluation.ClusteringEvaluator().setPredictionCol("label").evaluate(frame))
