# transform() and _transformEvaluate of a live pyspark DataFrame run batch
# by batch on the Spark executors (spark/adapter.executor_transform /
# executor_transform_evaluate) in the port, as in the JAX package: the frame
# is never collected (spark_to_facade is patched to fail in both packages).
# pyspark is not installed, so the surface the routes touch (schema fields'
# simpleString, mapInPandas, collect) is a fake, this file's own copy of the
# JAX package's tests/test_spark_executor_transform.py fake.
#
# Each model is fitted once by the JAX package and carried into the port
# through the JAX adapter's own payload (ref serialize_model -> port
# deserialize_model), so both packages transform the same fake frame with
# the same model: KMeans, PCA, UMAP, logistic regression and the forest
# classifier, an empty partition's schema, and the linear and logistic
# transform-evaluate.  The port's executor output is also bit for bit its
# local transform of the same rows.
import types

import numpy as np
import pandas as pd
import pytest

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as RefMulticlassEvaluator
from spark_rapids_ml_tpu.evaluation import RegressionEvaluator as RefRegressionEvaluator
from spark_rapids_ml_tpu.spark import adapter as ref_adapter

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.evaluation import MulticlassClassificationEvaluator, RegressionEvaluator
from spark_rapids_ml_tpu_torch.spark import adapter


class _FakeField:
    def __init__(self, name: str, ddl: str):
        self.name = name
        self.dataType = types.SimpleNamespace(simpleString=lambda: ddl)


class _FakeTransformSparkDataFrame:
    """Schema introspection, mapInPandas and collect of pyspark.sql.DataFrame,
    and no toPandas."""

    def __init__(self, partitions, fields):
        self._partitions = partitions
        self._fields = fields
        self.schema_ddl = None

    @property
    def schema(self):
        return types.SimpleNamespace(fields=list(self._fields))

    @property
    def columns(self):
        return [f.name for f in self._fields]

    def mapInPandas(self, udf, schema=None):
        out_parts, out_fields = [], None
        for part in self._partitions:
            chunks = list(udf(iter([part])))
            if chunks:
                pdf = pd.concat(chunks, ignore_index=True)
                out_parts.append(pdf)
                if out_fields is None:
                    out_fields = [_FakeField(c, "?") for c in pdf.columns]
        out = _FakeTransformSparkDataFrame(out_parts, out_fields or [])
        out.schema_ddl = schema
        return out

    def collect(self):
        rows = []
        for part in self._partitions:
            rows.extend(part.to_dict("records"))
        return rows

    # test helper, not pyspark surface
    def _materialize(self) -> pd.DataFrame:
        return pd.concat(self._partitions, ignore_index=True)


_FakeTransformSparkDataFrame.__module__ = "pyspark.sql.dataframe"


@pytest.fixture(autouse=True)
def _no_driver_collect(monkeypatch):
    def _boom(sdf):
        raise AssertionError("transform collected the dataset to the driver")

    monkeypatch.setattr(adapter, "spark_to_facade", _boom)
    monkeypatch.setattr(ref_adapter, "spark_to_facade", _boom)
    monkeypatch.delenv("SRML_SPARK_COLLECT", raising=False)
    with use_device("cpu"):
        yield


def _data(n=400, d=6, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = (X @ w + 0.05 * rng.standard_normal(n)).astype(np.float32)
    y_cls = (X @ w > 0).astype(np.float32)
    return X, y, y_cls


def _fake_sdf(X, y=None, n_parts=3):
    fields = [_FakeField("features", "array<float>"), _FakeField("rowid", "bigint")]
    if y is not None:
        fields.append(_FakeField("label", "double"))
    parts = []
    for ix in np.array_split(np.arange(len(X)), n_parts):
        pdf = pd.DataFrame({"features": list(X[ix]), "rowid": ix})
        if y is not None:
            pdf["label"] = y[ix]
        parts.append(pdf.reset_index(drop=True))
    return _FakeTransformSparkDataFrame(parts, fields)


def _carried(ref_model):
    """The JAX model carried into the port through the JAX adapter's
    payload."""
    return adapter.deserialize_model(ref_adapter.serialize_model(ref_model))


def _col(pdf, name):
    values = pdf[name].to_numpy()
    return np.stack(values) if values.dtype == object else values


def _port_frame(X, y=None, n_parts=3):
    """A port frame cut into the fake frame's partitions (np.array_split)."""
    parts = []
    for ix in np.array_split(np.arange(len(X)), n_parts):
        parts.append({"features": X[ix]} if y is None else {"features": X[ix], "label": y[ix]})
    return port.DataFrame(parts)


def _local(model, X, name, n_parts=3):
    return np.concatenate([p[name] for p in model.transform(_port_frame(X, n_parts=n_parts)).partitions])


def _fit(kind, X, y, y_cls):
    if kind == "kmeans":
        return ref.KMeans(k=3, maxIter=10, seed=1).fit(RefDataFrame.from_numpy(X)), ["prediction"]
    if kind == "pca":
        return ref.PCA(k=2).fit(RefDataFrame.from_numpy(X)), ["pca_features"]
    if kind == "logreg":
        return (ref.LogisticRegression(maxIter=40, regParam=0.01).fit(RefDataFrame.from_numpy(X, y_cls)),
                ["prediction", "probability", "rawPrediction"])
    if kind == "rf":
        return (ref.RandomForestClassifier(numTrees=6, maxDepth=4, maxBins=16, seed=5).fit(
            RefDataFrame.from_numpy(X, y_cls)), ["prediction", "probability", "rawPrediction"])
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["kmeans", "pca", "logreg", "rf"])
def test_transform_runs_on_the_executors(kind):
    X, y, y_cls = _data()
    ref_model, outputs = _fit(kind, X, y, y_cls)
    model = _carried(ref_model)
    sdf = _fake_sdf(X)
    out = model.transform(sdf)
    assert isinstance(out, _FakeTransformSparkDataFrame)  # still a "pyspark" frame
    assert out.schema_ddl == ref_adapter.transform_output_ddl(ref_model, sdf)
    got = out._materialize()
    want = ref_model.transform(sdf)._materialize()
    assert list(got.columns) == list(want.columns)
    np.testing.assert_array_equal(got["rowid"].to_numpy(), np.arange(len(X)))
    for name in outputs:
        g, w = _col(got, name), _col(want, name)
        assert g.dtype == w.dtype, name
        # the executor output is the port's local transform, bit for bit
        np.testing.assert_array_equal(g, _local(model, X, name), err_msg=name)
        if kind == "pca" or name != "prediction":
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    if kind == "kmeans":
        assert got["prediction"].dtype == np.int32


def test_umap_transform_runs_on_the_executors():
    # integer rows: both packages' kNN distances are exact, so both
    # transforms start from the same graph (tests/test_torch_umap.py)
    rng = np.random.default_rng(3)
    centers = rng.integers(-30, 30, size=(3, 8))
    X = (centers[rng.integers(0, 3, size=260)] + rng.integers(-3, 4, size=(260, 8))).astype(np.float32)
    ref_model = ref.UMAP(n_neighbors=10, random_state=2, n_epochs=3).fit(RefDataFrame.from_numpy(X[:200]))
    model = _carried(ref_model)
    sdf = _fake_sdf(X[200:], n_parts=2)
    got = _col(model.transform(sdf)._materialize(), "embedding")
    want = _col(ref_model.transform(sdf)._materialize(), "embedding")
    assert got.shape == (60, 2) and np.isfinite(got).all()
    local = _local(model, X[200:], "embedding", n_parts=2)
    np.testing.assert_array_equal(got, local)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("kind", ["kmeans", "logreg"])
def test_empty_partition_keeps_the_schema(kind):
    X, y, y_cls = _data(n=60)
    ref_model, outputs = _fit(kind, X, y, y_cls)
    model = _carried(ref_model)
    sdf = _fake_sdf(X, n_parts=2)
    sdf._partitions.insert(1, sdf._partitions[0].iloc[:0].copy())
    got = model.transform(sdf)._materialize()
    want = ref_model.transform(sdf)._materialize()
    assert len(got) == len(X) and list(got.columns) == list(want.columns)
    for name in outputs:
        np.testing.assert_array_equal(_col(got, name), _local(model, X, name, n_parts=2))


@pytest.mark.parametrize("metric", ["accuracy", "logLoss", "f1"])
def test_logreg_transform_evaluate_on_the_executors(metric):
    X, _, y_cls = _data()
    ref_model = ref.LogisticRegression(maxIter=40, regParam=0.01).fit(RefDataFrame.from_numpy(X, y_cls))
    model = _carried(ref_model)
    sdf = _fake_sdf(X, y=y_cls)
    got = model._transformEvaluate(sdf, MulticlassClassificationEvaluator(metricName=metric))
    local = model._transformEvaluate(_port_frame(X, y_cls), MulticlassClassificationEvaluator(metricName=metric))
    want = ref_model._transformEvaluate(sdf, RefMulticlassEvaluator(metricName=metric))
    assert got == local
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("metric", ["rmse", "r2", "mae"])
def test_linreg_transform_evaluate_on_the_executors(metric):
    X, y, _ = _data()
    ref_est = ref.LinearRegression(maxIter=30)
    ref_models = ref_est.fit(RefDataFrame.from_numpy(X, y), [{ref_est.getParam("regParam"): r} for r in (0.0, 0.3)])
    models = [_carried(m) for m in ref_models]
    combined = type(models[0])._combine(models)
    ref_combined = type(ref_models[0])._combine(ref_models)
    sdf = _fake_sdf(X, y=y)
    got = combined._transformEvaluate(sdf, RegressionEvaluator(metricName=metric))
    local = combined._transformEvaluate(_port_frame(X, y), RegressionEvaluator(metricName=metric))
    want = ref_combined._transformEvaluate(sdf, RefRegressionEvaluator(metricName=metric))
    assert len(got) == 2 and got == local
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_collect_override_routes_to_driver_local(monkeypatch):
    """SRML_SPARK_COLLECT=1 leaves the executor route in both packages: the
    port collects through spark_to_facade (patched to fail); the JAX
    package, which recognises a pyspark frame only with pyspark installed,
    refuses the fake."""
    monkeypatch.setenv("SRML_SPARK_COLLECT", "1")
    X, _, _ = _data(n=60)
    ref_model = ref.KMeans(k=2, maxIter=5, seed=1).fit(RefDataFrame.from_numpy(X))
    with pytest.raises(TypeError):
        ref_model.transform(_fake_sdf(X))
    with pytest.raises(AssertionError, match="collected"):
        _carried(ref_model).transform(_fake_sdf(X))
