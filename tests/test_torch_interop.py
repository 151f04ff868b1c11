# cpu() interop (spark_rapids_ml_tpu_torch/spark/interop.py) against the
# JAX package's (spark_rapids_ml_tpu/spark/interop.py), without pyspark: the
# py4j construction runs against a recording mock of the JVM gateway (the
# JAX package's tests/test_interop.py mock, this file's own copy), and each
# model's cpu() against a fake pyspark whose constructors record their
# arguments.  Gates: trees_to_dicts is equal across the packages, and
# _build_java_tree records the same calls, for a JAX forest carried into the
# port and for forests each package fits on the same data (Spark's defaults,
# bootstrap and feature subsets on, the port on 8 shards against the JAX
# package's 8 CPU devices: the same draws, so the trees agree split for
# split); every model's
# cpu() builds the same Java model and copies the same params in both; and
# without pyspark cpu() raises the JAX package's ImportError.
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.spark import adapter as ref_adapter
from spark_rapids_ml_tpu.spark.interop import _build_java_tree as ref_build_java_tree

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.spark import adapter
from spark_rapids_ml_tpu_torch.spark.interop import _build_java_tree


@pytest.fixture(autouse=True)
def _cpu():
    with use_device("cpu"):
        yield


class _Recorder:
    """The py4j jvm attribute chain: every call returns a node record."""

    def __init__(self, path=""):
        self.path = path

    def __getattr__(self, name):
        return _Recorder(f"{self.path}.{name}" if self.path else name)

    def __call__(self, *args):
        if self.path.endswith("java.util.ArrayList"):
            return _JavaList()
        return {"cls": self.path, "args": args}


class _JavaList(list):
    def add(self, item):
        self.append(item)


class _Gateway:
    def new_array(self, cls, n):
        return [None] * n


def _mock_sc():
    return SimpleNamespace(_jvm=_Recorder(), _gateway=_Gateway())


def _forest_data(classification, n=300, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32) if classification else (2 * X[:, 0] - X[:, 2]).astype(np.float32)
    return X, y


def _ref_forest(classification, **extra):
    X, y = _forest_data(classification)
    cls = ref.RandomForestClassifier if classification else ref.RandomForestRegressor
    return cls(numTrees=3, maxDepth=3, seed=7, **extra).fit(RefDataFrame.from_numpy(X, y=y, num_partitions=2))


def _carried(ref_model):
    return adapter.deserialize_model(ref_adapter.serialize_model(ref_model))


@pytest.mark.parametrize("impurity", ["gini", "entropy", "variance"])
def test_carried_forest_exports_and_builds_the_same_trees(impurity):
    ref_model = _ref_forest(classification=impurity != "variance")
    model = _carried(ref_model)
    trees = model.trees_to_dicts()
    assert trees == ref_model.trees_to_dicts() and len(trees) == 3
    for t in range(3):
        assert _build_java_tree(_mock_sc(), impurity, trees[t]) == ref_build_java_tree(_mock_sc(), impurity, trees[t])
    node = _build_java_tree(_mock_sc(), impurity, trees[0])
    assert node["cls"].endswith("ml.tree.InternalNode")
    split = node["args"][5]
    assert split["cls"].endswith("ml.tree.ContinuousSplit") and 0 <= split["args"][0] < 4


def _splits(node, out):
    """(feature, threshold) of every internal node, and the leaf count."""
    if "split_feature" in node:
        out.append((node["split_feature"], node["threshold"]))
        _splits(node["yes"], out)
        _splits(node["no"], out)
    else:
        out.append(("leaf", len(node["leaf_value"])))
    return out


def _gains(node, out):
    if "split_feature" in node:
        out.append(node["gain"])
        _gains(node["yes"], out)
        _gains(node["no"], out)
    return out


@pytest.mark.parametrize("classification", [True, False], ids=["classifier", "regressor"])
def test_forests_fitted_on_the_same_data_export_the_same_trees(classification):
    # Spark's defaults (bootstrap, feature subsets), the port on 8 shards:
    # the scatter engine on the JAX package's 8 CPU devices' draws
    ref_model = _ref_forest(classification)
    X, y = _forest_data(classification)
    cls = port.RandomForestClassifier if classification else port.RandomForestRegressor
    with use_device(["cpu"] * 8):
        model = cls(numTrees=3, maxDepth=3, seed=7).fit(port.DataFrame.from_numpy(X, y=y, num_partitions=2))
    got, want = model.trees_to_dicts(), ref_model.trees_to_dicts()
    impurity = "gini" if classification else "variance"
    for g, w in zip(got, want):
        assert _splits(g, []) == _splits(w, [])
        np.testing.assert_allclose(_gains(g, []), _gains(w, []), rtol=1e-5, atol=1e-7)
        calls, ref_calls = _build_java_tree(_mock_sc(), impurity, g), ref_build_java_tree(_mock_sc(), impurity, w)
        assert _call_classes(calls, []) == _call_classes(ref_calls, [])


def _call_classes(node, out):
    if isinstance(node, dict) and "cls" in node:
        out.append(node["cls"])
        for a in node["args"]:
            _call_classes(a, out)
    return out


def test_unknown_impurity_rejected():
    model = _carried(_ref_forest(classification=True))
    with pytest.raises(ValueError, match="unsupported impurity"):
        _build_java_tree(_mock_sc(), "bogus", model.trees_to_dicts()[0])


# -- every model's cpu() ------------------------------------------------------------------


def _fit_pair(name):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((120, 5)).astype(np.float32)
    y = (X[:, 0] - X[:, 2] > 0).astype(np.float32)
    if name == "KMeans":
        ref_model = ref.KMeans(k=3, maxIter=5, seed=1).fit(RefDataFrame.from_numpy(X))
    elif name == "PCA":
        ref_model = ref.PCA(k=2).fit(RefDataFrame.from_numpy(X))
    elif name == "LinearRegression":
        ref_model = ref.LinearRegression().fit(RefDataFrame.from_numpy(X, X[:, 1] + 0.5))
    elif name == "LogisticRegression":
        ref_model = ref.LogisticRegression(maxIter=10).fit(RefDataFrame.from_numpy(X, y))
    elif name == "RandomForestClassifier":
        ref_model = ref.RandomForestClassifier(numTrees=2, maxDepth=3, seed=2).fit(RefDataFrame.from_numpy(X, y))
    else:
        ref_model = ref.RandomForestRegressor(numTrees=2, maxDepth=3, seed=2).fit(RefDataFrame.from_numpy(X, X[:, 0]))
    return _carried(ref_model), ref_model


MODELS = ["KMeans", "PCA", "LinearRegression", "LogisticRegression", "RandomForestClassifier",
          "RandomForestRegressor"]


@pytest.mark.parametrize("name", MODELS)
def test_cpu_without_pyspark_raises_the_jax_import_error(name):
    model, ref_model = _fit_pair(name)
    errors = []
    for m in (model, ref_model):
        with pytest.raises(ImportError) as err:
            m.cpu()
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "requires pyspark" in errors[0]


def test_umap_model_has_no_cpu_in_either_package():
    assert not hasattr(port.UMAPModel, "cpu") and not hasattr(ref.UMAPModel, "cpu")


class _SparkModel:
    """A pyspark.ml model class: keeps its Java model and the params copied
    into it."""

    _names = ("featuresCol", "predictionCol", "k", "probabilityCol", "outputCol", "labelCol")

    def __init__(self, java_model):
        self.java_model = java_model
        self._paramMap, self._defaultParamMap = {}, {}

    def hasParam(self, name):
        return name in self._names

    def getParam(self, name):
        return name


def _spark_class(name):
    return type(name, (_SparkModel,), {})


def _tag(name):
    return lambda *args: (name, tuple(a.tolist() if isinstance(a, np.ndarray) else a for a in args))


@pytest.fixture()
def fake_pyspark(monkeypatch):
    sc = _mock_sc()
    session = SimpleNamespace(sparkContext=sc)
    mods = {n: types.ModuleType(n) for n in (
        "pyspark", "pyspark.sql", "pyspark.ml", "pyspark.ml.common", "pyspark.ml.linalg", "pyspark.ml.feature",
        "pyspark.ml.clustering", "pyspark.ml.classification", "pyspark.ml.regression")}
    mods["pyspark.sql"].SparkSession = SimpleNamespace(getActiveSession=lambda: session)
    mods["pyspark.ml.common"]._py2java = lambda sc_, obj: ("py2java", obj)
    mods["pyspark.ml.linalg"].DenseVector = lambda values: ("DenseVector", tuple(float(v) for v in values))
    mods["pyspark.ml.linalg"].DenseMatrix = lambda n, k, values, t: ("DenseMatrix", n, k, tuple(values), t)
    mods["pyspark.ml.linalg"].Vectors = SimpleNamespace(dense=_tag("dense"), sparse=_tag("sparse"))
    mods["pyspark.ml.feature"].PCAModel = _spark_class("PCAModel")
    mods["pyspark.ml.clustering"].KMeansModel = _spark_class("KMeansModel")
    for n in ("LogisticRegressionModel", "RandomForestClassificationModel"):
        setattr(mods["pyspark.ml.classification"], n, _spark_class(n))
    for n in ("LinearRegressionModel", "RandomForestRegressionModel"):
        setattr(mods["pyspark.ml.regression"], n, _spark_class(n))
    for n, m in mods.items():
        monkeypatch.setitem(sys.modules, n, m)


def _normalised(obj):
    """A recorded call tree with the (random) Java uids masked."""
    if isinstance(obj, dict):
        if obj.get("cls", "").endswith("Identifiable.randomUID"):
            return "uid"
        return {k: _normalised(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_normalised(v) for v in obj)
    return obj


@pytest.mark.parametrize("name", MODELS)
def test_cpu_builds_the_jax_packages_java_model(fake_pyspark, name):
    model, ref_model = _fit_pair(name)
    got, want = model.cpu(), ref_model.cpu()
    assert type(got).__name__ == type(want).__name__
    assert _normalised(got.java_model) == _normalised(want.java_model)
    assert got._paramMap == want._paramMap
    assert got._defaultParamMap == want._defaultParamMap
