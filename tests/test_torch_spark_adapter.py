# The port's Spark adapter (spark_rapids_ml_tpu_torch/spark/adapter.py)
# against the JAX package's (spark_rapids_ml_tpu/spark/adapter.py), on the
# CPU and without pyspark: the stage-level scheduling decision table over the
# same conf dicts (the JAX "tpu" resource read as the port's "gpu"),
# infer_spark_num_workers, transform_output_ddl, ensure_id_col,
# spark_to_facade and the SRML_SPARK_COLLECT=1 override, the frame
# predicates, as_dataframe of a pyarrow Table, and a
# model payload serialized by the JAX adapter decoding in the port into a
# model whose transform equals the JAX model's.
import sys
import types

import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import KMeans as RefKMeans
from spark_rapids_ml_tpu import LogisticRegression as RefLogisticRegression
from spark_rapids_ml_tpu import core as ref_core
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.spark import adapter as ref_adapter

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import core
from spark_rapids_ml_tpu_torch.dataframe import as_dataframe
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.spark import adapter


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.delenv("SRML_SPARK_COLLECT", raising=False)
    with use_device("cpu"):
        yield


# -- the stage-level scheduling decision table ---------------------------------

GOOD_CONF = {
    "spark.master": "spark://host:7077",
    "spark.executor.cores": "8",
    "spark.executor.resource.{r}.amount": "1",
}

CONF_CASES = {
    "good": ("3.4.0", {}),
    "good_351": ("3.5.1", {}),
    "old_spark": ("3.3.2", {}),
    "yarn": ("3.4.0", {"spark.master": "yarn"}),
    "k8s": ("3.4.0", {"spark.master": "k8s://x"}),
    "local": ("3.4.0", {"spark.master": "local[4]"}),
    "no_master": ("3.4.0", {"spark.master": ""}),
    "local_cluster": ("3.4.0", {"spark.master": "local-cluster[2,4,1024]"}),
    "no_cores": ("3.4.0", {"spark.executor.cores": None}),
    "no_resource": ("3.4.0", {"spark.executor.resource.{r}.amount": None}),
    "one_core": ("3.4.0", {"spark.executor.cores": "1"}),
    "two_cards": ("3.4.0", {"spark.executor.resource.{r}.amount": "2"}),
    "task_whole": ("3.4.0", {"spark.task.resource.{r}.amount": "1"}),
    "task_half": ("3.4.0", {"spark.task.resource.{r}.amount": "0.5"}),
}


def _conf(resource, overrides):
    conf = {k.format(r=resource): v for k, v in GOOD_CONF.items()}
    for k, v in overrides.items():
        key = k.format(r=resource)
        if v is None:
            conf.pop(key, None)
        else:
            conf[key] = v
    return conf


@pytest.mark.parametrize("case", sorted(CONF_CASES))
def test_stage_level_decision_table_matches_the_jax_package(case):
    version, overrides = CONF_CASES[case]
    ref = ref_adapter.skip_stage_level_scheduling(version, _conf(ref_adapter.TPU_RESOURCE_NAME, overrides).get)
    got = adapter.skip_stage_level_scheduling(version, _conf(adapter.RESOURCE_NAME, overrides).get)
    assert got == ref.replace(ref_adapter.TPU_RESOURCE_NAME, adapter.RESOURCE_NAME)
    assert adapter.RESOURCE_NAME == "gpu"


class _Spark:
    def __init__(self, conf):
        self.sparkContext = types.SimpleNamespace(getConf=lambda: types.SimpleNamespace(get=conf.get))


@pytest.mark.parametrize("conf", [
    {adapter.NUM_WORKERS_CONF: "5"},
    {adapter.NUM_WORKERS_CONF: "5", "spark.executor.instances": "7"},
    {"spark.executor.instances": "7"},
    {"spark.executor.instances": "0"},
    {},
], ids=["own", "own_first", "instances", "zero_instances", "none"])
def test_infer_spark_num_workers_matches_the_jax_package(conf):
    assert adapter.NUM_WORKERS_CONF == ref_adapter.NUM_WORKERS_CONF
    est, ref_est = port.KMeans(k=2), RefKMeans(k=2)
    # the estimator's own num_workers (mesh devices) is never read
    est._num_workers = ref_est._num_workers = 3
    assert adapter.infer_spark_num_workers(est, _Spark(conf)) == ref_adapter.infer_spark_num_workers(
        ref_est, _Spark(conf)
    )


# -- frames ----------------------------------------------------------------------


class _Field:
    def __init__(self, name, ddl):
        self.name = name
        self.dataType = types.SimpleNamespace(simpleString=lambda d=ddl: d)


class _SchemaFrame:
    def __init__(self, fields):
        self.schema = types.SimpleNamespace(fields=[_Field(n, t) for n, t in fields])

    @property
    def columns(self):
        return [f.name for f in self.schema.fields]


def _data(n=200, d=5, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


@pytest.mark.parametrize("fields", [
    [("features", "array<float>"), ("rowid", "bigint")],
    [("features", "array<float>"), ("prediction", "string")],
    [("features", "array<double>"), ("probability", "double"), ("label", "double")],
], ids=["append", "replace_prediction", "replace_probability"])
@pytest.mark.parametrize("model", ["kmeans", "logreg"])
def test_transform_output_ddl_matches_the_jax_package(fields, model):
    X, y = _data()
    if model == "kmeans":
        got_model = port.KMeans(k=3, maxIter=5, seed=1).fit(port.DataFrame.from_numpy(X))
        ref_model = RefKMeans(k=3, maxIter=5, seed=1).fit(RefDataFrame.from_numpy(X))
    else:
        got_model = port.LogisticRegression(maxIter=5).fit(port.DataFrame.from_numpy(X, y))
        ref_model = RefLogisticRegression(maxIter=5).fit(RefDataFrame.from_numpy(X, y))
    frame = _SchemaFrame(fields)
    assert got_model._out_schema_fields() == ref_model._out_schema_fields()
    assert adapter.transform_output_ddl(got_model, frame) == ref_adapter.transform_output_ddl(ref_model, frame)


class _IdFrame:
    """withColumn(name, monotonically_increasing_id()) over one pandas
    partition: the ids the fake pyspark function hands out."""

    def __init__(self, pdf):
        self.pdf = pdf

    @property
    def columns(self):
        return list(self.pdf.columns)

    def withColumn(self, name, expr):
        out = self.pdf.copy()
        out[name] = (np.int64(3) << 33) + np.arange(len(out), dtype=np.int64)
        return _IdFrame(out)


@pytest.fixture()
def fake_functions(monkeypatch):
    mod = types.ModuleType("pyspark")
    sql = types.ModuleType("pyspark.sql")
    fns = types.ModuleType("pyspark.sql.functions")
    fns.monotonically_increasing_id = lambda: "mono"
    mod.sql, sql.functions = sql, fns
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    monkeypatch.setitem(sys.modules, "pyspark.sql", sql)
    monkeypatch.setitem(sys.modules, "pyspark.sql.functions", fns)


@pytest.mark.parametrize("id_col", ["unique_id", "rowid"])
def test_ensure_id_col_matches_the_jax_package(fake_functions, id_col):
    pdf = pd.DataFrame({"features": list(np.zeros((6, 2))), "rowid": np.arange(6, dtype=np.int64) * 5})
    got = adapter.ensure_id_col(_IdFrame(pdf), id_col)
    ref = ref_adapter.ensure_id_col(_IdFrame(pdf), id_col)
    assert got.columns == ref.columns
    np.testing.assert_array_equal(got.pdf[id_col].to_numpy(), ref.pdf[id_col].to_numpy())


class _CollectFrame:
    """A pyspark-typed frame that only collects: toPandas and
    rdd.getNumPartitions."""

    def __init__(self, pdf, n_parts):
        self._pdf = pdf
        self.rdd = types.SimpleNamespace(getNumPartitions=lambda: n_parts)

    def toPandas(self):
        return self._pdf.copy()


_CollectFrame.__module__ = "pyspark.sql.dataframe"


def test_spark_to_facade_matches_the_jax_package():
    X, y = _data(n=30)
    pdf = pd.DataFrame({"features": list(X), "label": y})
    got = adapter.spark_to_facade(_CollectFrame(pdf, 3))
    ref = ref_adapter.spark_to_facade(_CollectFrame(pdf, 3))
    assert got.num_partitions == ref.num_partitions == 3
    for gp, rp in zip(got.partitions, ref.partitions):
        np.testing.assert_array_equal(gp["features"], np.stack(rp["features"].to_numpy()))
        np.testing.assert_array_equal(gp["label"], rp["label"].to_numpy())


@pytest.mark.parametrize("collect", ["0", "1", None])
def test_frame_predicates_and_the_collect_override(monkeypatch, collect):
    if collect is None:
        monkeypatch.delenv("SRML_SPARK_COLLECT", raising=False)
    else:
        monkeypatch.setenv("SRML_SPARK_COLLECT", collect)
    live = _CollectFrame(pd.DataFrame({"a": [1.0]}), 1)
    for obj in (live, port.DataFrame.from_numpy(np.zeros((2, 2))), pd.DataFrame({"a": [1]}),
                types.SimpleNamespace()):
        assert core._is_pyspark_dataframe(obj) == ref_core._is_pyspark_dataframe(obj)
        assert core._use_executor_path(obj) == ref_core._use_executor_path(obj)
    assert core._use_executor_path(live) == (collect != "1")


def test_collect_override_fits_the_collected_frame(monkeypatch):
    """SRML_SPARK_COLLECT=1: fit and transform of a live frame collect it
    (spark_to_facade) and run driver-local, equal to the port frame's."""
    monkeypatch.setenv("SRML_SPARK_COLLECT", "1")
    X, _ = _data(n=90)
    live = _CollectFrame(pd.DataFrame({"features": list(X)}), 2)
    model = port.KMeans(k=3, maxIter=8, seed=2).fit(live)
    local = port.KMeans(k=3, maxIter=8, seed=2).fit(port.DataFrame.from_numpy(X, num_partitions=2))
    np.testing.assert_array_equal(model.cluster_centers_, local.cluster_centers_)
    got = np.concatenate([p["prediction"] for p in model.transform(live).partitions])
    want = np.concatenate([p["prediction"] for p in local.transform(port.DataFrame.from_numpy(X)).partitions])
    np.testing.assert_array_equal(got, want)


def test_as_dataframe_takes_a_pyarrow_table():
    pa = pytest.importorskip("pyarrow")
    X, y = _data(n=40)
    table = pa.Table.from_pandas(pd.DataFrame({"features": list(X), "label": y}))
    got = as_dataframe(table)
    ref = ref_core.as_dataframe(table)
    assert got.num_partitions == ref.num_partitions == 1
    for gp, rp in zip(got.partitions, ref.partitions):
        np.testing.assert_array_equal(gp["features"], np.stack(rp["features"].to_numpy()))
        np.testing.assert_array_equal(gp["label"], rp["label"].to_numpy())


# -- model transport ---------------------------------------------------------------


@pytest.mark.parametrize("model", ["kmeans", "logreg"])
def test_a_jax_serialized_payload_decodes_in_the_port(model):
    X, y = _data(n=120)
    if model == "kmeans":
        ref_model = RefKMeans(k=4, maxIter=6, seed=3).fit(RefDataFrame.from_numpy(X))
    else:
        ref_model = RefLogisticRegression(maxIter=10, regParam=0.01).fit(RefDataFrame.from_numpy(X, y))
    payload = ref_adapter.serialize_model(ref_model)
    got = adapter.deserialize_model(payload)
    assert type(got).__module__.startswith("spark_rapids_ml_tpu_torch.")
    assert type(got).__name__ == type(ref_model).__name__
    assert got.uid == ref_model.uid
    got_out = got.transform(port.DataFrame.from_numpy(X)).partitions[0]
    ref_out = ref_model.transform(RefDataFrame.from_numpy(X)).toPandas()
    np.testing.assert_array_equal(got_out["prediction"], ref_out["prediction"].to_numpy())
    # and the port's payload round-trips to the same model
    again = adapter.deserialize_model(adapter.serialize_model(got))
    np.testing.assert_array_equal(
        again.transform(port.DataFrame.from_numpy(X)).partitions[0]["prediction"], got_out["prediction"]
    )
