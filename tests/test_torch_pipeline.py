# The port's Pipeline / PipelineModel (spark_rapids_ml_tpu_torch.pipeline)
# on the CPU: fit -> transform -> save -> load, against the JAX package's
# pipeline on the same numpy inputs, and the ambiguous-stage error.
#
# Tolerances: the PCA projections to 1e-4 absolute and the logistic
# probabilities to 1e-3 (the port's single fits' tolerances against the JAX
# package's); a reloaded pipeline's outputs bit for bit.
import numpy as np
import pytest

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.device import use_device


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield
    port.clear_fit_cache()


def _cls(n=200, d=10, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n).astype(np.float32)
    X = (rng.normal(size=(n, d)) + 3.0 * y[:, None]).astype(np.float32)
    return X, y


def _col(df, name):
    return np.concatenate([p[name] for p in df.partitions])


def _stages(package):
    pca = package.PCA(k=4).setInputCol("features").setOutputCol("pca_features")
    lr = package.LogisticRegression(maxIter=100, regParam=0.01).setFeaturesCol("pca_features").setLabelCol("label")
    return [pca, lr]


def test_pipeline_fit_transform_matches_reference():
    X, y = _cls()
    pm = port.Pipeline(_stages(port)).fit(port.DataFrame.from_numpy(X, y, num_partitions=3))
    assert isinstance(pm, port.PipelineModel) and len(pm.stages) == 2
    out = pm.transform(port.DataFrame.from_numpy(X, y, num_partitions=3))
    assert {"pca_features", "prediction", "probability"} <= set(out.columns)
    assert (_col(out, "prediction") == y).mean() > 0.9
    ref_out = ref.Pipeline(_stages(ref)).fit(RefDataFrame.from_numpy(X, y=y, num_partitions=3)).transform(
        RefDataFrame.from_numpy(X, y=y, num_partitions=3)).toPandas()
    np.testing.assert_allclose(_col(out, "pca_features"), np.stack(ref_out["pca_features"]), atol=1e-4)
    np.testing.assert_allclose(_col(out, "probability"), np.stack(ref_out["probability"]), atol=1e-3)


def test_pipeline_single_estimator_and_get_stages():
    X, y = _cls(n=80)
    p = port.Pipeline().setStages([port.KMeans(k=2, maxIter=20, seed=1)])
    assert len(p.getStages()) == 1
    assert "prediction" in p.fit(port.DataFrame.from_numpy(X, y)).transform(port.DataFrame.from_numpy(X)).columns


def test_pipeline_persistence(tmp_path):
    X, y = _cls(n=120)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    pipe = port.Pipeline(_stages(port))
    pipe.save(str(tmp_path / "pipe"))
    p2 = port.load(str(tmp_path / "pipe"))
    assert isinstance(p2, port.Pipeline)
    assert [type(s).__name__ for s in p2.getStages()] == ["PCA", "LogisticRegression"]
    pm = pipe.fit(df)
    pm.save(str(tmp_path / "pm"))
    pm2 = port.load(str(tmp_path / "pm"))
    assert isinstance(pm2, port.PipelineModel)
    for col in ("pca_features", "prediction", "probability"):
        np.testing.assert_array_equal(_col(pm.transform(df), col), _col(pm2.transform(df), col))


def test_pipeline_ambiguous_stage_fails_loudly_and_role_disambiguates():
    X, y = _cls(n=40)
    df = port.DataFrame.from_numpy(X, y)

    class SklearnStyle:
        def __init__(self):
            self.fitted, self.fit_calls = False, 0

        def fit(self, dataset):
            self.fitted = True
            self.fit_calls += 1
            return self

        def transform(self, dataset):
            assert self.fitted, "transform before fit"
            return dataset

    with pytest.raises(TypeError, match="Ambiguous pipeline stage"):
        port.Pipeline([SklearnStyle(), port.KMeans(k=2, maxIter=5, seed=1)]).fit(df)
    bad = SklearnStyle()
    bad.srml_stage_role = "Transformer"
    with pytest.raises(TypeError, match="unrecognized srml_stage_role"):
        port.Pipeline([bad, port.KMeans(k=2, maxIter=5, seed=1)]).fit(df)
    est_stage = SklearnStyle()
    est_stage.srml_stage_role = "estimator"
    pm = port.Pipeline([est_stage, port.KMeans(k=2, maxIter=5, seed=1)]).fit(df)
    assert est_stage.fitted and "prediction" in pm.transform(df).columns
    tr_stage = SklearnStyle()
    tr_stage.fitted = True
    tr_stage.srml_stage_role = "transformer"
    port.Pipeline([tr_stage, port.KMeans(k=2, maxIter=5, seed=1)]).fit(df)
    assert tr_stage.fit_calls == 0
