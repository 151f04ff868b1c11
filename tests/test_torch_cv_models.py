# CrossValidator over the port's forests and KMeans (the fold loop: their
# solvers take no candidate lanes), on the CPU: the forest's single-pass
# fitMultiple, _combine and _transformEvaluate against each sub-model's own
# evaluate(transform), exactly; forest CV end to end; KMeans CV with
# ClusteringEvaluator against the JAX package's silhouette of the same
# predictions (1e-12 relative: the same float64 numpy formula).
import numpy as np
import pytest

from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.evaluation import ClusteringEvaluator as RefClusteringEvaluator

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.device import use_device


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield
    port.clear_fit_cache()


def _col(df, name):
    return np.concatenate([p[name] for p in df.partitions])


@pytest.mark.parametrize("classification", [True, False], ids=["classifier", "regressor"])
def test_forest_combined_evaluation_equals_per_model_evaluation(classification):
    rng = np.random.default_rng(6)
    X = rng.normal(size=(240, 5)).astype(np.float32)
    if classification:
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
        est, eva = port.RandomForestClassifier(numTrees=4, seed=3), port.MulticlassClassificationEvaluator()
    else:
        y = (X[:, 0] * 2 + X[:, 1] ** 2).astype(np.float32)
        est, eva = port.RandomForestRegressor(numTrees=4, seed=3), port.RegressionEvaluator()
    train = port.DataFrame.from_numpy(X[:160], y[:160], num_partitions=2)
    valid = port.DataFrame.from_numpy(X[160:], y[160:], num_partitions=2)
    maps = [{est.getParam("maxDepth"): 2}, {est.getParam("maxDepth"): 5}]
    models = est.fit(train, maps)
    assert [m.getOrDefault("maxDepth") for m in models] == [2, 5]
    # a map's forest from the single pass equals the forest of its own fit
    alone = est.copy(maps[1]).fit(train)
    for name in ("features_", "thresholds_", "leaf_values_"):
        np.testing.assert_array_equal(getattr(models[1], name), getattr(alone, name))
    combined = models[0]._combine(models)
    assert combined._num_models == 2
    assert combined._transformEvaluate(valid, eva) == [eva.evaluate(m.transform(valid)) for m in models]
    with pytest.raises(AssertionError):
        combined.transform(valid)


def test_forest_cross_validation_picks_the_deeper_forest(tmp_path):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(240, 5)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    df = port.DataFrame.from_numpy(X, y, num_partitions=3)
    est = port.RandomForestClassifier(numTrees=5, seed=9)
    grid = port.ParamGridBuilder().addGrid(port.RandomForestClassifier.maxDepth, [1, 6]).build()
    eva = port.MulticlassClassificationEvaluator(metricName="accuracy")
    cv = port.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, numFolds=3)
    model = cv.fit(df)
    assert model.avgMetrics[1] > model.avgMetrics[0]
    assert model.bestModel.getOrDefault("maxDepth") == 6
    # a combined forest keeps its split into sub-models through save / load
    combined = port.RandomForestClassificationModel._combine([model.bestModel, model.bestModel])
    combined.save(str(tmp_path / "combined"))
    assert port.load(str(tmp_path / "combined"))._tree_counts == [5, 5]


def test_kmeans_cross_validation_silhouette_matches_reference():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(4, 6)) * 6
    X = (centers[rng.integers(0, 4, size=300)] + rng.normal(size=(300, 6))).astype(np.float32)
    df = port.DataFrame.from_numpy(X, num_partitions=3)
    grid = port.ParamGridBuilder().addGrid(port.KMeans.k, [2, 4]).build()
    cv = port.CrossValidator(estimator=port.KMeans(maxIter=20, seed=1), estimatorParamMaps=grid,
                             evaluator=port.ClusteringEvaluator(), numFolds=2, seed=3, collectSubModels=True)
    model = cv.fit(df)
    assert int(np.argmax(model.avgMetrics)) == 1  # four blobs
    # the JAX package's silhouette of the same fold predictions
    folds = df.randomSplit([1.0, 1.0], seed=3)
    want = np.zeros((2, 2))
    for f, valid in enumerate(folds):
        for i, sub in enumerate(model.subModels[f]):
            out = sub.transform(valid)
            ref_df = RefDataFrame.from_numpy(_col(out, "features"), num_partitions=1)
            pdf = ref_df.toPandas()
            pdf["prediction"] = _col(out, "prediction")
            want[f, i] = RefClusteringEvaluator().evaluate(RefDataFrame.from_pandas(pdf, 2))
    np.testing.assert_allclose(model.avgMetrics, want.mean(axis=0), rtol=1e-12)
