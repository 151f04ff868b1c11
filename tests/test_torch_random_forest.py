# The port's RandomForest (spark_rapids_ml_tpu_torch) against the JAX
# package's on the CPU, on the same numpy inputs (tree growth alone:
# tests/test_torch_forest_grow.py):
#   - the estimators through the public API against the JAX estimators (whose
#     CPU fit takes the scatter engine), bootstrap off and all features: the
#     JAX suite's growth-equivalence contract (shallow nodes >= 0.97 equal,
#     all nodes >= 0.85, accuracy or normalised MSE within 0.03);
#   - weights carried across (attributes and JAX-saved directories), save ->
#     load, and the fits past the limits of histogram growth (the scatter
#     engine, equal to the JAX estimator's forest).
import numpy as np
import pytest

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.convert import random_forest_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device

N, D = 2048, 8


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _classification(n=N, d=D, classes=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal((d, classes))).argmax(1).astype(np.float32)
    return X, y


def _regression(n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal(d) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y


# ---------------------------------------------------------------------------
# the estimators through the public API against the JAX estimators
# ---------------------------------------------------------------------------

SLICE = {
    "classifier": (4, dict(numTrees=2, maxDepth=6, maxBins=8, featureSubsetStrategy="all", bootstrap=False, seed=5)),
    "regressor": (None, dict(numTrees=2, maxDepth=7, maxBins=8, featureSubsetStrategy="all", bootstrap=False, seed=5)),
}


@pytest.fixture(scope="module", params=sorted(SLICE))
def fitted(request):
    classes, params = SLICE[request.param]
    if classes:
        X, y = _classification(classes=classes, seed=11)  # the JAX suite's deep-phase gate data
        ref_est, port_est = ref.RandomForestClassifier(**params), port.RandomForestClassifier(**params)
    else:
        X, y = _regression(seed=22)
        ref_est, port_est = ref.RandomForestRegressor(**params), port.RandomForestRegressor(**params)
    m_ref = ref_est.fit(RefDataFrame.from_numpy(X, y, num_partitions=2))
    with use_device("cpu"):
        m = port_est.fit(port.DataFrame.from_numpy(X, y, num_partitions=2))
    return request.param, X, y, m_ref, m


def _column(df, name):
    return np.concatenate([np.asarray(p[name]) for p in df.partitions])


def test_estimator_matches_reference(fitted):
    kind, X, y, m_ref, m = fitted
    assert m.features_.shape == m_ref.features_.shape
    shallow = slice(0, 2**5 - 1)
    assert (m.features_[:, shallow] == m_ref.features_[:, shallow]).mean() >= 0.97
    assert (m.features_ == m_ref.features_).mean() >= 0.85
    pred = _column(m.transform(port.DataFrame.from_numpy(X, num_partitions=3)), "prediction")
    pred_ref = m_ref.transform(RefDataFrame.from_numpy(X, num_partitions=3)).toPandas()["prediction"].to_numpy()
    if kind == "classifier":
        assert abs((pred == y).mean() - (pred_ref == y).mean()) < 0.03
        np.testing.assert_array_equal(m.classes_, m_ref.classes_)
    else:
        assert abs(((pred - y) ** 2).mean() - ((pred_ref - y) ** 2).mean()) / y.var() < 0.03


def test_output_columns(fitted):
    kind, X, y, m_ref, m = fitted
    out = m.transform(port.DataFrame.from_numpy(X, num_partitions=2))
    pred = _column(out, "prediction")
    assert m.predict(X[0]) == pred[0]
    if kind == "regressor":
        assert out.columns == ["features", "prediction"] and pred.dtype == np.float64
        return
    assert out.columns == ["features", "prediction", "probability", "rawPrediction"]
    prob, raw = _column(out, "probability"), _column(out, "rawPrediction")
    assert prob.shape == (N, 4) and np.allclose(prob.sum(1), 1.0)
    np.testing.assert_allclose(raw, prob * 2)
    np.testing.assert_array_equal(pred, m.classes_[prob.argmax(1)])


def test_weights_carried_across_give_identical_predictions(fitted):
    kind, X, _, m_ref, _ = fitted
    attrs = {k: np.asarray(v) for k, v in m_ref._get_model_attributes().items()}
    converted = random_forest_model_from_reference(attrs)
    out = converted.transform(port.DataFrame.from_numpy(X, num_partitions=2))
    ref_out = m_ref.transform(RefDataFrame.from_numpy(X, num_partitions=2)).toPandas()
    np.testing.assert_array_equal(_column(out, "prediction"), ref_out["prediction"].to_numpy())
    if kind == "classifier":
        np.testing.assert_allclose(
            _column(out, "probability"), np.stack(ref_out["probability"].to_numpy()), rtol=0, atol=1e-6
        )


def test_model_saved_by_reference_loads_in_port(fitted, tmp_path):
    kind, X, _, m_ref, _ = fitted
    m_ref.save(str(tmp_path / "ref_rf"))
    loaded = port.load(str(tmp_path / "ref_rf"))
    assert type(loaded).__name__ == type(m_ref).__name__
    assert loaded.getOrDefault("maxDepth") == m_ref.getOrDefault("maxDepth")
    out = loaded.transform(port.DataFrame.from_numpy(X))
    ref_out = m_ref.transform(RefDataFrame.from_numpy(X)).toPandas()
    np.testing.assert_array_equal(_column(out, "prediction"), ref_out["prediction"].to_numpy())
    if kind == "classifier":
        np.testing.assert_allclose(
            _column(out, "probability"), np.stack(ref_out["probability"].to_numpy()), rtol=0, atol=1e-6
        )


def test_port_save_load_round_trip(fitted, tmp_path):
    _, X, _, _, m = fitted
    m.save(str(tmp_path / "rf"))
    loaded = port.load(str(tmp_path / "rf"))
    assert type(loaded) is type(m)
    for name in ("features_", "thresholds_", "leaf_values_", "node_counts_", "impurities_"):
        np.testing.assert_array_equal(getattr(loaded, name), getattr(m, name))
    df = port.DataFrame.from_numpy(X, num_partitions=2)
    for col in m._out_columns():
        np.testing.assert_array_equal(_column(loaded.transform(df), col), _column(m.transform(df), col))


def test_bootstrap_fit_learns():
    X, y = _classification(n=4096, seed=31)
    m = port.RandomForestClassifier(numTrees=5, maxDepth=8, maxBins=16, seed=1).fit(
        port.DataFrame.from_numpy(X, y, num_partitions=2)
    )
    pred = _column(m.transform(port.DataFrame.from_numpy(X)), "prediction")
    assert (pred == y).mean() > 0.9
    assert m.node_counts_[:, 0].min() > 0.5 * len(X)  # Poisson(1) weights sum to ~N


@pytest.mark.parametrize(
    "params,limit",
    [
        (dict(maxBins=129), "maxBins"),
        (dict(maxDepth=14), "maxDepth"),
        (dict(featureSubsetStrategy="1025"), "features per split"),
    ],
)
def test_fits_outside_histogram_growth_raise(params, limit):
    """A fit past one of the histogram builder's limits (`limit`) no longer
    raises: it grows on the scatter engine (ops/forest.grow_forest), as the
    JAX package's does, and equals the JAX estimator's forest node for node
    (bootstrap off; integer class stats make every histogram sum exact, so
    the 1-shard port and the 8-device JAX package agree bit for bit, all
    five arrays)."""
    X = np.random.default_rng(0).standard_normal((64, 1100)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    kw = dict(numTrees=2, bootstrap=False, seed=3, **params)
    m = port.RandomForestClassifier(**kw).fit(port.DataFrame.from_numpy(X, y))
    m_ref = ref.RandomForestClassifier(**kw).fit(RefDataFrame.from_numpy(X.astype(np.float64), y=y))
    for name in ("features_", "thresholds_", "leaf_values_", "node_counts_", "impurities_"):
        np.testing.assert_array_equal(getattr(m, name), np.asarray(getattr(m_ref, name)), err_msg=name)


def test_missing_label_column_raises():
    X = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError, match="label"):
        port.RandomForestClassifier(numTrees=1).fit(port.DataFrame.from_numpy(X))


@pytest.mark.parametrize("package", [ref, port], ids=["reference", "port"])
def test_unsupported_params_raise(package):
    with pytest.raises(ValueError):
        package.RandomForestClassifier(weightCol="w")
    with pytest.raises(ValueError):
        package.RandomForestClassifier(impurity="variance")
    assert package.RandomForestRegressor(impurity="mse").tpu_params["split_criterion"] == "variance"


# ---------------------------------------------------------------------------
# integer stats: the histogram kernels' native integer atomics
# ---------------------------------------------------------------------------


def _spy_histograms(monkeypatch):
    """Record the integer_stats every histogram launch of a fit is given."""
    from spark_rapids_ml_tpu_torch.ops import forest_grow

    seen = []
    for name in ("node_histograms", "node_histograms_bucketed"):
        real = getattr(forest_grow, name)

        def spy(*args, _real=real, **kw):
            seen.append(kw.get("integer_stats"))
            return _real(*args, **kw)

        monkeypatch.setattr(forest_grow, name, spy)
    return seen


@pytest.mark.parametrize("kind", ["classifier", "classifier_weighted", "regressor"])
def test_only_unweighted_classifiers_declare_integer_stats(monkeypatch, kind):
    """A classifier without weightCol sums bootstrap counts x one-hot classes
    and says so; a regressor's stats (w, w*y) are not integers, and neither
    are a weighted classifier's (the RandomForest params reject weightCol
    today, so the weighted fit gets its weights the way core gives a
    weightCol's).  Every shallow and deep launch sees the same
    declaration."""
    seen = _spy_histograms(monkeypatch)
    if kind == "regressor":
        X, y = _regression(n=1024)
        est = port.RandomForestRegressor(numTrees=2, maxDepth=8, maxBins=8, seed=3)
    else:
        X, y = _classification(n=1024)
        est = port.RandomForestClassifier(numTrees=2, maxDepth=8, maxBins=8, seed=3)
    if kind == "classifier_weighted":
        real = type(est)._add_labels_and_weights

        def weighted(self, inputs, df):
            real(self, inputs, df)
            inputs.host_w = np.full(inputs.n_rows, 0.5)
            inputs.weight = [w * 0.5 for w in inputs.weight]

        monkeypatch.setattr(type(est), "_add_labels_and_weights", weighted)
    est.fit(port.DataFrame.from_numpy(X, y))
    assert len(seen) > 7  # the shallow levels and the deep ones
    assert set(seen) == {kind == "classifier"}
