# The port's LinearRegression (spark_rapids_ml_tpu_torch) against the JAX
# package's on the same numpy inputs, on the CPU: the sufficient statistics,
# the closed-form solve (OLS, ridge with Spark's alpha scaling,
# standardization on and off, no intercept, a rank-deficient X), coordinate
# descent with its sweep count, whole fits, persistence across packages.
#
# Tolerances: float32 statistics accumulate in other orders (row chunks here,
# one product there), so they agree to ~1e-5 relative; coefficients of the
# float32 solves to 1e-4 absolute on O(1) coefficients (a rank-deficient
# system's predictions to 1e-2: its solution is unique only off the null
# space), the CD sweep counts exactly, float64 fits to 1e-9.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops import glm as ref_glm

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.convert import linear_regression_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import glm


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _reg_data(n=800, d=10, seed=0, noise=0.1, rank_deficient=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + rng.normal(size=d)
    if rank_deficient:
        X[:, -1] = X[:, 0] - 2.0 * X[:, 1]
    coef = rng.normal(size=d)
    y = X @ coef + 2.5 + noise * rng.normal(size=n)
    return X.astype(np.float32), y.astype(np.float32)


def _stats_pair(X, y, w=None, chunk=128):
    w = np.ones(len(X), np.float32) if w is None else w
    ours = glm.linreg_sufficient_stats(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w), chunk=chunk)
    theirs = ref_glm.linreg_sufficient_stats(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w))
    return ours, theirs


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_sufficient_stats_match_reference(weighted):
    X, y = _reg_data(n=700, d=12, seed=1)
    w = np.random.default_rng(2).uniform(0.1, 2.0, size=len(X)).astype(np.float32) if weighted else None
    ours, theirs = _stats_pair(X, y, w)
    for name in glm.LinregStats._fields:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(theirs, name))
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-4 * max(1.0, float(np.abs(b).max())), err_msg=name)


@pytest.mark.parametrize(
    "alpha,fit_intercept,normalize,rank_deficient",
    [
        (0.0, True, False, False),
        (0.0, True, True, False),
        (0.0, False, False, False),
        (0.05, True, False, False),
        (0.05, True, True, False),
        (0.05, False, True, False),
        (0.0, True, False, True),
    ],
    ids=["ols", "ols_std", "ols_no_intercept", "ridge", "ridge_std", "ridge_no_intercept", "ols_rank_deficient"],
)
def test_solve_linear_matches_reference(alpha, fit_intercept, normalize, rank_deficient):
    X, y = _reg_data(seed=3, rank_deficient=rank_deficient)
    ours, theirs = _stats_pair(X, y)
    b, b0 = glm.solve_linear(ours, alpha, fit_intercept=fit_intercept, normalize=normalize)
    rb, rb0 = ref_glm.solve_linear(theirs, alpha, fit_intercept=fit_intercept, normalize=normalize)
    if not fit_intercept:
        assert float(b0) == 0.0
    if rank_deficient:
        # the solution is unique only off the null space (the dependent
        # column): the two solves may differ along it, and their
        # predictions agree
        pred = X.astype(np.float64) @ b.numpy() + float(b0)
        r_pred = X.astype(np.float64) @ np.asarray(rb) + float(rb0)
        assert np.isfinite(pred).all()
        np.testing.assert_allclose(pred, r_pred, atol=1e-2)
        return
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), atol=1e-4)
    np.testing.assert_allclose(float(b0), float(rb0), atol=1e-3)


@pytest.mark.parametrize(
    "alpha,l1_ratio,normalize,fit_intercept",
    [(0.05, 1.0, False, True), (0.1, 0.5, True, True), (0.02, 0.3, True, False), (0.5, 0.9, False, True)],
    ids=["lasso", "enet_std", "enet_no_intercept", "enet_strong"],
)
def test_solve_elasticnet_cd_matches_reference(alpha, l1_ratio, normalize, fit_intercept):
    X, y = _reg_data(seed=4, noise=0.5)
    ours, theirs = _stats_pair(X, y)
    b, b0, n_iter = glm.solve_elasticnet_cd(ours, alpha, l1_ratio, fit_intercept, normalize, 500, 1e-6)
    rb, rb0, r_iter = ref_glm.solve_elasticnet_cd(theirs, alpha, l1_ratio, fit_intercept, normalize, 500, 1e-6)
    assert n_iter == int(r_iter) and 1 < n_iter < 500
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), atol=1e-4)
    np.testing.assert_allclose(float(b0), float(rb0), atol=1e-3)
    # a sweep budget that runs out stops at it, on both sides
    b3, _, it3 = glm.solve_elasticnet_cd(ours, alpha, l1_ratio, fit_intercept, normalize, 3, 1e-12)
    rb3, _, rit3 = ref_glm.solve_elasticnet_cd(theirs, alpha, l1_ratio, fit_intercept, normalize, 3, 1e-12)
    assert it3 == int(rit3) == 3
    np.testing.assert_allclose(b3.numpy(), np.asarray(rb3), atol=1e-4)


def test_linear_predict_kernel_matches_reference():
    X, _ = _reg_data(n=300, d=7, seed=5)
    coef = np.random.default_rng(6).normal(size=7).astype(np.float32)
    got = glm.linear_predict_kernel(torch.from_numpy(X), torch.from_numpy(coef), torch.tensor(1.5))
    want = ref_glm.linear_predict_kernel(jnp.asarray(X), jnp.asarray(coef), jnp.asarray(1.5, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)


def _preds(df):
    return np.concatenate([np.asarray(p["prediction"]) for p in df.partitions])


@pytest.mark.parametrize(
    "params",
    [{}, {"regParam": 0.05}, {"regParam": 0.05, "elasticNetParam": 0.5, "maxIter": 300},
     {"regParam": 0.05, "elasticNetParam": 1.0, "standardization": False, "fitIntercept": False}],
    ids=["ols", "ridge", "elastic_net", "lasso_no_intercept"],
)
def test_estimator_matches_reference_end_to_end(params, tmp_path):
    X, y = _reg_data(n=1000, d=15, seed=7, noise=0.3)
    m_ref = ref.LinearRegression(**params).fit(RefDataFrame.from_numpy(X, y, num_partitions=3))
    model = port.LinearRegression(**params).fit(port.DataFrame.from_numpy(X, y, num_partitions=3))
    np.testing.assert_allclose(model.coefficients, m_ref.coefficients, atol=1e-4)
    np.testing.assert_allclose(model.intercept, m_ref.intercept, atol=1e-3)
    assert model.coef_.dtype == np.float64 and isinstance(model.intercept_, float)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    out = _preds(model.transform(df))
    assert out.dtype == np.float64
    want = m_ref.transform(RefDataFrame.from_numpy(X, y, num_partitions=2)).toPandas()["prediction"].to_numpy()
    np.testing.assert_allclose(out, want, atol=1e-3)
    assert abs(model.predict(X[0]) - out[0]) < 1e-5
    model.save(str(tmp_path / "lr"))
    loaded = port.load(str(tmp_path / "lr"))
    assert type(loaded) is port.LinearRegressionModel
    np.testing.assert_array_equal(_preds(loaded.transform(df)), out)


def test_float64_fit_matches_reference():
    X, y = _reg_data(n=500, d=6, seed=8)
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    m_ref = ref.LinearRegression(regParam=0.01, float32_inputs=False).fit(RefDataFrame.from_numpy(X64, y64))
    model = port.LinearRegression(regParam=0.01, float32_inputs=False).fit(port.DataFrame.from_numpy(X64, y64))
    assert model.dtype == "float64"
    np.testing.assert_allclose(model.coefficients, m_ref.coefficients, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(model.intercept, m_ref.intercept, rtol=1e-9, atol=1e-9)


def test_model_saved_by_reference_loads_in_port(tmp_path):
    X, y = _reg_data(n=400, d=5, seed=9)
    m_ref = ref.LinearRegression(regParam=0.1).setPredictionCol("yhat").fit(RefDataFrame.from_numpy(X, y))
    m_ref.save(str(tmp_path / "ref_lr"))
    loaded = port.load(str(tmp_path / "ref_lr"))
    assert type(loaded) is port.LinearRegressionModel and loaded.getPredictionCol() == "yhat"
    assert loaded.getRegParam() == 0.1
    np.testing.assert_array_equal(loaded.coefficients, m_ref.coefficients)
    assert loaded.intercept == m_ref.intercept
    got = np.concatenate([p["yhat"] for p in loaded.transform(port.DataFrame.from_numpy(X)).partitions])
    want = m_ref.transform(RefDataFrame.from_numpy(X)).toPandas()["yhat"].to_numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_model_from_reference_attributes():
    X, y = _reg_data(n=300, d=4, seed=10)
    m_ref = ref.LinearRegression().fit(RefDataFrame.from_numpy(X, y))
    model = linear_regression_model_from_reference(dict(m_ref._get_model_attributes()))
    np.testing.assert_array_equal(model.coefficients, m_ref.coefficients)
    assert model.intercept == m_ref.intercept and model.n_cols == 4 and model.scale == 1.0


@pytest.mark.parametrize("package", [ref, port], ids=["reference", "port"])
def test_params_and_unsupported_values(package):
    lr = package.LinearRegression()
    assert (lr.tpu_params["alpha"], lr.tpu_params["l1_ratio"], lr.tpu_params["normalize"]) == (0.0, 0.0, True)
    lr = package.LinearRegression(regParam=0.5, elasticNetParam=0.3)
    assert (lr.tpu_params["alpha"], lr.tpu_params["l1_ratio"]) == (0.5, 0.3)
    for bad in ({"loss": "huber"}, {"solver": "l-bfgs"}, {"weightCol": "w"}):
        with pytest.raises(ValueError):
            package.LinearRegression(**bad)


def test_hooks_not_in_this_slice_raise():
    X, y = _reg_data(n=50, d=3, seed=11)
    df = port.DataFrame.from_numpy(X, y)
    est = port.LinearRegression()
    model = est.fit(df)
    calls = ((lambda: est.fitMultiple(df, [{}]), "A7"), (est._fitBatchedSweep, "A7"), (est.streaming, "A12"),
             (lambda: model._transformEvaluate(df, None), "A7"), (lambda: port.LinearRegressionModel._combine([model]), "A7"),
             (model._serving_entry, "A13"), (model._lane_entry, "A13"), (model.cpu, "A14c"))
    for call, item in calls:
        with pytest.raises(NotImplementedError, match=item):
            call()
