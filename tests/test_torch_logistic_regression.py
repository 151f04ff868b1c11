# The port's L-BFGS / OWL-QN and LogisticRegression (spark_rapids_ml_tpu_torch)
# against the JAX package's on the same numpy inputs, on the CPU: the
# minimiser on a quadratic and with an L1 term, the objective's value and
# closed-form gradient against jax.value_and_grad, logistic_fit_kernel
# (binary and multinomial, with and without L1, with and without intercept),
# whole fits, the transform's columns, persistence across packages.
#
# Tolerances: both sides run float32 with sums in other orders, so the
# minimiser's iterates agree to ~1e-5 on well-conditioned problems (the
# quadratic: iteration counts equal, x to 1e-4); the objective and gradient
# to 1e-5 relative; fitted logistic models, regularised so the optimum is
# unique, to 2e-3 absolute in coefficients and 1e-3 in probabilities.
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops import lbfgs as ref_lbfgs
from spark_rapids_ml_tpu.ops import logistic as ref_logistic

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.convert import logistic_regression_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import lbfgs, logistic


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _quadratic(p=12, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(p, p))
    A = (Q @ Q.T / p + np.diag(rng.uniform(0.5, 2.0, size=p))).astype(np.float32)
    b = rng.normal(size=p).astype(np.float32)
    return A, b


@pytest.mark.parametrize("owlqn", [False, True], ids=["lbfgs", "owlqn"])
def test_minimize_lbfgs_matches_reference_on_a_quadratic(owlqn):
    A, b = _quadratic()
    l1 = np.full(len(b), 0.3 if owlqn else 0.0, np.float32)
    l1[-2:] = 0.0  # unregularised coordinates, as intercepts are
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)

    def vg_port(x):
        Ax = At @ x
        return 0.5 * (x @ Ax) - bt @ x, Ax - bt

    def vg_ref(x):
        Ax = Aj @ x
        return 0.5 * (x @ Ax) - bj @ x, Ax - bj

    got = lbfgs.minimize_lbfgs(vg_port, torch.zeros(len(b)), torch.from_numpy(l1), max_iter=200, tol=1e-5,
                               use_owlqn=owlqn)
    want = ref_lbfgs.minimize_lbfgs(vg_ref, jnp.zeros(len(b)), jnp.asarray(l1), max_iter=200, tol=1e-5,
                                    use_owlqn=owlqn)
    assert got.converged and bool(want.converged)
    assert got.n_iter == int(want.n_iter) and 3 < got.n_iter < 200
    assert got.n_evals >= got.n_iter + 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-4)
    np.testing.assert_allclose(float(got.f), float(want.f), rtol=1e-5)
    if owlqn:
        assert (got.x.numpy() == 0).any()  # the L1 term zeroes some coordinates
    else:
        np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(A.astype(np.float64), b), atol=5e-3)


def test_minimize_lbfgs_stops_at_max_iter_and_keeps_the_iterate_on_an_exhausted_search():
    A, b = _quadratic(p=6, seed=1)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    res = lbfgs.minimize_lbfgs(lambda x: (0.5 * (x @ (At @ x)) - bt @ x, At @ x - bt), torch.zeros(6),
                               torch.zeros(6), max_iter=2, tol=0.0)
    assert res.n_iter == 2 and not res.converged
    # a gradient that never descends: every Armijo test fails, x stays at x0
    x0 = torch.ones(3)
    res = lbfgs.minimize_lbfgs(lambda x: ((x * x).sum(), -x), x0, torch.zeros(3), max_iter=5, max_ls=4)
    assert res.n_iter == 1 and res.converged and res.n_evals == 1 + 4
    torch.testing.assert_close(res.x, x0, rtol=0, atol=0)


def _cls_data(n=600, d=8, k=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(max(k, 2), d))
    logits = X @ W.T + 0.5 * rng.normal(size=(n, max(k, 2)))
    y = (logits[:, 0] > logits[:, 1]).astype(np.float32) if k == 2 else logits.argmax(axis=1).astype(np.float32)
    return X, y


@pytest.mark.parametrize("k", [1, 3], ids=["binary", "multinomial"])
@pytest.mark.parametrize("fit_intercept", [True, False], ids=["intercept", "no_intercept"])
def test_value_and_grad_match_jax_grad(k, fit_intercept):
    X, y = _cls_data(n=300, d=7, k=max(k, 2) if k > 1 else 2, seed=2)
    d = X.shape[1]
    n_params = k * d + (k if fit_intercept else 0)
    theta = np.random.default_rng(3).normal(size=n_params).astype(np.float32) * 0.3
    w = np.random.default_rng(4).uniform(0.5, 1.5, size=len(X)).astype(np.float32)
    y_enc = y if k == 1 else y.astype(np.int64)
    wt = torch.from_numpy(w)
    value, grad = logistic._data_value_and_grad(
        torch.from_numpy(theta), torch.from_numpy(X), torch.from_numpy(y_enc), wt, wt.sum(), k, d, fit_intercept)
    if k == 1:
        fn = lambda t: ref_logistic._binary_data_loss(t, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), d,  # noqa: E731
                                                      fit_intercept)
    else:
        fn = lambda t: ref_logistic._softmax_data_loss(t, jnp.asarray(X), jnp.asarray(y.astype(np.int32)),  # noqa: E731
                                                       jnp.asarray(w), k, d, fit_intercept)
    r_value, r_grad = jax.value_and_grad(fn)(jnp.asarray(theta))
    np.testing.assert_allclose(float(value), float(r_value), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(r_grad), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize(
    "k,reg,l1_ratio,fit_intercept",
    [(1, 0.01, 0.0, True), (1, 0.02, 0.5, True), (1, 0.01, 0.0, False), (3, 0.01, 0.0, True), (3, 0.02, 1.0, True),
     (4, 0.05, 0.3, False)],
    ids=["binary_l2", "binary_enet", "binary_no_intercept", "multinomial_l2", "multinomial_l1", "multinomial_enet"],
)
def test_logistic_fit_kernel_matches_reference(k, reg, l1_ratio, fit_intercept):
    X, y = _cls_data(n=800, d=10, k=2 if k == 1 else k, seed=5 + k)
    w = np.ones(len(X), np.float32)
    use_owlqn = reg > 0 and l1_ratio > 0
    args = (k, reg, l1_ratio, fit_intercept, 300, 1e-7, use_owlqn)
    W, b, n_iter, converged, n_evals = logistic.logistic_fit_kernel(
        torch.from_numpy(X), torch.from_numpy(y if k == 1 else y.astype(np.int64)), torch.from_numpy(w), *args)
    rW, rb, r_iter, r_conv = ref_logistic.logistic_fit_kernel(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), *args)
    assert converged and bool(r_conv) and n_iter < 300 and n_evals > n_iter
    assert W.shape == (k, 10) and b.shape == (k,)
    np.testing.assert_allclose(W.numpy(), np.asarray(rW), atol=2e-3)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), atol=2e-3)
    if l1_ratio > 0:
        # the same coordinates are zero on both sides, up to the ones at
        # the orthant boundary
        assert np.mean((W.numpy() == 0) == (np.asarray(rW) == 0)) > 0.9


def _cols(df, name):
    return np.concatenate([np.asarray(p[name]) for p in df.partitions])


@pytest.mark.parametrize(
    "k,params",
    [(2, {"regParam": 0.01}), (3, {"regParam": 0.01}), (4, {"regParam": 0.02, "elasticNetParam": 0.5})],
    ids=["binary", "multinomial", "multinomial_enet"],
)
def test_estimator_matches_reference_end_to_end(k, params, tmp_path):
    X, y = _cls_data(n=900, d=9, k=k, seed=9)
    y = y * 2.0 + 1.0  # labels that are not class indices
    m_ref = ref.LogisticRegression(tol=1e-7, **params).fit(RefDataFrame.from_numpy(X, y, num_partitions=3))
    model = port.LogisticRegression(tol=1e-7, **params).fit(port.DataFrame.from_numpy(X, y, num_partitions=3))
    np.testing.assert_array_equal(model.classes_, m_ref.classes_)
    assert model.numClasses == k and model.coef_.shape == (1 if k == 2 else k, 9)
    np.testing.assert_allclose(model.coef_, m_ref.coef_, atol=2e-3)
    np.testing.assert_allclose(model.intercept_, m_ref.intercept_, atol=2e-3)
    df = port.DataFrame.from_numpy(X, y, num_partitions=2)
    out = model.transform(df)
    assert out.columns == ["features", "label", "prediction", "probability", "rawPrediction"]
    pdf = m_ref.transform(RefDataFrame.from_numpy(X, y, num_partitions=2)).toPandas()
    probs = _cols(out, "probability")
    np.testing.assert_allclose(probs, np.stack(pdf["probability"]), atol=1e-3)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-6)
    pred = _cols(out, "prediction")
    assert np.mean(pred == pdf["prediction"].to_numpy()) > 0.99 and np.mean(pred == y) > 0.8
    raw = _cols(out, "rawPrediction")
    assert raw.shape == (len(X), k)
    if k == 2:
        np.testing.assert_array_equal(raw[:, 0], -raw[:, 1])  # Spark's [-z, z]
        z = X.astype(np.float64) @ model.coefficients + model.intercept
        np.testing.assert_allclose(raw[:, 1], z, rtol=1e-5, atol=1e-5)
    assert model.predict(X[0]) == pred[0]
    np.testing.assert_allclose(model.predictProbability(X[0]), probs[0], rtol=1e-6)
    model.save(str(tmp_path / "logreg"))
    loaded = port.load(str(tmp_path / "logreg"))
    assert type(loaded) is port.LogisticRegressionModel and loaded.num_iters == model.num_iters
    out2 = loaded.transform(df)
    for name in ("prediction", "probability", "rawPrediction"):
        np.testing.assert_array_equal(_cols(out2, name), _cols(out, name))


def test_model_saved_by_reference_loads_in_port(tmp_path):
    X, y = _cls_data(n=400, d=6, k=3, seed=10)
    m_ref = ref.LogisticRegression(regParam=0.01).setProbabilityCol("p").fit(RefDataFrame.from_numpy(X, y))
    m_ref.save(str(tmp_path / "ref_logreg"))
    loaded = port.load(str(tmp_path / "ref_logreg"))
    assert type(loaded) is port.LogisticRegressionModel and loaded.getProbabilityCol() == "p"
    np.testing.assert_array_equal(loaded.coefficientMatrix, m_ref.coefficientMatrix)
    out = loaded.transform(port.DataFrame.from_numpy(X))
    pdf = m_ref.transform(RefDataFrame.from_numpy(X)).toPandas()
    np.testing.assert_allclose(_cols(out, "p"), np.stack(pdf["p"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_cols(out, "prediction"), pdf["prediction"].to_numpy())


def test_model_from_reference_attributes():
    X, y = _cls_data(n=300, d=5, seed=11)
    m_ref = ref.LogisticRegression(regParam=0.05).fit(RefDataFrame.from_numpy(X, y))
    attrs = {k: np.asarray(v) for k, v in m_ref._get_model_attributes().items()}
    model = logistic_regression_model_from_reference(attrs)
    np.testing.assert_array_equal(model.coefficients, m_ref.coefficients)
    assert model.intercept == m_ref.intercept and model.num_iters == m_ref.num_iters
    for row in X[:20]:
        assert model.predict(row) == m_ref.predict(row)
        np.testing.assert_allclose(model.predictProbability(row), m_ref.predictProbability(row), rtol=1e-5)
    with pytest.raises(AttributeError):
        logistic_regression_model_from_reference(
            {**attrs, "coef_": np.zeros((3, 5)), "intercept_": np.zeros(3), "classes_": np.arange(3.0)}).coefficients


@pytest.mark.parametrize("package", [ref, port], ids=["reference", "port"])
def test_params(package):
    lr = package.LogisticRegression()
    assert (lr.tpu_params["C"], lr.tpu_params["penalty"]) == (0.0, "none")
    lr = package.LogisticRegression(regParam=0.1, elasticNetParam=0.3)
    assert lr.tpu_params["C"] == pytest.approx(10.0)
    assert (lr.tpu_params["penalty"], lr.tpu_params["l1_ratio"]) == ("elasticnet", 0.3)
    assert package.LogisticRegression(regParam=0.1, elasticNetParam=1.0).tpu_params["penalty"] == "l1"
    assert package.LogisticRegression(regParam=0.1).tpu_params["penalty"] == "l2"
    for bad in ({"threshold": 0.3}, {"weightCol": "w"}):
        with pytest.raises(ValueError):
            package.LogisticRegression(**bad)
    assert package.LogisticRegression(float32_inputs=False)._float32_inputs is True


def test_one_class_raises():
    X, _ = _cls_data(n=50, d=3, seed=12)
    with pytest.raises(RuntimeError, match="two distinct labels"):
        port.LogisticRegression().fit(port.DataFrame.from_numpy(X, np.ones(50, np.float32)))


def test_hooks_not_in_this_slice_raise():
    X, y = _cls_data(n=60, d=3, seed=13)
    df = port.DataFrame.from_numpy(X, y)
    est = port.LogisticRegression()
    model = est.fit(df)
    # the model-selection hooks (ROADMAP A7) work now; the others still
    # name their items
    (index, single), = list(est.fitMultiple(df, [{}]))
    assert index == 0 and np.array_equal(single.coef_, model.coef_)
    combined = port.LogisticRegressionModel._combine([model])
    assert combined._num_models == 1
    from spark_rapids_ml_tpu_torch.evaluation import MulticlassClassificationEvaluator

    assert len(combined._transformEvaluate(df, MulticlassClassificationEvaluator())) == 1
    with pytest.raises(NotImplementedError, match="unsupported"):
        model._transformEvaluate(df, None)
    # streaming (ROADMAP A12) works now (tests/test_torch_streaming.py)
    assert type(est.streaming()).__name__ == "StreamingLogisticRegression"
    # serving (ROADMAP A13a) works now (tests/test_torch_serving.py)
    assert type(model._serving_entry()).__name__ == "ServingEntry"
    # multiplexed serving (ROADMAP A13b) works now (tests/test_torch_multiplex.py)
    lane = model._lane_entry()
    assert (type(lane).__name__, lane.name) == ("LaneEntry", "lanes.logreg")
    assert lane.out_cols == ["prediction", "probability", "rawPrediction"]
    assert lane.statics == {"num_classes": model._num_classes}
    assert lane.meta == (str(np.asarray(model.classes_).dtype), np.asarray(model.classes_).tobytes())
    # cpu() (ROADMAP A14c-2) needs pyspark: without it, the JAX package's
    # ImportError (tests/test_torch_interop.py holds the conversion itself)
    from spark_rapids_ml_tpu.spark.interop import _require_pyspark

    with pytest.raises(ImportError) as want:
        _require_pyspark()
    with pytest.raises(ImportError, match=re.escape(str(want.value))):
        model.cpu()
