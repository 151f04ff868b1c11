# The port's sparse (ELL) path (spark_rapids_ml_tpu_torch.ops.sparse, the
# CSR ingest of core and DataFrame, the GLMs on CSR frames) against the JAX
# package's ELL functions and against the port's own dense fits of the same
# matrix, on the CPU.
#
# Tolerances: the layout conversions, the densified chunks and the gathers
# are exact (bit for bit); products agree to 1e-6 relative (sums of a few
# terms in other orders); the statistics to 1e-5 relative; sparse fits equal
# the dense fits of the same rows to 1e-4 in coefficients for the linear
# solves and 5e-4 for L-BFGS (the same solver on the same data, sums in
# other orders, which the stop tests at tol 1e-7 amplify); the
# deterministic X^T R equals the dense product to 1e-5 and itself bit for
# bit.
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import sparse as ref_sparse

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import sparse


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _csr(n=400, d=30, density=0.1, seed=0, empty_rows=True):
    X = sp.random(n, d, density=density, format="csr", random_state=seed, dtype=np.float32)
    X.data = np.random.default_rng(seed).normal(size=X.nnz).astype(np.float32)
    if empty_rows:
        X = X.tolil()
        X[3] = 0.0
        X[n - 1] = 0.0
        X = X.tocsr()
        X.eliminate_zeros()
    return X


def test_ell_from_csr_matches_reference_bit_for_bit():
    X = _csr()
    idx, val = sparse.ell_from_csr(X.indptr, X.indices, X.data, X.shape[1])
    r_idx, r_val = ref_sparse.ell_from_csr(X.indptr, X.indices, X.data, X.shape[1])
    np.testing.assert_array_equal(idx, r_idx)
    np.testing.assert_array_equal(val, r_val)
    assert idx.shape[1] == np.diff(X.indptr).max()


def test_transpose_layout_holds_each_column_in_row_order():
    X = _csr(n=200, d=12, density=0.2, seed=1)
    ell = sparse.ell_device_from_scipy(X)
    dense = np.zeros((X.shape[1], X.shape[0]), np.float32)
    for j in range(X.shape[1]):
        rows, vals = ell.t_idx[j].numpy(), ell.t_val[j].numpy()
        n_j = X[:, j].nnz
        assert (np.diff(rows[:n_j]) > 0).all() and (vals[n_j:] == 0).all()
        np.add.at(dense[j], rows, vals)
    np.testing.assert_array_equal(dense, X.toarray().T)
    assert sparse.ell_device_from_scipy(X, transpose=False).t_idx is None


@pytest.mark.parametrize("k", [1, 4])
def test_ell_products_match_reference(k):
    X = _csr(seed=2)
    ell = sparse.ell_device_from_scipy(X)
    r_ell = ref_sparse.ell_device_from_scipy(X)
    B = np.random.default_rng(3).normal(size=(X.shape[1], k)).astype(np.float32)
    got = sparse.ell_matmat(ell, torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_sparse.ell_matmat(r_ell, jnp.asarray(B))), rtol=1e-6, atol=1e-6)
    got_v = sparse.ell_matvec(ell, torch.from_numpy(B[:, 0])).numpy()
    np.testing.assert_allclose(got_v, np.asarray(ref_sparse.ell_matvec(r_ell, jnp.asarray(B[:, 0]))), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got, X.toarray().astype(np.float64) @ B, rtol=1e-5, atol=1e-5)


def test_ell_densify_chunk_matches_reference_bit_for_bit():
    X = _csr(n=100, d=17, density=0.3, seed=4)
    ell = sparse.ell_device_from_scipy(X)
    got = sparse.ell_densify_chunk(ell.idx, ell.val, X.shape[1]).numpy()
    want = np.asarray(ref_sparse.ell_densify_chunk(jnp.asarray(ell.idx.numpy()), jnp.asarray(ell.val.numpy()),
                                                   X.shape[1]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, X.toarray())


@pytest.mark.parametrize("chunk", [37, 8192], ids=["chunked", "one_chunk"])
def test_ell_sufficient_stats_match_reference(chunk):
    X = _csr(n=500, d=20, density=0.15, seed=5)
    rng = np.random.default_rng(6)
    y = rng.normal(size=500).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=500).astype(np.float32)
    got = sparse.ell_sufficient_stats(sparse.ell_device_from_scipy(X), torch.from_numpy(y), torch.from_numpy(w),
                                      chunk=chunk)
    want = jax.device_get(
        ref_sparse.ell_sufficient_stats(ref_sparse.ell_device_from_scipy(X), jnp.asarray(y), jnp.asarray(w)))
    for name in got._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(b).max())), err_msg=name)


@pytest.mark.parametrize("k", [1, 3])
def test_deterministic_rmatmat_equals_the_dense_product(k, monkeypatch):
    X = _csr(n=3000, d=25, density=0.05, seed=7)
    ell = sparse.ell_device_from_scipy(X)
    R = torch.from_numpy(np.random.default_rng(8).normal(size=(X.shape[0], k)).astype(np.float32))
    got = sparse.ell_rmatmat(ell, R)
    np.testing.assert_allclose(got.numpy(), X.toarray().T.astype(np.float64) @ R.numpy(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sparse.ell_rmatmat(ell, R), got, rtol=0, atol=0)
    # in column blocks (a small gather budget) the result is the same bits
    monkeypatch.setattr(sparse, "RMATMAT_ELEMENTS", 7 * ell.t_idx.shape[1] * k)
    torch.testing.assert_close(sparse.ell_rmatmat(ell, R), got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="transpose"):
        sparse.ell_rmatmat(sparse.ell_device_from_scipy(X, transpose=False), R)


def _labels_from(X, k, seed):
    rng = np.random.default_rng(seed)
    logits = X @ rng.normal(size=(X.shape[1], max(k, 2))) + 0.3 * rng.normal(size=(X.shape[0], max(k, 2)))
    return logits.argmax(axis=1).astype(np.float32)


def _cols(df, name):
    return np.concatenate([np.asarray(p[name]) for p in df.partitions])


@pytest.mark.parametrize("k", [2, 4], ids=["binary", "multinomial"])
def test_sparse_logistic_fit_equals_dense_fit(k, monkeypatch):
    X = _csr(n=2000, d=40, density=0.1, seed=9)
    y = _labels_from(X, k, 10)
    est = port.LogisticRegression(regParam=0.01, tol=1e-7)
    monkeypatch.setattr(sp.csr_matrix, "toarray", lambda self, *a, **kw: pytest.fail("densified"))
    sparse_model = est.fit(port.DataFrame.from_numpy(X, y, num_partitions=3))
    again = est.fit(port.DataFrame.from_numpy(X, y, num_partitions=3))
    out = sparse_model.transform(port.DataFrame.from_numpy(X, y, num_partitions=2))
    monkeypatch.undo()
    np.testing.assert_array_equal(again.coef_, sparse_model.coef_)  # deterministic
    dense_model = est.fit(port.DataFrame.from_numpy(X.toarray(), y, num_partitions=3))
    np.testing.assert_allclose(sparse_model.coef_, dense_model.coef_, atol=5e-4)
    np.testing.assert_allclose(sparse_model.intercept_, dense_model.intercept_, atol=5e-4)
    dense_out = dense_model.transform(port.DataFrame.from_numpy(X.toarray(), y, num_partitions=2))
    np.testing.assert_allclose(_cols(out, "probability"), _cols(dense_out, "probability"), atol=1e-4)
    assert np.mean(_cols(out, "prediction") == y) > 0.7


@pytest.mark.parametrize("params", [{"regParam": 0.01}, {"regParam": 0.01, "elasticNetParam": 0.5}],
                         ids=["ridge", "elastic_net"])
def test_sparse_linear_fit_equals_dense_fit(params):
    X = _csr(n=1500, d=30, density=0.2, seed=11)
    y = (X @ np.random.default_rng(12).normal(size=30) + 0.1).astype(np.float32)
    sparse_model = port.LinearRegression(**params).fit(port.DataFrame.from_numpy(X, y, num_partitions=2))
    dense_model = port.LinearRegression(**params).fit(port.DataFrame.from_numpy(X.toarray(), y, num_partitions=2))
    np.testing.assert_allclose(sparse_model.coef_, dense_model.coef_, atol=1e-4)
    np.testing.assert_allclose(sparse_model.intercept_, dense_model.intercept_, atol=1e-4)
    preds = _cols(sparse_model.transform(port.DataFrame.from_numpy(X, num_partitions=2)), "prediction")
    np.testing.assert_allclose(preds, X.toarray().astype(np.float64) @ sparse_model.coef_ + sparse_model.intercept_,
                               rtol=1e-5, atol=1e-4)


def test_estimators_without_a_sparse_path_densify():
    X = _csr(n=300, d=10, density=0.3, seed=13)
    m_sparse = port.PCA(k=2).fit(port.DataFrame.from_numpy(X, num_partitions=2))
    m_dense = port.PCA(k=2).fit(port.DataFrame.from_numpy(X.toarray(), num_partitions=2))
    np.testing.assert_array_equal(m_sparse.components_, m_dense.components_)
    out = m_sparse.transform(port.DataFrame.from_numpy(X, num_partitions=2))
    np.testing.assert_array_equal(_cols(out, "pca_features"),
                                  _cols(m_dense.transform(port.DataFrame.from_numpy(X.toarray())), "pca_features"))


def test_sparse_dataframe_partitions():
    X = _csr(n=101, d=9, seed=14)
    y = np.arange(101, dtype=np.float32)
    df = port.DataFrame.from_numpy(X, y, num_partitions=3)
    assert [len(p) for p in df.partitions] == [33, 34, 34] and df.count() == 101
    assert all(sp.issparse(p["features"]) for p in df.partitions)
    assert (sp.vstack([p["features"] for p in df.partitions]) != X).nnz == 0
    with pytest.raises(ValueError, match="sparse"):
        port.DataFrame.from_numpy(X, feature_layout="multi_cols")
    pdf = df.toPandas()
    np.testing.assert_array_equal(np.stack(pdf["features"]), X.toarray())
