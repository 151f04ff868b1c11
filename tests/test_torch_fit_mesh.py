# The port's batch fits on a mesh (spark_rapids_ml_tpu_torch: the row-sharded
# ingest of core._build_fit_inputs, and the KMeans, PCA, GLM and batched-sweep
# reductions over shards) against the JAX package's on the same numpy inputs,
# on the CPU: the port drives 8 shards of use_device(["cpu"] * 8) (and 1 or 2)
# from one process, the JAX package its 8 forced CPU devices (conftest).
#
# Tolerances, stated per test:
#   - integer-valued rows (every sum exact in float32): the statistics, the
#     moments and the Lloyd centers bit for bit against the JAX package's
#     mesh functions and against the port's own 1-shard fit; the batched
#     linear sweep's avgMetrics equal on 1, 2 and 8 shards;
#   - Gaussian rows: statistics within 1e-6 relative (8 partials added in
#     another order);
#   - estimators against the JAX estimators on 8 devices: the JAX package's
#     own mesh gates (KMeans sorted centers atol 1e-2, PCA components atol
#     1e-3 and singular values rtol 1e-3), linear coefficients atol 1e-4,
#     logistic coefficients atol 5e-3 (CV_LOGISTIC_ATOL) and accuracy equal.
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu import tuning as ref_tuning
from spark_rapids_ml_tpu.core import clear_fit_cache as ref_clear_fit_cache
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.evaluation import RegressionEvaluator as RefRE
from spark_rapids_ml_tpu.ops import glm as ref_glm
from spark_rapids_ml_tpu.ops import kmeans as ref_kmeans
from spark_rapids_ml_tpu.ops import linalg as ref_linalg
from spark_rapids_ml_tpu.ops import sparse as ref_sparse
from spark_rapids_ml_tpu.ops import sweep as ref_sweep
from spark_rapids_ml_tpu.parallel.mesh import get_mesh as ref_get_mesh
from spark_rapids_ml_tpu.parallel.mesh import shard_rows as ref_shard_rows

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import glm, kmeans, linalg, logistic, sparse, sweep
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh, shard_rows

N_DEV = 8
FLOAT_RTOL = 1e-6
CV_LOGISTIC_ATOL = 5e-3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean_cache():
    yield
    port.clear_fit_cache()
    ref_clear_fit_cache()


def _mesh(n):
    return Mesh((CPU,) * n)


def _int_rows(n, d, seed, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n, d)).astype(np.float32)


def _int_reg(n=301, d=6, seed=0):
    X = _int_rows(n, d, seed)
    rng = np.random.default_rng(seed + 1)
    y = (X @ rng.integers(-2, 3, size=d) + rng.integers(-2, 3, size=n)).astype(np.float32)
    return X, y


def _int_cls(n=301, d=6, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.integers(-3, 4, size=(2 * n, d)).astype(np.float32)
    c = rng.integers(-2, 3, size=d).astype(np.float32)
    X = X[X @ c != 0][:n]
    return X, (X @ c > 0).astype(np.float32)


def _int_blobs(n=403, d=5, k=4, seed=2):
    """Integer rows in k well-separated clusters: every assignment is far
    from a tie, every center sum exact."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-4, 5, size=(k, d)) * 40
    labels = rng.integers(0, k, size=n)
    return (centers[labels] + rng.integers(-3, 4, size=(n, d))).astype(np.float32)


def _ref_sharded(x):
    return ref_shard_rows(x, ref_get_mesh())[0]


def _port_sharded(x, n_dev=N_DEV):
    return shard_rows(x, _mesh(n_dev))[0]


def _np(t):
    return np.asarray(t)


# -- ingest --------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_ingest_shards_rows_as_the_jax_package_does(n_dev):
    """Features, labels and weights row-sharded over the mesh: shards of
    ceil(n / n_dev) rows, zero padding at the end, pad rows of weight 0; the
    concatenated shards equal the JAX package's padded global arrays."""
    X, y = _int_reg(n=301)
    df = port.DataFrame.from_numpy(X, y, num_partitions=3)
    with use_device(["cpu"] * n_dev):
        inputs = port.LinearRegression()._build_fit_inputs(df)
    assert inputs.mesh.size == n_dev and len(inputs.X) == len(inputs.weight) == len(inputs.y) == n_dev
    per = -(-301 // n_dev)
    assert all(x.shape == (per, 6) for x in inputs.X) and inputs.n_pad == per * n_dev
    ref_inputs = ref.LinearRegression(num_workers=n_dev)._build_fit_inputs(RefDataFrame.from_numpy(X, y=y, num_partitions=3))
    np.testing.assert_array_equal(torch.cat(inputs.X).numpy(), _np(ref_inputs.X))
    np.testing.assert_array_equal(torch.cat(inputs.weight).numpy(), _np(ref_inputs.weight))
    np.testing.assert_array_equal(torch.cat(inputs.y).numpy(), _np(ref_inputs.y))


def test_default_num_workers_uses_every_device_of_the_list():
    X, y = _int_reg(n=64)
    df = port.DataFrame.from_numpy(X, y)
    with use_device(["cpu"] * 8):
        assert port.LinearRegression()._build_fit_inputs(df).mesh.size == 8
        assert port.LinearRegression(num_workers=2)._build_fit_inputs(df).mesh.size == 2
    with use_device("cpu"):
        assert port.LinearRegression()._build_fit_inputs(df).mesh.size == 1


def test_fit_cache_is_keyed_by_the_mesh_and_holds_one_dataset():
    X, y = _int_reg(n=64)
    df = port.DataFrame.from_numpy(X, y)
    c0 = profiling.counters("ingest.")
    with use_device(["cpu"] * 4):
        a = port.LinearRegression()._build_fit_inputs(df)
        b = port.LinearRegression()._build_fit_inputs(df)
        assert b.X is a.X
        c = port.LinearRegression(num_workers=2)._build_fit_inputs(df)
    d = profiling.counter_deltas(c0, "ingest.")
    assert d == {"ingest.staged": 2, "ingest.cache_hit": 1}
    assert len(c.X) == 2 and c.X is not a.X


def test_from_device_frame_is_resharded_onto_the_mesh():
    """A DataFrame.from_device tensor re-sharded: shards on its device are
    views of it (no copy) where they are whole, its pad rows weigh 0."""
    X, y = _int_reg(n=64)
    Xp = torch.from_numpy(np.concatenate([X, np.zeros((4, 6), np.float32)]))
    df = port.DataFrame.from_device(Xp, y, n_rows=64)
    with use_device(["cpu"] * 4):
        inputs = port.LinearRegression()._build_fit_inputs(df)
    assert len(inputs.X) == 4 and inputs.X[0].data_ptr() == Xp.data_ptr()
    np.testing.assert_array_equal(torch.cat(inputs.weight).numpy(), (np.arange(68) < 64).astype(np.float32))
    with use_device(["cpu"] * 4):
        m4 = port.LinearRegression().fit(df)
    with use_device("cpu"):
        m1 = port.LinearRegression().fit(port.DataFrame.from_numpy(X, y))
    np.testing.assert_array_equal(m4.coef_, m1.coef_)


def test_sparse_ingest_shards_an_ell_pair_per_shard():
    X, y = _int_reg(n=101, d=9)
    X[X < 1] = 0
    csr = sp.csr_matrix(X)
    with use_device(["cpu"] * 4):
        inputs = port.LinearRegression()._build_fit_inputs(port.DataFrame.from_numpy(csr, y, num_partitions=2))
    assert len(inputs.X) == 4
    dense = torch.cat([sparse.ell_densify_chunk(e.idx, e.val, 9) for e in inputs.X])
    np.testing.assert_array_equal(dense.numpy()[:101], X)
    assert not dense[101:].any()
    for e in inputs.X:  # each shard's own transpose over its local rows
        assert e.t_idx.shape[0] == 9 and int(e.t_idx.max()) < e.idx.shape[0]


def test_stage_fold_ids_sharded():
    got = sweep.stage_fold_ids(301, 301, 3, 5, _mesh(8))
    want = ref_sweep.stage_fold_ids(301, 301 + 3, 3, 5, ref_get_mesh())
    assert len(got) == 8
    np.testing.assert_array_equal(torch.cat(got).numpy(), _np(want))
    assert (torch.cat(got)[301:] == -1).all()


# -- KMeans ---------------------------------------------------------------------


def test_lloyd_from_the_jax_init_bit_for_bit_on_integer_rows():
    """Lloyd on 8 shards from the JAX package's random init: the centers bit
    for bit the JAX package's 8-device Lloyd and the port's 1-shard Lloyd
    (integer rows, clusters far from ties), n_iter equal, inertia within
    1e-6 relative."""
    X = _int_blobs()
    n = X.shape[0]
    w = np.ones(n, np.float32)
    Xs, ws = _ref_sharded(X), _ref_sharded(w)
    c0 = ref_kmeans.random_init(Xs, ws, 4, 7)
    c_ref, it_ref, in_ref = ref_kmeans.lloyd_iterations(Xs, ws, c0, ref_get_mesh(), 50, 1e-4, 32)
    c0_t = torch.from_numpy(np.asarray(c0))
    for n_dev in (8, 1):
        c, it, inertia = kmeans.lloyd_iterations(_port_sharded(X, n_dev), _port_sharded(w, n_dev), c0_t, 50, 1e-4, 32)
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
        assert it == int(it_ref) and it > 1
        np.testing.assert_allclose(inertia, float(in_ref), rtol=FLOAT_RTOL)


@pytest.mark.parametrize("init", ["random", "k-means||"])
def test_inits_draw_one_init_on_any_shard_count(init):
    """The inits' draws index global rows: one seed gives the same centers
    on 1, 2 and 8 shards (bit for bit)."""
    X = _int_blobs(n=403)
    w = np.ones(len(X), np.float32)
    out = []
    for n_dev in (1, 2, 8):
        Xs, ws = _port_sharded(X, n_dev), _port_sharded(w, n_dev)
        if init == "random":
            out.append(kmeans.random_init(Xs, ws, 4, 11, n_rows=len(X)))
        else:
            out.append(kmeans.scalable_kmeans_pp_init(Xs, ws, 4, 11, rounds=4, round_size=8, chunk=64, n_rows=len(X)))
    for c in out[1:]:
        np.testing.assert_array_equal(c.numpy(), out[0].numpy())


@pytest.mark.parametrize("init", ["random", "k-means||"])
def test_kmeans_estimator_on_eight_shards(init):
    """KMeans through the public API on 8 shards: bit for bit the port's
    1-shard fit (integer rows).  Against the JAX estimator on 8 devices,
    whose inits draw the same jax.random keys: the same centers in the same
    order, within the JAX mesh gate (atol 1e-2) sorted and within 1e-4 as
    they stand."""
    X = _int_blobs(n=403)
    df = port.DataFrame.from_numpy(X, num_partitions=3)
    kw = dict(k=4, seed=5, maxIter=50, initMode=init)
    with use_device(["cpu"] * 8):
        m8 = port.KMeans(**kw).fit(df)
    with use_device("cpu"):
        m1 = port.KMeans(**kw).fit(df)
    np.testing.assert_array_equal(m8.cluster_centers_, m1.cluster_centers_)
    assert m8.n_iter_ == m1.n_iter_
    m_ref = ref.KMeans(**kw).fit(RefDataFrame.from_numpy(X, num_partitions=3))
    srt = lambda c: c[np.lexsort(np.asarray(c).T)]  # noqa: E731
    np.testing.assert_allclose(srt(m8.cluster_centers_), srt(np.asarray(m_ref.cluster_centers_)), atol=1e-2)
    np.testing.assert_allclose(m8.cluster_centers_, np.asarray(m_ref.cluster_centers_), rtol=0, atol=1e-4)
    with use_device(["cpu"] * 8):
        labels8 = np.concatenate([p["prediction"] for p in m8.transform(df).partitions])
    with use_device("cpu"):
        labels1 = np.concatenate([p["prediction"] for p in m1.transform(df).partitions])
    np.testing.assert_array_equal(labels8, labels1)


# -- PCA ------------------------------------------------------------------------


@pytest.mark.parametrize("data", ["integer", "gaussian"])
def test_sharded_moments_match_the_jax_package(data):
    """_sharded_moments on 8 shards against the JAX package's on 8 devices:
    bit for bit on integer rows (and equal to the 1-shard moments there),
    within 1e-6 relative on Gaussian rows."""
    n, d = 301, 7
    X = _int_rows(n, d, 3) if data == "integer" else np.random.default_rng(3).standard_normal((n, d)).astype(np.float32)
    w = np.ones(n, np.float32)
    got = linalg._sharded_moments(_port_sharded(X), _port_sharded(w), chunk=16)
    want = ref_linalg._sharded_moments(_ref_sharded(X), _ref_sharded(w), ref_get_mesh(), 16)
    wsum, xwsum, scatter = got
    pairs = [(wsum, want[0]), (xwsum / wsum, want[1]), (scatter, want[2])]
    for a, b in pairs:
        if data == "integer":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FLOAT_RTOL, atol=1e-6)
    if data == "integer":
        one = linalg._sharded_moments(torch.from_numpy(X), torch.from_numpy(w), chunk=16)
        for a, b in zip(got, one):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pca_estimator_on_eight_shards():
    X = np.random.default_rng(4).standard_normal((256, 6)).astype(np.float32) * np.arange(1, 7, dtype=np.float32)
    df = port.DataFrame.from_numpy(X, num_partitions=4)
    with use_device(["cpu"] * 8):
        m8 = port.PCA(k=3).fit(df)
    m_ref = ref.PCA(k=3).fit(RefDataFrame.from_numpy(X, num_partitions=4))
    np.testing.assert_allclose(m8.components_, np.asarray(m_ref.components_), atol=1e-3)
    np.testing.assert_allclose(m8.singular_values_, np.asarray(m_ref.singular_values_), rtol=1e-3)
    Xi = _int_rows(256, 6, 5)
    dfi = port.DataFrame.from_numpy(Xi, num_partitions=4)
    with use_device(["cpu"] * 8):
        a = port.PCA(k=3).fit(dfi)
    with use_device("cpu"):
        b = port.PCA(k=3).fit(dfi)
    np.testing.assert_array_equal(a.components_, b.components_)  # exact moments, one eigh


# -- GLMs -----------------------------------------------------------------------


@pytest.mark.parametrize("data", ["integer", "gaussian"])
def test_linreg_stats_match_the_jax_package(data):
    n, d = 301, 6
    if data == "integer":
        X, y = _int_reg(n, d)
    else:
        rng = np.random.default_rng(6)
        X = rng.standard_normal((n, d)).astype(np.float32)
        y = (X @ rng.standard_normal(d)).astype(np.float32)
    w = np.ones(n, np.float32)
    got = glm.linreg_sufficient_stats(_port_sharded(X), _port_sharded(y), _port_sharded(w), chunk=16)
    want = ref_glm.linreg_sufficient_stats(_ref_sharded(X), _ref_sharded(y), _ref_sharded(w), mesh=ref_get_mesh(), chunk=16)
    for a, b in zip(got, want):
        if data == "integer":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FLOAT_RTOL, atol=1e-5)


def test_fold_stats_match_the_jax_package_bit_for_bit():
    X, y = _int_reg(301, 6)
    n = len(X)
    w = np.ones(n, np.float32)
    fid = sweep.stage_fold_ids(n, n, 3, 5, _mesh(8))
    got = glm.sweep_linreg_fold_stats(_port_sharded(X), _port_sharded(y), _port_sharded(w), fid, 3, chunk=16)
    rf = ref_sweep.stage_fold_ids(n, n + 3, 3, 5, ref_get_mesh())
    want = ref_glm.sweep_linreg_fold_stats(_ref_sharded(X), _ref_sharded(y), _ref_sharded(w), rf, 3, ref_get_mesh(), chunk=16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one = glm.sweep_linreg_fold_stats(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
                                      sweep.stage_fold_ids(n, n, 3, 5, CPU), 3, chunk=16)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ell_stats_match_the_jax_package_bit_for_bit():
    X, y = _int_reg(301, 9)
    X[X < 1] = 0
    csr = sp.csr_matrix(X)
    w = np.ones(len(X), np.float32)
    ells = sparse.ell_shards_from_scipy(csr, np.float32, _mesh(8))
    got = sparse.ell_sufficient_stats(ells, _port_sharded(y), _port_sharded(w), chunk=16)
    ref_ell = ref_sparse.ell_device_from_scipy(csr, mesh=ref_get_mesh())
    n_pad = ref_ell.idx.shape[0]
    yp, wp = np.zeros(n_pad, np.float32), np.zeros(n_pad, np.float32)
    yp[: len(y)], wp[: len(w)] = y, w
    want = ref_sparse.ell_sufficient_stats(ref_ell, _ref_sharded(yp), _ref_sharded(wp), mesh=ref_get_mesh(), chunk=16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_linear_regression_on_eight_shards(layout):
    X, y = _int_reg(301, 6)
    feats = sp.csr_matrix(X) if layout == "csr" else X
    df = port.DataFrame.from_numpy(feats, y, num_partitions=3)
    with use_device(["cpu"] * 8):
        m8 = port.LinearRegression(regParam=0.1).fit(df)
    with use_device("cpu"):
        m1 = port.LinearRegression(regParam=0.1).fit(df)
    np.testing.assert_array_equal(m8.coef_, m1.coef_)  # exact statistics, one solve
    m_ref = ref.LinearRegression(regParam=0.1).fit(RefDataFrame.from_numpy(feats, y=y, num_partitions=3))
    np.testing.assert_allclose(m8.coef_, np.asarray(m_ref.coef_), atol=1e-4)
    np.testing.assert_allclose(m8.intercept_, float(m_ref.intercept_), atol=1e-4)


@pytest.mark.parametrize("layout", ["dense", "csr"])
def test_logistic_regression_on_eight_shards(layout):
    """Binary logistic through L-BFGS on 8 shards: the shards' partial
    objectives summed by one psum an evaluation.  Coefficients within
    CV_LOGISTIC_ATOL of the 1-shard fit and of the JAX estimator's on 8
    devices; accuracy equal."""
    X, y = _int_cls(301, 6)
    feats = sp.csr_matrix(X) if layout == "csr" else X
    df = port.DataFrame.from_numpy(feats, y, num_partitions=3)
    kw = dict(regParam=0.01, maxIter=200)
    with use_device(["cpu"] * 8):
        m8 = port.LogisticRegression(**kw).fit(df)
        p8 = np.concatenate([p["prediction"] for p in m8.transform(df).partitions])
    with use_device("cpu"):
        m1 = port.LogisticRegression(**kw).fit(df)
    np.testing.assert_allclose(m8.coef_, m1.coef_, atol=CV_LOGISTIC_ATOL)
    m_ref = ref.LogisticRegression(**kw).fit(RefDataFrame.from_numpy(feats, y=y, num_partitions=3))
    np.testing.assert_allclose(m8.coef_, np.asarray(m_ref.coef_), atol=CV_LOGISTIC_ATOL)
    p_ref = m_ref.transform(RefDataFrame.from_numpy(feats, y=y, num_partitions=3)).toPandas()["prediction"].to_numpy()
    assert (p8 == y).mean() == (p_ref == y).mean()


def test_logistic_objective_sums_the_shards():
    """The sharded objective and gradient equal the one-shard ones within
    1e-6 relative (the 8 partials add in shard order)."""
    X, y = _int_cls(301, 6)
    w = np.ones(len(X), np.float32)
    theta = torch.from_numpy(np.random.default_rng(0).standard_normal(7).astype(np.float32) * 0.1)
    wsum = torch.tensor(float(len(X)))
    v1, g1 = logistic._data_value_and_grad(theta, torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
                                           wsum, 1, 6, True)
    v8, g8 = logistic._sharded_value_and_grad(theta, _port_sharded(X), _port_sharded(y), _port_sharded(w),
                                              wsum, 1, 6, True)
    np.testing.assert_allclose(float(v8), float(v1), rtol=FLOAT_RTOL)
    np.testing.assert_allclose(g8.numpy(), g1.numpy(), rtol=FLOAT_RTOL, atol=1e-7)


# -- the batched sweeps ---------------------------------------------------------


def _cv(est, grid, eva, df):
    return port.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, numFolds=3, seed=5)._fit(df)


@pytest.mark.parametrize("num_workers", [1, 2, 8])
def test_batched_linear_sweep_equal_across_shard_counts(num_workers, monkeypatch):
    """The JAX package's tests/test_tuning.py gate on 1, 2 and 8 shards:
    batched avgMetrics equal to the fold loop's and to the 1-shard sweep's,
    one staged dataset; and within 1e-6 relative of the JAX package's
    batched sweep on as many devices (the tolerance of the one-device
    comparison in tests/test_torch_tuning.py)."""
    X, y = _int_reg(301, 6)
    df = port.DataFrame.from_numpy(X, y, num_partitions=4)
    grid = (port.ParamGridBuilder().addGrid(port.LinearRegression.regParam, [0.0, 0.1])
            .addGrid(port.LinearRegression.elasticNetParam, [0.0, 0.5]).build())
    eva = port.RegressionEvaluator(metricName="rmse")
    with use_device("cpu"):
        base = _cv(port.LinearRegression(standardization=False), grid, eva, df)
    port.clear_fit_cache()
    with use_device(["cpu"] * 8):
        c0 = profiling.counters("ingest.")
        est = port.LinearRegression(standardization=False, num_workers=num_workers)
        bat = _cv(est, grid, eva, df)
        staged = profiling.counter_deltas(c0, "ingest.").get("ingest.staged", 0)
        port.clear_fit_cache()
        seq = port.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=eva, numFolds=3,
                                  seed=5)._fit(df, batched=False)
    assert bat.avgMetrics == seq.avgMetrics == base.avgMetrics
    assert staged == 1
    monkeypatch.setenv("SRML_SWEEP_BATCH", "1")
    ref_grid = (ref_tuning.ParamGridBuilder().addGrid(ref.LinearRegression.regParam, [0.0, 0.1])
                .addGrid(ref.LinearRegression.elasticNetParam, [0.0, 0.5]).build())
    theirs = ref_tuning.CrossValidator(
        estimator=ref.LinearRegression(standardization=False, num_workers=num_workers), estimatorParamMaps=ref_grid,
        evaluator=RefRE(metricName="rmse"), numFolds=3, seed=5,
    ).fit(RefDataFrame.from_numpy(X, y=y, num_partitions=4))
    np.testing.assert_allclose(bat.avgMetrics, theirs.avgMetrics, rtol=FLOAT_RTOL)


def test_batched_logistic_sweep_on_eight_shards():
    """The logistic sweep's lanes on 8 shards: accuracy avgMetrics equal to
    the 1-shard sweep's (margin-separated integer data)."""
    X, y = _int_cls(301, 6)
    df = port.DataFrame.from_numpy(X, y, num_partitions=3)
    grid = (port.ParamGridBuilder().addGrid(port.LogisticRegression.regParam, [0.01, 1.0])
            .addGrid(port.LogisticRegression.elasticNetParam, [0.0, 0.5]).build())
    eva = port.MulticlassClassificationEvaluator(metricName="accuracy")
    with use_device("cpu"):
        one = _cv(port.LogisticRegression(maxIter=200), grid, eva, df)
    port.clear_fit_cache()
    with use_device(["cpu"] * 8):
        eight = _cv(port.LogisticRegression(maxIter=200), grid, eva, df)
    assert eight.avgMetrics == one.avgMetrics
