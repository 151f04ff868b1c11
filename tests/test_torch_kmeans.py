# The port's KMeans (spark_rapids_ml_tpu_torch) against the JAX package's on
# the same numpy inputs, on the CPU: Lloyd from the same start, whole fits,
# weights carried across, persistence across packages, layouts and errors.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops.kmeans import lloyd_iterations as ref_lloyd
from spark_rapids_ml_tpu.ops.kmeans import random_init as ref_random_init
from spark_rapids_ml_tpu.parallel.mesh import get_mesh

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.convert import kmeans_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops.kmeans import lloyd_iterations, random_init

K = 5


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _blobs(n=800, d=16, k=K, seed=0, spread=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(k, d))
    labels = rng.integers(0, k, size=n)
    X = centers[labels] + spread * rng.standard_normal((n, d))
    return X.astype(np.float32), centers, labels


def _labels(df):
    return np.concatenate([np.asarray(p["prediction"]) for p in df.partitions])


def _ref_labels(model, X):
    return model.transform(RefDataFrame.from_numpy(X, num_partitions=2)).toPandas()["prediction"].to_numpy()


def _port_labels(model, X):
    return _labels(model.transform(port.DataFrame.from_numpy(X, num_partitions=2)))


def _match(centers_a, centers_b):
    """perm[j] = index of the center of b nearest to center j of a."""
    d = np.linalg.norm(centers_a[:, None, :] - centers_b[None, :, :], axis=-1)
    return d.argmin(axis=1)


def test_lloyd_matches_reference_from_same_start():
    X, _, _ = _blobs(n=600, d=8, seed=3, spread=2.5)
    w = np.ones(len(X), np.float32)
    rng = np.random.default_rng(4)
    centers0 = X[rng.choice(len(X), K, replace=False)]
    c_ref, it_ref, in_ref = ref_lloyd(
        jnp.asarray(X), jnp.asarray(w), jnp.asarray(centers0), get_mesh(1), 100, 1e-6, 128
    )
    c, it, inertia = lloyd_iterations(
        torch.from_numpy(X), torch.from_numpy(w), torch.from_numpy(centers0), 100, 1e-6, 128
    )
    assert it == int(it_ref) and it > 2
    # fp32 sums in another order than XLA's: centers to 1e-4, inertia to 1e-5
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(inertia, float(in_ref), rtol=1e-5)


def _covering_seed(draw_init, X, labels):
    """First seed whose random init picks one row of every blob: random init
    on tight blobs recovers them only from such a start (the reason
    k-means|| exists)."""
    for seed in range(200):
        picked = draw_init(seed)
        if len({int(labels[np.flatnonzero((X == row).all(axis=1))[0]]) for row in picked}) == K:
            return seed
    raise AssertionError("no covering seed")


@pytest.mark.parametrize("init_mode", ["k-means||", "random"])
def test_fit_recovers_blobs_like_reference(init_mode):
    X, true_centers, labels = _blobs()
    seed = 7
    if init_mode == "random":
        # the two packages draw the same init (the JAX package's threefry
        # Gumbel keys), so one covering seed serves both
        w = np.ones(len(X), np.float32)
        seed = _covering_seed(
            lambda s: np.asarray(ref_random_init(jnp.asarray(X), jnp.asarray(w), K, s)), X, labels
        )
        np.testing.assert_array_equal(
            random_init(torch.from_numpy(X), torch.from_numpy(w), K, seed).numpy(),
            np.asarray(ref_random_init(jnp.asarray(X), jnp.asarray(w), K, seed)),
        )
    m_ref = ref.KMeans(k=K, initMode=init_mode, maxIter=50, seed=seed).fit(
        RefDataFrame.from_numpy(X, num_partitions=4)
    )
    m = port.KMeans(k=K, initMode=init_mode, maxIter=50, seed=seed).fit(
        port.DataFrame.from_numpy(X, num_partitions=4)
    )
    for centers in (m_ref.cluster_centers_, m.cluster_centers_):
        assert np.linalg.norm(centers[_match(true_centers, centers)] - true_centers, axis=1).max() < 0.1
    perm = _match(m_ref.cluster_centers_, m.cluster_centers_)
    # one init from one seed: the same centres in the same order
    assert list(perm) == list(range(K))
    # both converged to the same partition: centers are the same means,
    # summed in fp32 in different orders
    np.testing.assert_allclose(m.cluster_centers_[perm], m_ref.cluster_centers_, atol=1e-4)
    np.testing.assert_allclose(m.inertia_, m_ref.inertia_, rtol=1e-4)
    np.testing.assert_array_equal(_port_labels(m, X), perm[_ref_labels(m_ref, X)])


@pytest.fixture(scope="module")
def ref_model():
    X, _, _ = _blobs(seed=1)
    model = ref.KMeans(k=K, maxIter=30, seed=3).fit(RefDataFrame.from_numpy(X, num_partitions=2))
    return model, X


def test_weights_carried_across_give_identical_labels(ref_model):
    model, X = ref_model
    attrs = {k: np.asarray(v) for k, v in model._get_model_attributes().items()}
    converted = kmeans_model_from_reference(attrs)
    np.testing.assert_array_equal(converted.cluster_centers_, model.cluster_centers_)
    with use_device("cpu"):
        np.testing.assert_array_equal(_port_labels(converted, X), _ref_labels(model, X))
    assert converted.predict(X[0]) == model.predict(X[0])


def test_model_saved_by_reference_loads_in_port(ref_model, tmp_path):
    model, X = ref_model
    model.save(str(tmp_path / "ref_km"))
    loaded = port.load(str(tmp_path / "ref_km"))
    assert type(loaded) is port.KMeansModel
    assert loaded.n_iter_ == model.n_iter_ and loaded.getOrDefault("k") == K
    np.testing.assert_array_equal(_port_labels(loaded, X), _ref_labels(model, X))


def test_port_save_load_round_trip(tmp_path):
    X, _, _ = _blobs(seed=2)
    model = port.KMeans(k=K, maxIter=20, seed=5).setPredictionCol("cluster").fit(
        port.DataFrame.from_numpy(X, num_partitions=3)
    )
    model.save(str(tmp_path / "km"))
    loaded = port.load(str(tmp_path / "km"))
    np.testing.assert_array_equal(loaded.cluster_centers_, model.cluster_centers_)
    assert (loaded.n_iter_, loaded.inertia_) == (model.n_iter_, model.inertia_)
    df = port.DataFrame.from_numpy(X, num_partitions=3)
    out, out_loaded = model.transform(df), loaded.transform(df)
    assert out_loaded.columns == ["features", "cluster"]
    np.testing.assert_array_equal(
        np.concatenate([p["cluster"] for p in out_loaded.partitions]),
        np.concatenate([p["cluster"] for p in out.partitions]),
    )


def test_multi_cols_layout_matches_array_layout():
    X, _, _ = _blobs(n=400, d=6, seed=4)
    names = [f"f{i}" for i in range(X.shape[1])]
    est = port.KMeans(k=K, maxIter=20, seed=2)
    m_arr = est.fit(port.DataFrame.from_numpy(X, num_partitions=2))
    df_cols = port.DataFrame.from_numpy(X, feature_layout="multi_cols", featuresCol=names, num_partitions=2)
    m_cols = port.KMeans(k=K, maxIter=20, seed=2).setFeaturesCols(names).fit(df_cols)
    np.testing.assert_array_equal(m_cols.cluster_centers_, m_arr.cluster_centers_)
    out = m_cols.setFeaturesCols(names).transform(df_cols)
    np.testing.assert_array_equal(_labels(out), _port_labels(m_arr, X))


def test_from_device_pad_rows_carry_no_weight():
    X, _, _ = _blobs(n=300, d=6, seed=6)
    padded = torch.cat([torch.from_numpy(X), torch.full((5, 6), 1e3)])
    est = port.KMeans(k=K, initMode="random", maxIter=20, seed=9)
    m_dev = est.fit(port.DataFrame.from_device(padded, n_rows=len(X)))
    m_host = est.fit(port.DataFrame.from_numpy(X))
    np.testing.assert_allclose(m_dev.cluster_centers_, m_host.cluster_centers_, rtol=1e-6, atol=1e-6)
    assert m_dev.n_iter_ == m_host.n_iter_


@pytest.mark.parametrize("package", [ref, port], ids=["reference", "port"])
def test_unsupported_params_raise(package):
    with pytest.raises(ValueError):
        package.KMeans(distanceMeasure="cosine")
    with pytest.raises(ValueError):
        package.KMeans().setWeightCol("w")
    assert "initSteps" not in package.KMeans(initSteps=5).tpu_params
