# The port's PCA (spark_rapids_ml_tpu_torch) against the JAX package's on
# the same numpy inputs, on the CPU: sign_flip, the weighted moments,
# pca_fit on both of the JAX package's CPU routes (its f32 eigh below
# D = 128, its float64 host eigh from 128 up), the transform, whole fits with
# weights and whiten, persistence across packages.
#
# Tolerances: the port accumulates the moments over row chunks and the JAX
# package in one product, so float32 moments agree to ~1e-6 relative; the
# fitted attributes are held to the JAX package's own PCA test gates (mean
# atol 1e-4, |components| atol 1e-3, ratio atol 1e-4, singular values rtol
# 1e-3) and component signs must be equal.
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops import linalg as ref_linalg

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.convert import pca_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import linalg


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _low_rank(n=600, d=12, rank=3, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    basis = rng.normal(size=(rank, d))
    scales = np.linspace(3.0, 1.0, rank)[:, None]
    X = rng.normal(size=(n, rank)) @ (basis * scales) + noise * rng.normal(size=(n, d)) + rng.normal(size=d)
    return X.astype(np.float32)


def _gates(got, want, k):
    mean, comps, var, ratio, sv = (np.asarray(a, np.float64) for a in got)
    r_mean, r_comps, r_var, r_ratio, r_sv = (np.asarray(a, np.float64) for a in want)
    np.testing.assert_allclose(mean, r_mean, atol=1e-4)
    assert comps.shape == r_comps.shape == (k, r_mean.shape[0])
    np.testing.assert_array_equal(np.sign(comps[np.arange(k), np.abs(r_comps).argmax(axis=1)]), 1.0)
    np.testing.assert_allclose(comps, r_comps, atol=1e-3)
    np.testing.assert_allclose(var, r_var, rtol=1e-3)
    np.testing.assert_allclose(ratio, r_ratio, atol=1e-4)
    np.testing.assert_allclose(sv, r_sv, rtol=1e-3)


@pytest.mark.parametrize("shape", [(5, 12), (7, 3), (4, 200)])
def test_sign_flip_matches_reference(shape):
    rng = np.random.default_rng(shape[1])
    C = rng.normal(size=shape).astype(np.float32)
    C[0, 1] = -10.0  # a row whose largest entry is negative
    got = linalg.sign_flip(torch.from_numpy(C)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_linalg.sign_flip(jnp.asarray(C))))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("chunk", [64, 32768], ids=["chunked", "one_chunk"])
def test_weighted_moments_match_reference(weighted, chunk):
    X = _low_rank(n=500, d=9, seed=1)
    rng = np.random.default_rng(2)
    w = rng.uniform(0.5, 2.0, size=len(X)).astype(np.float32) if weighted else np.ones(len(X), np.float32)
    w[-7:] = 0.0  # padded rows
    wsum, mean, scatter = linalg.weighted_moments(torch.from_numpy(X), torch.from_numpy(w), chunk=chunk)
    r_wsum, r_mean, r_scatter = ref_linalg.weighted_moments(jnp.asarray(X), jnp.asarray(w))
    np.testing.assert_allclose(float(wsum), float(r_wsum), rtol=1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(r_mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scatter.numpy(), np.asarray(r_scatter), rtol=1e-5, atol=1e-3)


# D below and above the JAX package's HOST_EIGH_MIN_D = 128: its f32 device
# eigh and its float64 host eigh, against the port's one float64 route
@pytest.mark.parametrize("d", [16, 160])
@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_pca_fit_matches_reference_on_both_cpu_routes(d, weighted):
    assert (d >= ref_linalg.HOST_EIGH_MIN_D) == (d == 160)
    X = _low_rank(n=2000, d=d, rank=4, seed=d)
    w = np.random.default_rng(3).uniform(0.2, 3.0, size=len(X)).astype(np.float32) if weighted else np.ones(
        len(X), np.float32)
    got = linalg.pca_fit(torch.from_numpy(X), torch.from_numpy(w), 4, chunk=512)
    assert all(t.dtype == torch.float64 for t in got)
    want = ref_linalg.pca_fit(jnp.asarray(X), jnp.asarray(w), 4)
    _gates([t.numpy() for t in got], want, 4)


def test_pca_from_moments_kernel_equals_pca_fit():
    X = _low_rank(n=300, d=10, seed=4)
    w = torch.ones(len(X))
    wsum, xwsum, scatter = linalg._local_moments(torch.from_numpy(X), w)
    a = linalg.pca_from_moments_kernel(wsum, xwsum, scatter, 3)
    b = linalg.pca_fit(torch.from_numpy(X), w, 3)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_pca_transform_kernel_matches_reference():
    X = _low_rank(n=256, d=20, seed=5)
    comps = np.random.default_rng(6).normal(size=(3, 20)).astype(np.float32)
    got = linalg.pca_transform_kernel(torch.from_numpy(X), torch.from_numpy(comps)).numpy()
    want = np.asarray(ref_linalg.pca_transform_kernel(jnp.asarray(X), jnp.asarray(comps)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # Spark semantics: no mean removal
    np.testing.assert_allclose(got, X.astype(np.float64) @ comps.T.astype(np.float64), rtol=1e-5, atol=1e-4)


def _features(df, col="pca_features"):
    return np.concatenate([np.asarray(p[col]) for p in df.partitions])


@pytest.mark.parametrize("whiten", [False, True], ids=["plain", "whiten"])
def test_estimator_matches_reference_end_to_end(whiten, tmp_path):
    X = _low_rank(n=1200, d=140, rank=5, seed=7)
    m_ref = ref.PCA(k=5, whiten=whiten).fit(RefDataFrame.from_numpy(X, num_partitions=3))
    model = port.PCA(k=5, whiten=whiten).fit(port.DataFrame.from_numpy(X, num_partitions=3))
    _gates(
        [model.mean_, model.components_, model.explained_variance_, model.explained_variance_ratio_,
         model.singular_values_],
        [m_ref.mean_, m_ref.components_, m_ref.explained_variance_, m_ref.explained_variance_ratio_,
         m_ref.singular_values_],
        5,
    )
    assert model.components_.dtype == np.float64 and model.n_cols == 140 and model.dtype == "float32"
    df = port.DataFrame.from_numpy(X, num_partitions=2)
    out = _features(model.transform(df))
    want = np.stack(m_ref.transform(RefDataFrame.from_numpy(X, num_partitions=2)).toPandas()["pca_features"])
    np.testing.assert_allclose(out, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    model.save(str(tmp_path / "pca"))
    loaded = port.load(str(tmp_path / "pca"))
    assert type(loaded) is port.PCAModel and loaded.getK() == 5
    np.testing.assert_array_equal(_features(loaded.transform(df)), out)


def test_model_saved_by_reference_loads_in_port(tmp_path):
    X = _low_rank(n=400, d=8, seed=8)
    m_ref = ref.PCA(k=3, whiten=True).setOutputCol("proj").fit(RefDataFrame.from_numpy(X, num_partitions=2))
    m_ref.save(str(tmp_path / "ref_pca"))
    loaded = port.load(str(tmp_path / "ref_pca"))
    assert type(loaded) is port.PCAModel and loaded.getOutputCol() == "proj"
    assert loaded.tpu_params["whiten"] is True
    np.testing.assert_array_equal(loaded.components_, m_ref.components_)
    got = _features(loaded.transform(port.DataFrame.from_numpy(X)), "proj")
    want = np.stack(m_ref.transform(RefDataFrame.from_numpy(X)).toPandas()["proj"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_model_from_reference_attributes():
    X = _low_rank(n=300, d=6, seed=9)
    m_ref = ref.PCA(k=2).fit(RefDataFrame.from_numpy(X))
    attrs = {k: np.asarray(v) if not isinstance(v, (int, str)) else v
             for k, v in m_ref._get_model_attributes().items()}
    model = pca_model_from_reference(attrs)
    for name in ("mean_", "components_", "explained_variance_", "explained_variance_ratio_", "singular_values_"):
        np.testing.assert_array_equal(getattr(model, name), getattr(m_ref, name))
    assert model.getK() == 2 and model.mean == m_ref.mean
    np.testing.assert_array_equal(model.pc, m_ref.pc)
    np.testing.assert_array_equal(model.explainedVariance, m_ref.explainedVariance)


def test_input_cols_and_params():
    X = _low_rank(n=200, d=5, seed=10)
    names = [f"c{i}" for i in range(5)]
    df = port.DataFrame.from_numpy(X, feature_layout="multi_cols", featuresCol=names)
    m_cols = port.PCA(k=2).setInputCols(names).fit(df)
    m_arr = port.PCA(k=2).fit(port.DataFrame.from_numpy(X))
    np.testing.assert_allclose(m_cols.components_, m_arr.components_, atol=1e-12)
    assert port.PCA(k=3).tpu_params["n_components"] == 3
    assert port.PCA(n_components=4).getOrDefault("k") == 4
    assert port.PCA().fit(port.DataFrame.from_numpy(X)).getK() == 5


def test_hooks_not_in_this_slice_raise():
    model = port.PCA(k=1).fit(port.DataFrame.from_numpy(_low_rank(n=50, d=3, seed=11)))
    # streaming (ROADMAP A12) works now (tests/test_torch_streaming.py)
    assert type(port.PCA().streaming()).__name__ == "StreamingPCA"
    # serving (ROADMAP A13a) works now (tests/test_torch_serving.py)
    assert type(model._serving_entry()).__name__ == "ServingEntry"
    # multiplexed serving (ROADMAP A13b) works now (tests/test_torch_multiplex.py)
    lane = model._lane_entry()
    assert (type(lane).__name__, lane.name, lane.info) == ("LaneEntry", "lanes.pca", {"k": 1})
    assert [np.shape(leaf) for leaf in lane.leaves] == [(1, 3)]
    # cpu() (ROADMAP A14c-2) needs pyspark: without it, the JAX package's
    # ImportError (tests/test_torch_interop.py holds the conversion itself)
    from spark_rapids_ml_tpu.spark.interop import _require_pyspark

    with pytest.raises(ImportError) as want:
        _require_pyspark()
    with pytest.raises(ImportError, match=re.escape(str(want.value))):
        model.cpu()
