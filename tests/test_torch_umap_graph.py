# The port's UMAP graph phase (spark_rapids_ml_tpu_torch/ops/umap.py)
# against the JAX package's (spark_rapids_ml_tpu/ops/umap.py) on the same
# numpy kNN graph, on the CPU: the smooth-kNN calibration, the fuzzy union,
# the label intersection, the on-device layout assembly and its host
# reference, and the XLA float32 exp and reduction order the port copies
# (ops/xla_math.py).
#
# Tolerances: rho / sigma, the fuzzy set and the label intersection rtol
# 1e-6 (exp and the reduction order may round apart); the assembly's
# degrees, starts and pad width P equal, and each head's (tail, weight)
# set equal (XLA's sort does not order tied weights, and a slot's position
# within its head is all that a tie moves); the host references, exp and
# the reduction order bit for bit.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import umap as ref
from spark_rapids_ml_tpu.parallel.mesh import padded_row_count

from spark_rapids_ml_tpu_torch.ops import umap as port


def _blob_graph(n=320, d=8, k=12, seed=0, self_noise=False):
    rng = np.random.default_rng(seed)
    centers = 10.0 * rng.normal(size=(3, d))
    labels = rng.integers(0, 3, size=n)
    X = (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)
    from sklearn.neighbors import NearestNeighbors as SkNN

    dists, ids = SkNN(n_neighbors=k).fit(X).kneighbors(X)
    dists = dists.astype(np.float32)
    if self_noise:
        # the expanded-form distance leaves small positive self distances
        dists[::3, 0] = 1e-4
    return ids.astype(np.int64), dists, labels


def _ref_weights(ids, dists):
    return np.asarray(ref._calibrated_weights(jnp.asarray(ids.astype(np.int32)), jnp.asarray(dists), 1.0, 1.0))


@pytest.mark.parametrize("lc", [1.0, 1.5, 2.0])
@pytest.mark.parametrize("self_noise", [False, True], ids=["exact_self", "noisy_self"])
def test_calibration_matches_reference(lc, self_noise):
    _, dists, _ = _blob_graph(seed=1, self_noise=self_noise)
    rho_r, sigma_r = ref.smooth_knn_calibration(jnp.asarray(dists), local_connectivity=lc)
    rho, sigma = port.smooth_knn_calibration(torch.from_numpy(dists), local_connectivity=lc)
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_r), rtol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_r), rtol=1e-6)


def test_calibration_with_padding_rows():
    # a transform bucket's all-zero padding rows must not move the floor
    _, dists, _ = _blob_graph(n=100, seed=2)
    dists = np.concatenate([dists, np.zeros((28, dists.shape[1]), np.float32)])
    rho_r, sigma_r = ref.smooth_knn_calibration(jnp.asarray(dists))
    rho, sigma = port.smooth_knn_calibration(torch.from_numpy(dists))
    np.testing.assert_allclose(rho.numpy(), np.asarray(rho_r), rtol=1e-6)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_r), rtol=1e-6)


@pytest.mark.parametrize("mix", [1.0, 0.5, 0.0])
def test_fuzzy_simplicial_set_matches_reference(mix):
    ids, dists, _ = _blob_graph(seed=3, self_noise=True)
    rho, sigma = ref.smooth_knn_calibration(jnp.asarray(dists))
    want = np.asarray(ref.fuzzy_simplicial_set(jnp.asarray(ids.astype(np.int32)), jnp.asarray(dists), rho, sigma, mix))
    got = port.fuzzy_simplicial_set(
        torch.from_numpy(ids), torch.from_numpy(dists), torch.from_numpy(np.asarray(rho)),
        torch.from_numpy(np.asarray(sigma)), mix,
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    whole = port._calibrated_weights(torch.from_numpy(ids), torch.from_numpy(dists), 1.0, mix)
    np.testing.assert_allclose(
        whole.numpy(),
        np.asarray(ref._calibrated_weights(jnp.asarray(ids.astype(np.int32)), jnp.asarray(dists), 1.0, mix)),
        rtol=1e-6, atol=1e-7,
    )


def test_categorical_intersection_matches_reference():
    ids, dists, labels = _blob_graph(n=240, seed=5)
    W = _ref_weights(ids, dists)
    codes = labels.astype(np.int32)
    codes[::7] = -1  # unknown labels
    want = np.asarray(ref.categorical_simplicial_set_intersection(
        jnp.asarray(W), jnp.asarray(ids.astype(np.int32)), jnp.asarray(codes)))
    got = port.categorical_simplicial_set_intersection(
        torch.from_numpy(W), torch.from_numpy(ids), torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_label_codes_nan_is_unknown():
    y = np.array([2.0, np.nan, 0.5, 2.0, np.inf])
    np.testing.assert_array_equal(port._label_codes(y), [1, -1, 0, 1, -1])


def _edge_set(tails, w, i):
    return sorted((int(t), float(x)) for t, x in zip(tails[i], w[i]) if x > 0)


@pytest.mark.parametrize("n,k,seed,n_epochs", [(200, 10, 3, 150), (320, 12, 0, 500), (500, 15, 6, 200)])
def test_device_assembly_matches_reference(n, k, seed, n_epochs):
    ids, dists, _ = _blob_graph(n=n, k=k, seed=seed)
    W = _ref_weights(ids, dists)
    n_pad = padded_row_count(n)
    jids = jnp.asarray(ids.astype(np.int32))
    # the stages: edges, then order and degree geometry
    r_edges = ref._graph_edges(jids, jnp.asarray(W))
    p_edges = port._graph_edges(torch.from_numpy(ids), torch.from_numpy(W))
    for a, b in zip(p_edges, jax.device_get(r_edges)):
        np.testing.assert_array_equal(a.numpy(), b)
    r_st, r_sw, r_starts, r_deg, r_q = ref._edge_order(
        *r_edges, jnp.float32(n_epochs), jnp.float32(ref._layout_quantile()), n_pad=n_pad)
    st, sw, starts, deg, q = port._edge_order(
        *p_edges, torch.tensor(float(n_epochs)), port.DEGREE_QUANTILE, n_pad)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(r_starts))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(r_deg))
    assert float(q) == float(r_q)
    # the padded layout: same P, same padding rows, same per-head edge sets
    r_tails, r_w = (np.asarray(a) for a in ref.build_head_layout_device(jids, jnp.asarray(W), n_pad, n_epochs))
    tails, w = port.build_head_layout_device(torch.from_numpy(ids), torch.from_numpy(W), n_pad, n_epochs)
    tails, w = tails.numpy(), w.numpy()
    assert tails.shape == r_tails.shape and tails.dtype == np.int32
    np.testing.assert_array_equal(tails[n:], r_tails[n:])
    np.testing.assert_array_equal(w[n:], 0.0)
    for i in range(n):
        assert _edge_set(tails, w, i) == _edge_set(r_tails, r_w, i), i
        # the slots a head fills come first, in weight-descending order
        np.testing.assert_array_equal(np.sort(w[i])[::-1], w[i])


def test_device_assembly_degree_cap_and_quantile():
    ids, dists, _ = _blob_graph(n=300, k=15, seed=7)
    W = torch.from_numpy(_ref_weights(ids, dists))
    t_default, _ = port.build_head_layout_device(torch.from_numpy(ids), W, 320, 200)
    t_narrow, _ = port.build_head_layout_device(torch.from_numpy(ids), W, 320, 200, cap=10)
    t_full, _ = port.build_head_layout_device(torch.from_numpy(ids), W, 320, 200, cap=200, quantile=1.0)
    assert t_narrow.shape[1] == 10 < t_default.shape[1] <= t_full.shape[1]


def test_host_references_bit_for_bit():
    ids, dists, _ = _blob_graph(n=260, k=12, seed=8)
    W = _ref_weights(ids, dists)
    for a, b in zip(port.dedupe_undirected(ids, W), ref.dedupe_undirected(ids, W)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    ii, jj, ww = ref.dedupe_undirected(ids, W)
    for kw in ({}, {"cap": 12}):
        got = port.padded_head_layout(ii, jj, ww, 260, **kw)
        want = ref.padded_head_layout(ii, jj, ww, 260, **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_exp_f32_is_xla_exp_bit_for_bit():
    from spark_rapids_ml_tpu_torch.ops.xla_math import exp_f32

    rng = np.random.default_rng(9)
    x = np.concatenate([
        -rng.uniform(0, 30, 50_000), rng.uniform(-2, 2, 20_000), [0.0, -0.0, 1e-8, -1e-8, -87.0, -88.5, -100.0, 50.0],
    ]).astype(np.float32)
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    np.testing.assert_array_equal(exp_f32(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("rows", [1, 12, 29, 33, 36, 100, 256, 1100])
def test_sum_dim0_is_xla_reduction_order(rows):
    from spark_rapids_ml_tpu_torch.ops.xla_math import sum_dim0

    rng = np.random.default_rng(rows)
    x = (rng.normal(size=(rows, 64)) * np.exp(rng.normal(size=(rows, 64)))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a.sum(axis=0))(jnp.asarray(x)))
    np.testing.assert_array_equal(sum_dim0(torch.from_numpy(x)).numpy(), want)
    want_rows = np.asarray(jax.jit(lambda a: a.sum(axis=1))(jnp.asarray(x.T.copy())))
    np.testing.assert_array_equal(sum_dim0(torch.from_numpy(x.T.copy()).T).numpy(), want_rows)
