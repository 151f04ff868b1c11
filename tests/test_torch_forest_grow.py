# The port's RandomForest growth (spark_rapids_ml_tpu_torch/ops/forest_grow.py)
# against the JAX package's grow_forest_mxu with its Pallas kernels in
# interpret mode, on the CPU, from the same numpy bins, bootstrap weights and
# seed, random feature subsets on: classification trees identical
# (impurities to 1e-6: XLA fuses the gini multiply-adds into FMAs, PyTorch
# does not), regression by the JAX suite's growth contract (shallow nodes
# >= 0.97 equal, all nodes >= 0.85, normalised MSE within 0.03); and the
# prediction traversal against the JAX package's.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops.forest import bin_features as ref_bin_features
from spark_rapids_ml_tpu.ops.forest import compute_bin_edges as ref_edges
from spark_rapids_ml_tpu.ops.forest import forest_predict_kernel as ref_predict
from spark_rapids_ml_tpu.ops.forest_mxu import grow_forest_mxu, mxu_depth_supported

from spark_rapids_ml_tpu_torch.ops.forest import forest_predict
from spark_rapids_ml_tpu_torch.ops.forest_grow import depth_supported, grow_forest
from spark_rapids_ml_tpu_torch.ops.labels import encode_labels

N, D, T = 2048, 8, 2


def _classification(classes, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (X @ rng.standard_normal((D, classes))).argmax(1).astype(np.float32)
    return X, y


def _regression(seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, D)).astype(np.float32)
    y = (X @ rng.standard_normal(D) + 0.1 * rng.standard_normal(N)).astype(np.float32)
    return X, y



GROW_CASES = {
    # 4 classes: the slot budget ends the shallow phase at level 5, so depth 7
    # runs one bucketed split level (6) and the bucketed leaf level (7)
    "gini4_depth7": ("gini", 4, 7, 4),
    # 2 stat rows: shallow to level 6, bucketed splits at level 7
    "regression_depth8": ("regression", 2, 8, 4),
}


@pytest.fixture(scope="module", params=sorted(GROW_CASES))
def grown(request):
    kind, C, depth, B = GROW_CASES[request.param]
    if kind == "regression":
        X, y = _regression(seed=12)
        base = np.stack([np.ones(N, np.float32), y])
        stats3 = np.stack([np.ones(N, np.float32), y, y * y])
    else:
        X, y = _classification(classes=C, seed=11)
        base = np.stack([(y == c) for c in range(C)]).astype(np.float32)
        stats3 = None
    edges = ref_edges(X, B)
    bins_fm = np.ascontiguousarray(np.asarray(ref_bin_features(jnp.asarray(X), jnp.asarray(edges))).T).astype(np.int8)
    w_trees = np.random.default_rng(4).poisson(1.0, (T, N)).astype(np.float32)
    kw = dict(max_depth=depth, n_bins=B, kind=kind, max_features=5, min_samples_leaf=1.0,
              min_impurity_decrease=0.0, seed=3)
    want = grow_forest_mxu(
        jnp.asarray(bins_fm), jnp.asarray(base), jnp.asarray(w_trees),
        None if stats3 is None else jnp.asarray(stats3), edges, y_vals=jnp.asarray(y), interpret=True, **kw,
    )
    got = grow_forest(
        torch.from_numpy(bins_fm), torch.from_numpy(base), torch.from_numpy(w_trees),
        None if stats3 is None else torch.from_numpy(stats3), edges, y_vals=torch.from_numpy(y), **kw,
    )
    return kind, depth, X, y, [np.asarray(a) for a in want], got


def test_grown_trees(grown):
    kind, depth, X, y, want, got = grown
    f_ref, t_ref, v_ref, n_ref, i_ref = want
    f, t, v, n, imp = got
    assert f.shape == f_ref.shape and v.shape == v_ref.shape
    if kind != "regression":
        # integer stats: every histogram exact, the same splits
        np.testing.assert_array_equal(f, f_ref)
        np.testing.assert_array_equal(t, t_ref)
        np.testing.assert_array_equal(v, v_ref)
        np.testing.assert_array_equal(n, n_ref)
        np.testing.assert_allclose(imp, i_ref, rtol=0, atol=1e-6)
        assert (f[:, 2**6 - 1 :] >= 0).any()  # the bucketed level splits
        return
    # float stats: the JAX suite's growth contract
    shallow = slice(0, 2**5 - 1)
    assert (f[:, shallow] == f_ref[:, shallow]).mean() > 0.97
    assert (f == f_ref).mean() > 0.85
    args = lambda ff, tt, vv: (jnp.asarray(X), jnp.asarray(ff), jnp.asarray(tt), jnp.asarray(vv))  # noqa: E731
    p1 = np.asarray(ref_predict(*args(f, t, v), max_depth=depth))[:, 0]
    p2 = np.asarray(ref_predict(*args(f_ref, t_ref, v_ref), max_depth=depth))[:, 0]
    e1, e2 = ((p1 - y) ** 2).mean() / y.var(), ((p2 - y) ** 2).mean() / y.var()
    assert abs(e1 - e2) < 0.03, (e1, e2)


def test_predict_matches_reference_traversal(grown):
    kind, depth, X, _, _, (f, t, v, _, _) = grown
    want = np.asarray(ref_predict(jnp.asarray(X), jnp.asarray(f), jnp.asarray(t), jnp.asarray(v), max_depth=depth))
    got = forest_predict(torch.from_numpy(X), torch.from_numpy(f), torch.from_numpy(t), torch.from_numpy(v), depth)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("depth,s_dim", [(13, 2), (14, 2), (11, 3), (12, 3), (9, 8), (10, 8)])
def test_depth_support_matches_reference(depth, s_dim):
    assert depth_supported(depth, s_dim) == mxu_depth_supported(depth, s_dim)


def test_encode_labels_counts_classes_below():
    classes = torch.tensor([-1, 2, 5], dtype=torch.int32)
    y = torch.tensor([-1, 2, 5, 0, 9, -7], dtype=torch.int32)
    assert encode_labels(y, classes).tolist() == [0, 1, 2, 1, 2, 0]
