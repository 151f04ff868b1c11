# The port's lane kernels and lane paging (ops/lanes, ops/linalg, ops/glm,
# ops/logistic, ops/kmeans) against the JAX package's functions, on the CPU,
# on seeded numpy inputs: ragged lane assignments (some lanes with one row,
# some with none, pad lanes in the stack), integer-valued rows where every
# sum is exact (bit for bit, as tests/test_multiplex.py's gate) and Gaussian
# rows (rtol = atol = 1e-5, the serving tolerance of
# tests/test_torch_serving.py; labels off near-ties).  Each lane kernel is
# also held, bit for bit on every kind of row, against the port's dedicated
# kernel on each lane's rows: the port runs it once per distinct lane.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import glm as ref_glm
from spark_rapids_ml_tpu.ops import kmeans as ref_kmeans
from spark_rapids_ml_tpu.ops import lanes as ref_lanes
from spark_rapids_ml_tpu.ops import linalg as ref_linalg
from spark_rapids_ml_tpu.ops import logistic as ref_logistic

from spark_rapids_ml_tpu_torch.ops import glm, kmeans, linalg, logistic, precompile
from spark_rapids_ml_tpu_torch.ops.lanes import lane_bucket, stack_lanes, write_lane

RTOL = ATOL = 1e-5
N, D = 37, 11


def _rows(kind, n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    return rng.standard_normal((n, d)).astype(np.float32)


def _params(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _ragged_lanes(n, n_lanes, seed=3):
    """Lane ids over n rows: lane 0 gets one row, the last lane none, the
    rest random and unsorted (pad lanes of the stack stay unrouted)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, max(2, n_lanes - 1), size=n).astype(np.int32)
    ids[n // 2] = 0
    return ids


def _check(got, want, kind):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


KINDS = ("integer", "gaussian")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k_out", (1, 3))
def test_exact_gather_matmul_and_pca_lanes(kind, k_out):
    X = _rows(kind)
    stacked = _params(kind, (8, k_out, D), 1)
    ids = _ragged_lanes(N, 8)
    want = ref_linalg.exact_gather_matmul(jnp.asarray(X), jnp.asarray(stacked), jnp.asarray(ids))
    _check(linalg.exact_gather_matmul(torch.from_numpy(X), torch.from_numpy(stacked), torch.from_numpy(ids)), want,
           kind)
    want = ref_linalg.lane_pca_transform_kernel(jnp.asarray(X), jnp.asarray(ids), jnp.asarray(stacked))
    got = linalg.lane_pca_transform_kernel(torch.from_numpy(X), torch.from_numpy(ids), torch.from_numpy(stacked))
    _check(got, want, kind)
    for lane in np.unique(ids):  # each lane's rows: the dedicated projection's, bit for bit
        rows = ids == lane
        ded = linalg.pca_transform_kernel(torch.from_numpy(X[rows]), torch.from_numpy(stacked[lane]))
        np.testing.assert_array_equal(got[torch.from_numpy(rows)].numpy(), ded.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_lane_linear_predict_kernel(kind):
    X = _rows(kind)
    coefs, intercepts = _params(kind, (4, D), 2), _params(kind, (4,), 3)
    ids = _ragged_lanes(N, 4)
    want = ref_glm.lane_linear_predict_kernel(jnp.asarray(X), jnp.asarray(ids), jnp.asarray(coefs),
                                              jnp.asarray(intercepts))
    got = glm.lane_linear_predict_kernel(torch.from_numpy(X), torch.from_numpy(ids), torch.from_numpy(coefs),
                                         torch.from_numpy(intercepts))
    _check(got, want, kind)
    for lane in np.unique(ids):
        rows = ids == lane
        ded = glm.linear_predict_kernel(torch.from_numpy(X[rows]), torch.from_numpy(coefs[lane]),
                                        torch.tensor(intercepts[lane]))
        np.testing.assert_array_equal(got[torch.from_numpy(rows)].numpy(), ded.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_multi_linear_predict_kernel(kind):
    X = _rows(kind)
    coefs, intercepts = _params(kind, (5, D), 4), _params(kind, (5,), 5)
    want = ref_glm.multi_linear_predict_kernel(jnp.asarray(X), jnp.asarray(coefs), jnp.asarray(intercepts))
    _check(glm.multi_linear_predict_kernel(torch.from_numpy(X), torch.from_numpy(coefs),
                                           torch.from_numpy(intercepts)), want, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("num_classes", (2, 4))
def test_lane_logistic_predict_kernel(kind, num_classes):
    X = _rows(kind)
    k = 1 if num_classes == 2 else num_classes
    Ws, bs = _params(kind, (4, k, D), 6), _params(kind, (4, k), 7)
    ids = _ragged_lanes(N, 4)
    want = ref_logistic.lane_logistic_predict_kernel(jnp.asarray(X), jnp.asarray(ids), jnp.asarray(Ws),
                                                     jnp.asarray(bs), num_classes=num_classes)
    got = logistic.lane_logistic_predict_kernel(torch.from_numpy(X), torch.from_numpy(ids), torch.from_numpy(Ws),
                                                torch.from_numpy(bs), num_classes=num_classes)
    assert len(got) == 3
    for lane in np.unique(ids):
        rows = ids == lane
        ded = logistic.logistic_decision_kernel(torch.from_numpy(X[rows]), torch.from_numpy(Ws[lane]),
                                                torch.from_numpy(bs[lane]))
        np.testing.assert_array_equal(got[0][torch.from_numpy(rows)].numpy(), ded.numpy())
    scores, probs, labels = (np.asarray(w) for w in want)
    _check(got[0], scores, kind)
    # probabilities: a sigmoid / softmax of equal scores, within the serving
    # tolerance (torch's and XLA's float32 exp may differ in the last bit)
    np.testing.assert_allclose(got[1].numpy(), probs, rtol=RTOL, atol=ATOL)
    ties = np.zeros(N, bool)
    if kind == "gaussian":  # labels off near-ties of the two best scores
        s = np.sort(scores, axis=1)
        ties = (np.abs(scores[:, 0]) < 1e-5) if k == 1 else (s[:, -1] - s[:, -2] < 1e-5)
    np.testing.assert_array_equal(got[2].numpy()[~ties], labels[~ties])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ("ragged", "one_lane", "every_lane"))
def test_lane_kmeans_predict_kernel(kind, layout):
    X = _rows(kind, n=53)
    centers = _params(kind, (8, 6, D), 8) * (2 if kind == "integer" else 1)
    ids = {"ragged": _ragged_lanes(53, 8), "one_lane": np.full(53, 5, np.int32),
           "every_lane": (np.arange(53) % 8).astype(np.int32)}[layout]
    want = np.asarray(ref_kmeans.lane_kmeans_predict_kernel(jnp.asarray(X), jnp.asarray(ids), jnp.asarray(centers)))
    got = kmeans.lane_kmeans_predict_kernel(torch.from_numpy(X), torch.from_numpy(ids), torch.from_numpy(centers))
    assert got.dtype == torch.int32 and tuple(got.shape) == (53,)
    got = got.numpy()
    # the dedicated kernel on each lane's rows: the same labels
    for lane in np.unique(ids):
        rows = ids == lane
        ded = kmeans.kmeans_predict_kernel(torch.from_numpy(X[rows]), torch.from_numpy(centers[lane])).numpy()
        np.testing.assert_array_equal(got[rows], ded)
    if kind == "integer":
        np.testing.assert_array_equal(got, want)
    else:  # off near-ties of the two best float64 distances
        d2 = ((X.astype(np.float64)[:, None, :] - centers.astype(np.float64)[ids]) ** 2).sum(axis=2)
        s = np.sort(d2, axis=1)
        ties = s[:, 1] - s[:, 0] < 1e-5 * s[:, 1]
        np.testing.assert_array_equal(got[~ties], want[~ties])


def test_stack_lanes_and_write_lane_match_jax():
    """K variants with a matrix leaf and a 0-d leaf, stacked on a pow2 lane
    axis (pad lanes repeat variant 0), then a spilled variant paged into
    lane 2 and lane 0 rewritten: the port's in-place tensors equal the JAX
    package's new tuples after each write, and each write is one warm-cache
    key per leaf."""
    rng = np.random.default_rng(9)
    variants = [(rng.standard_normal((3, D)).astype(np.float32), np.asarray(np.float32(i))) for i in range(6)]
    bucket = lane_bucket(3)
    assert bucket == ref_lanes.lane_bucket(3) == 4
    port = stack_lanes(variants[:3], bucket, torch.device("cpu"))
    ref = ref_lanes.stack_lanes(variants[:3], bucket)
    assert [tuple(t.shape) for t in port] == [tuple(r.shape) for r in ref] == [(4, 3, D), (4,)]
    for t, r in zip(port, ref):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    before = precompile.warm_cache_stats()["entries"]
    for lane, v in ((2, variants[4]), (0, variants[5])):
        assert write_lane(port, lane, v, name="test.lanes") is None  # CPU: synchronous, no event
        ref = ref_lanes.write_lane(ref, lane, v, name="test.lanes")
        for t, r in zip(port, ref):
            np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    assert precompile.warm_cache_stats()["entries"] - before <= 2  # <name>.write0 / .write1, once each
    with pytest.raises(ValueError, match="bucket"):
        stack_lanes(variants[:3], 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="at least one"):
        stack_lanes([], 4, torch.device("cpu"))
    assert jax.devices()[0].platform == "cpu"
