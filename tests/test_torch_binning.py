# The port's feature-major binning (spark_rapids_ml_tpu_torch/ops/binning.py,
# kernel B2) against the JAX package's: its Pallas kernel in interpret mode
# and its XLA compare-accumulate, on the same numpy inputs.  Bins are exact
# integers, so every comparison is exact.  Here on the CPU the wrapper takes
# its plain PyTorch version; chip_smoke.py holds the CUDA kernel against it
# on the card.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops.forest import bin_features_feature_major as ref_bin_fm
from spark_rapids_ml_tpu.ops.forest import compute_bin_edges as ref_edges
from spark_rapids_ml_tpu.ops.pallas_tpu import bin_features_fm_pallas
from spark_rapids_ml_tpu_torch.ops import _build, binning
from spark_rapids_ml_tpu_torch.ops.binning import bin_features_fm, bin_features_fm_plain
from spark_rapids_ml_tpu_torch.ops.forest import bin_features_feature_major, compute_bin_edges


def _data(n, d, n_bins, seed, specials=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    edges = ref_edges(X, n_bins)
    if specials:
        X[0, :] = np.nan
        X[1, :] = np.inf
        X[2, :] = -np.inf
        X[3, :] = edges[:, 0]        # equal to the first edge: not counted
        X[4, :] = edges[:, -1]       # equal to the last edge
        X[5, 0] = np.nan
    return X, edges


# (n, d, bins, n_pad, specials): the JAX suite's size, ragged rows and
# features, a single feature and edge, NaN / +-inf / values on an edge
CASES = [
    (2048, 8, 8, 2048, False),
    (300, 70, 32, 2048, False),
    (129, 1, 2, 2048, False),
    (2000, 5, 128, 4096, True),
]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "x".join(map(str, c[:3])) + ("-special" if c[4] else ""))
def case(request):
    n, d, n_bins, n_pad, specials = request.param
    X, edges = _data(n, d, n_bins, seed=n + d, specials=specials)
    kernel = np.asarray(bin_features_fm_pallas(jnp.asarray(X), jnp.asarray(edges), n_pad, interpret=True))
    xla = np.asarray(ref_bin_fm(jnp.asarray(X), jnp.asarray(edges), n_pad=n_pad))
    return X, edges, n_pad, kernel, xla


def test_matches_jax_kernel_and_xla(case):
    X, edges, n_pad, kernel, xla = case
    got = bin_features_fm(torch.from_numpy(X), torch.from_numpy(edges), n_pad).numpy()
    assert got.shape == (X.shape[1], n_pad) and got.dtype == np.int8
    np.testing.assert_array_equal(got, kernel)
    np.testing.assert_array_equal(got, xla)
    assert (got[:, X.shape[0]:] == 0).all()


def test_forest_entry_matches_wrapper(case):
    X, edges, n_pad, kernel, _ = case
    got = bin_features_feature_major(torch.from_numpy(X), torch.from_numpy(edges), n_pad)
    np.testing.assert_array_equal(got.numpy(), kernel)


def test_special_values_bin_as_the_compare_loop():
    X, edges = _data(64, 3, 16, seed=5, specials=True)
    got = bin_features_fm(torch.from_numpy(X), torch.from_numpy(edges), 64).numpy()
    assert (got[:, 0] == 0).all()                       # NaN -> 0
    assert (got[:, 1] == edges.shape[1]).all()          # +inf -> every edge
    assert (got[:, 2] == 0).all() and (got[:, 3] == 0).all()
    assert (got[:, 4] == edges.shape[1] - 1).all()      # x == last edge: strictly above the rest
    np.testing.assert_array_equal(got, (X.T[:, :, None] > edges[:, None, :]).sum(-1))


def test_searchsorted_agrees_on_sorted_edges():
    # the kernel's binary search, in PyTorch: the count of edges < x
    X, edges = _data(500, 6, 64, seed=9)
    want = torch.searchsorted(torch.from_numpy(edges.copy()), torch.from_numpy(X.T.copy()), side="left")
    got = bin_features_fm(torch.from_numpy(X), torch.from_numpy(edges), 500)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_compute_bin_edges_matches_reference():
    rng = np.random.default_rng(2)
    for X in (rng.standard_normal((3000, 7)).astype(np.float32), rng.integers(0, 4, (500, 3)).astype(np.float32)):
        for n_bins in (4, 32, 128):
            np.testing.assert_array_equal(compute_bin_edges(X, n_bins), ref_edges(X, n_bins))


def test_plain_version_chunks_rows(monkeypatch):
    X, edges = _data(301, 7, 16, seed=3)
    whole = bin_features_fm_plain(torch.from_numpy(X), torch.from_numpy(edges), 512)
    monkeypatch.setattr(binning, "_PLAIN_BLOCK_BYTES", 7 * 15 * 10)
    chunked = bin_features_fm_plain(torch.from_numpy(X), torch.from_numpy(edges), 512)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())


def test_cpu_tensor_never_touches_the_kernel(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"kernel library {name} loaded"))
    monkeypatch.setattr(bin_features_fm, "launches", 0)
    X, edges = _data(64, 4, 8, seed=1)
    bin_features_fm(torch.from_numpy(X), torch.from_numpy(edges), 64)
    assert bin_features_fm.launches == 0


def test_other_devices_raise():
    X = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        bin_features_fm(X, torch.empty((3, 2), device="meta"), 4)


@pytest.mark.parametrize(
    "case,error",
    [
        ("f64", TypeError),
        ("width_mismatch", ValueError),
        ("too_many_edges", ValueError),
        ("short_pad", ValueError),
        ("non_contiguous", ValueError),
        ("unsorted_edges", ValueError),
        ("nan_inside_edges", ValueError),
    ],
)
def test_kernel_wrapper_rejects_bad_inputs(monkeypatch, case, error):
    # the wrapper's checks run before the library is loaded, so they are
    # exercised here on CPU tensors
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("reached the launch"))
    X, edges, n_pad = torch.ones((6, 4)), torch.arange(12, dtype=torch.float32).reshape(4, 3), 8
    if case == "f64":
        X = X.double()
    elif case == "width_mismatch":
        edges = torch.zeros((5, 3))
    elif case == "too_many_edges":
        edges = torch.arange(4 * 128, dtype=torch.float32).reshape(4, 128)
    elif case == "short_pad":
        n_pad = 5
    elif case == "non_contiguous":
        X = torch.ones((4, 6)).T
    elif case == "unsorted_edges":
        edges[1] = torch.tensor([3.0, 1.0, 2.0])
    elif case == "nan_inside_edges":
        edges[2, 0] = float("nan")
    with pytest.raises(error):
        binning._bin_features_fm_cuda(X, edges, n_pad)


def test_trailing_nan_edges_are_accepted():
    edges = torch.tensor([[0.0, 1.0, float("nan"), float("nan")], [0.0, float("inf"), float("inf"), float("nan")]])
    binning.check_edges(edges)
