# The port's nearest-center op (spark_rapids_ml_tpu_torch/ops/nearest_center)
# against the JAX package's: its Pallas kernel in interpret mode and its XLA
# formulation, on the same numpy inputs.  Here on the CPU the port's wrapper
# takes its plain PyTorch version (the CUDA kernel is held against that plain
# version on the card by chip_smoke.py).
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.ops.pallas_tpu import (
    _min_dist_argmin_pallas,
    _min_dist_argmin_xla,
)
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import _build, nearest_center
from spark_rapids_ml_tpu_torch.ops.nearest_center import (
    min_dist_argmin,
    min_dist_argmin_plain,
)

# the tolerance tests/test_pallas.py states for min_d2 (fp32, different
# summation order); argmin must agree exactly
RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _inputs(n, d, k, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(dtype)
    C = rng.standard_normal((k, d)).astype(dtype)
    return X, C, (X * X).sum(axis=1), (C * C).sum(axis=1)


def _port(X, C, xn=None, cn=None):
    t = [None if a is None else torch.from_numpy(a) for a in (X, C, xn, cn)]
    md, am = min_dist_argmin(*t)
    return md.numpy(), am.numpy()


@pytest.mark.parametrize(
    "n,d,k",
    [
        (300, 70, 33),     # nothing aligned
        (512, 256, 128),   # everything aligned
        (129, 1, 2),       # degenerate feature dim
        (64, 515, 700),    # k > n, unaligned d
    ],
)
def test_matches_jax_kernel_and_xla(n, d, k):
    X, C, xn, cn = _inputs(n, d, k, seed=n + d + k)
    jargs = [jnp.asarray(a) for a in (X, C, xn, cn)]
    refs = jax.device_get(
        (_min_dist_argmin_pallas(*jargs, interpret=True), _min_dist_argmin_xla(*jargs))
    )
    md, am = _port(X, C, xn, cn)
    assert md.shape == (n,) and am.shape == (n,) and am.dtype == np.int32
    for md_ref, am_ref in refs:
        np.testing.assert_array_equal(am, am_ref)
        np.testing.assert_allclose(md, md_ref, rtol=RTOL, atol=ATOL)


def test_duplicate_centers_resolve_to_lowest_index():
    rng = np.random.default_rng(11)
    C = rng.standard_normal((9, 12)).astype(np.float32)
    C[6] = C[2]
    C[8] = C[2]
    C[7] = C[4]
    # rows sitting on the duplicated centers: exact ties in every package
    X = np.concatenate([np.repeat(C[[2, 4]], 5, axis=0), rng.standard_normal((20, 12))]).astype(np.float32)
    xn, cn = (X * X).sum(axis=1), (C * C).sum(axis=1)
    jargs = [jnp.asarray(a) for a in (X, C, xn, cn)]
    _, am_k = _min_dist_argmin_pallas(*jargs, interpret=True)
    _, am_x = _min_dist_argmin_xla(*jargs)
    _, am = _port(X, C, xn, cn)
    np.testing.assert_array_equal(am[:10], [2] * 5 + [4] * 5)
    np.testing.assert_array_equal(am, np.asarray(am_k))
    np.testing.assert_array_equal(am, np.asarray(am_x))
    assert not np.isin(am, [6, 7, 8]).any()


def test_precomputed_norms_match_computed():
    X, C, xn, cn = _inputs(100, 40, 7, seed=0)
    md1, am1 = _port(X, C, xn, cn)
    md2, am2 = _port(X, C)
    np.testing.assert_array_equal(am1, am2)
    np.testing.assert_allclose(md1, md2, rtol=1e-5)


def test_float64_matches_exact_reference():
    X, C, _, _ = _inputs(257, 33, 19, seed=5, dtype=np.float64)
    md, am = _port(X, C)
    assert md.dtype == np.float64
    d2 = ((X[:, None, :] - C[None, :, :]) ** 2).sum(axis=-1)
    np.testing.assert_array_equal(am, d2.argmin(axis=1))
    # float64 expanded form against the difference form: cancellation only
    np.testing.assert_allclose(md, d2.min(axis=1), rtol=1e-10, atol=1e-10)


def test_plain_version_chunks_rows(monkeypatch):
    # a block budget of a few rows forces many chunks and a ragged last one
    X, C, _, _ = _inputs(101, 9, 13, seed=3)
    whole = _port(X, C)
    monkeypatch.setattr(nearest_center, "_PLAIN_BLOCK_BYTES", 13 * 4 * 7)
    md, am = min_dist_argmin_plain(torch.from_numpy(X), torch.from_numpy(C))
    np.testing.assert_array_equal(am.numpy(), whole[1])
    np.testing.assert_array_equal(md.numpy(), whole[0])


def test_cpu_tensor_never_touches_the_kernel(monkeypatch):
    def no_library(name):
        raise AssertionError(f"kernel library {name} loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(min_dist_argmin, "launches", 0)
    X, C, _, _ = _inputs(64, 8, 5, seed=1)
    _port(X, C)
    assert min_dist_argmin.launches == 0


def test_other_devices_raise():
    X = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        min_dist_argmin(X, X)


@pytest.mark.parametrize(
    "case,error",
    [
        ("bf16", TypeError),
        ("mixed_dtype", TypeError),
        ("width_mismatch", ValueError),
        ("no_centers", ValueError),
        ("norm_shape", ValueError),
        ("non_contiguous", ValueError),
    ],
)
def test_kernel_wrapper_rejects_bad_inputs(monkeypatch, case, error):
    # the wrapper's checks run before the library is loaded or the kernel
    # launched, so they are exercised here on CPU tensors
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("reached the launch"))
    X, C = torch.ones((6, 4)), torch.ones((3, 4))
    xn, cn = X.sum(dim=1), C.sum(dim=1)
    if case == "bf16":
        X, C, xn, cn = (t.to(torch.bfloat16) for t in (X, C, xn, cn))
    elif case == "mixed_dtype":
        C = C.double()
    elif case == "width_mismatch":
        C = torch.ones((3, 5))
    elif case == "no_centers":
        C, cn = torch.ones((0, 4)), torch.ones(0)
    elif case == "norm_shape":
        xn = torch.ones(5)
    elif case == "non_contiguous":
        X = torch.ones((4, 6)).T
    with pytest.raises(error):
        nearest_center._min_dist_argmin_cuda(X, C, xn, cn)
