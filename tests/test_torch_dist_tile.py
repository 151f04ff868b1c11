# The inputs that reach the pipelined fp32 distance-tile loop's 4-byte copies
# (spark_rapids_ml_tpu_torch/csrc/fp32_dist_tile.cuh): row starts that are
# not 16-byte aligned, from d % 4 != 0 or from a view that begins inside a
# row.  The copy width the float32 kernels take (ops/nearest_center.copy_bytes,
# the rule their C entries apply) at the shapes the port gives them, and the
# nearest-center search (B1), the kNN candidate pool (B5/B6) and the audit
# count (B8) on such inputs against the JAX package's Pallas kernels in
# interpret mode.  On the CPU the port's
# wrappers take their plain PyTorch versions; the CUDA kernels are held
# against those on the card by chip_smoke.py.  The data sit on a 1/4 grid
# (B1) or on small integers (B8), so every product and partial sum is exact in
# fp32 and any summation order gives the same bits: equal bit for bit.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.ops.pallas_knn import knn_candidates_pallas, knn_count_pallas
from spark_rapids_ml_tpu.ops.pallas_tpu import min_dist_argmin as jax_min_dist_argmin
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import knn_kernels as kk
from spark_rapids_ml_tpu_torch.ops.nearest_center import copy_bytes, min_dist_argmin


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _view(a, layout):
    """a as a torch tensor laid out as `layout` says: "fresh" (its own
    allocation), "row_slice" (rows 1.. of a contiguous tensor one row
    longer) or "flat_offset" (a view one element into a flat buffer)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if layout == "fresh":
        return t.clone()
    if layout == "row_slice":
        big = torch.zeros((a.shape[0] + 1, a.shape[1]), dtype=t.dtype)
        big[1:] = t
        return big[1:]
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


# (d, layout, copy bytes): the kernel-check shapes of chip_smoke.py (d = 70,
# 256, 1, 515, 32, 3000), the ANN fit's (256, 8), and the two misaligned
# layouts; a row slice stays aligned when d % 4 == 0
COPY_CASES = [
    (70, "fresh", 4), (256, "fresh", 16), (1, "fresh", 4), (515, "fresh", 4), (32, "fresh", 16),
    (3000, "fresh", 16), (8, "fresh", 16),
    (3000, "row_slice", 16), (70, "row_slice", 4), (515, "row_slice", 4),
    (3000, "flat_offset", 4), (256, "flat_offset", 4), (8, "flat_offset", 4),
]


@pytest.mark.parametrize("d,layout,want", COPY_CASES, ids=lambda v: str(v))
def test_copy_width_follows_row_alignment(d, layout, want):
    X = _view(np.zeros((6, d), np.float32), layout)
    C = torch.zeros((3, d))
    assert X.is_contiguous()
    assert copy_bytes(X, C) == want
    # the centers' alignment counts as much as X's
    assert copy_bytes(C, _view(np.zeros((3, d), np.float32), "flat_offset")) == 4


def _quarter(rng, shape):
    return (np.round(rng.standard_normal(shape) * 4) / 4).astype(np.float32)


@pytest.mark.parametrize(
    "n,d,k,layout",
    [
        (200, 515, 37, "fresh"),        # d % 4 == 3
        (129, 70, 33, "row_slice"),     # rows start 8 bytes off a 16-byte boundary
        (150, 256, 20, "flat_offset"),  # d % 4 == 0, base one element off
        (77, 3, 5, "flat_offset"),
    ],
)
def test_min_dist_argmin_on_misaligned_rows_matches_jax_bitwise(n, d, k, layout):
    rng = np.random.default_rng(n + d + k)
    X, C = _quarter(rng, (n, d)), _quarter(rng, (k, d))
    C[k - 1] = C[0]  # exact ties resolve to the lower index
    Xt = _view(X, layout)
    assert copy_bytes(Xt, torch.from_numpy(C)) == 4
    md, am = min_dist_argmin(Xt, torch.from_numpy(C))
    md_ref, am_ref = jax.device_get(jax_min_dist_argmin(jnp.asarray(X), jnp.asarray(C), interpret=True))
    np.testing.assert_array_equal(am.numpy(), am_ref)
    np.testing.assert_array_equal(md.numpy().view(np.uint32), np.asarray(md_ref, np.float32).view(np.uint32))
    assert not (am.numpy() == k - 1).any()


@pytest.mark.parametrize(
    "n,d,q,layout",
    [
        (300, 37, 40, "fresh"),       # d % 4 == 1
        (257, 70, 33, "row_slice"),   # rows start 8 bytes off
        (200, 64, 29, "flat_offset"),
    ],
)
def test_knn_count_on_misaligned_rows_matches_jax(n, d, q, layout):
    rng = np.random.default_rng(n + d + q)
    items = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    Q = rng.integers(-3, 4, size=(q, d)).astype(np.float32)
    norms = (items * items).sum(axis=1)
    valid = np.ones(n, bool)
    valid[-3:] = False
    # thresholds on exact -d2 values of the data: ties at the threshold
    d2 = ((Q[:, None, :] - items[None]) ** 2).sum(-1)
    thresh = -np.median(d2, axis=1).astype(np.float32)
    it, qt = _view(items, layout), _view(Q, layout)
    assert copy_bytes(it, qt) == 4
    counts = kk.knn_count(it, torch.from_numpy(norms), torch.from_numpy(valid), qt, torch.from_numpy(thresh))
    want = jax.device_get(knn_count_pallas(
        jnp.asarray(items), jnp.asarray(norms), jnp.asarray(valid), jnp.asarray(Q), jnp.asarray(thresh), n,
        interpret=True,
    ))
    np.testing.assert_array_equal(counts.numpy(), want)
    brute = (-d2[:, valid] > thresh[:, None]).sum(axis=1)
    np.testing.assert_array_equal(counts.numpy(), brute)


@pytest.mark.parametrize(
    "n,d,q,m,layout",
    [
        (1100, 37, 130, 9, "fresh"),       # d % 4 == 1, a ragged group and query tile
        (1500, 70, 33, 32, "row_slice"),   # rows start 8 bytes off
        (1030, 64, 129, 5, "flat_offset"),
    ],
)
def test_knn_pool_on_misaligned_rows_matches_jax_bitwise(n, d, q, m, layout):
    rng = np.random.default_rng(n + d + q)
    items = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    Q = rng.integers(-3, 4, size=(q, d)).astype(np.float32)
    norms = (items * items).sum(axis=1)
    valid = np.ones(n, bool)
    valid[-7:] = False
    it, qt = _view(items, layout), _view(Q, layout)
    assert copy_bytes(it, qt) == 4
    vals, pos = kk.knn_candidates(it, torch.from_numpy(norms), torch.from_numpy(valid), qt, m)
    cv, ci = jax.device_get(knn_candidates_pallas(
        jnp.asarray(items), jnp.asarray(norms), jnp.asarray(valid), jnp.asarray(Q), m, m, n, interpret=True,
    ))
    ng = -(-n // kk.GROUP)
    np.testing.assert_array_equal(vals.numpy().view(np.uint32), cv.reshape(q, ng, m).view(np.uint32))
    np.testing.assert_array_equal(pos.numpy(), ci.reshape(q, ng, m))
    assert (pos.numpy()[np.isfinite(vals.numpy())] < n - 7).all()
