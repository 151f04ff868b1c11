# The port's exact-kNN kernels (spark_rapids_ml_tpu_torch/ops/knn_kernels:
# B5/B6 candidate pool, B7 fused merge, B8 audit count) against the JAX
# package's Pallas kernels in interpret mode, on the same numpy inputs.  Here
# on the CPU the port's wrappers take their plain PyTorch versions (the CUDA
# kernels are held against those on the card by chip_smoke.py).  Shapes are
# those of tests/test_pallas.py.
#
# Tolerances: the JAX kernels compute d2 with a 3-pass bf16 dot (~2^-19
# relative), the port in exact fp32, so merged distances agree within rtol
# 1e-3 / atol 1e-3 (the JAX tests' tolerance against brute force) and
# positions may differ at near-ties (>= 95% of rows equal on Gaussian data).
# On small-integer data both are exact: pools, positions and counts must be
# equal bit for bit.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.ops.knn import _select_m as ref_select_m
from spark_rapids_ml_tpu.ops.pallas_knn import (
    knn_candidates_pallas,
    knn_count_pallas,
    knn_fused_pallas,
)
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import knn as port_knn
from spark_rapids_ml_tpu_torch.ops import knn_kernels as kk

RTOL = ATOL = 1e-3


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _m(k, n):
    # the JAX tests' budget (one group may hold all k), capped at the pool
    # kernel's limit
    return min(max(ref_select_m(k, 1024, n), k), kk.MAX_M)


def _jax_pool(items, norms, valid, Q, k, m):
    cv, ci = knn_candidates_pallas(
        jnp.asarray(items), jnp.asarray(norms), jnp.asarray(valid), jnp.asarray(Q), k, m,
        items.shape[0], interpret=True,
    )
    cv, ci = jax.device_get((cv, ci))
    ng = -(-items.shape[0] // 1024)
    return cv.reshape(len(Q), ng, m), ci.reshape(len(Q), ng, m)


def _jax_fused(items, norms, valid, Q, k, m):
    out = knn_fused_pallas(
        jnp.asarray(items), jnp.asarray(norms), jnp.asarray(valid), jnp.asarray(Q), k, m,
        items.shape[0], interpret=True,
    )
    return jax.device_get(out)


def _port(items, norms, valid, Q, k, m):
    vals, pos = kk.knn_candidates(_t(items), _t(norms), _t(valid), _t(Q), m)
    dist, fpos, flags, thresh, above = kk.knn_fused_merge(vals, pos, k)
    return vals.numpy(), pos.numpy(), dist.numpy(), fpos.numpy(), flags.numpy(), thresh, above.numpy()


def _brute(items, Q, k):
    d2 = ((Q[:, None, :].astype(np.float64) - items[None].astype(np.float64)) ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(items.shape[0]), d2.shape), d2), axis=1)[:, :k]
    return np.sqrt(np.take_along_axis(d2, order, axis=1)), order


@pytest.mark.parametrize(
    "n,d,q,k",
    [
        (2048, 128, 256, 16),   # aligned everything
        (2100, 300, 256, 10),   # ragged N (last group) and ragged D tail
        (2560, 515, 384, 33),   # unaligned d, ragged N, q above one tile
        (1024, 64, 130, 7),     # q pads up to a tile
    ],
)
def test_pool_and_merge_match_jax_on_gaussian_data(n, d, q, k):
    rng = np.random.default_rng(n + d + k)
    items = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((q, d)).astype(np.float32)
    norms, valid, m = (items**2).sum(axis=1), np.ones(n, bool), _m(k, n)
    jv, jp = _jax_pool(items, norms, valid, Q, k, m)
    jd, jpos, jflags, _ = _jax_fused(items, norms, valid, Q, k, m)
    vals, pos, dist, fpos, flags, _, _ = _port(items, norms, valid, Q, k, m)
    assert vals.shape == jv.shape == (q, -(-n // 1024), m) and pos.dtype == np.int32
    assert (pos == jp).mean() > 0.99
    np.testing.assert_allclose(vals, jv, rtol=RTOL, atol=RTOL * np.abs(jv).max())
    assert dist.shape == (q, k) and fpos.dtype == np.int32
    np.testing.assert_allclose(dist, jd, rtol=RTOL, atol=ATOL)
    assert (fpos == jpos).all(axis=1).mean() >= 0.95
    assert not flags.any() and not jflags.any()
    want_d, want_pos = _brute(items, Q, k)
    np.testing.assert_allclose(dist, want_d, rtol=RTOL, atol=ATOL)
    assert (fpos == want_pos).all(axis=1).mean() >= 0.95


def test_lex_tie_contract_on_duplicated_integer_items():
    """Every item duplicated, integer-valued: d2 ties in pairs and both
    packages are exact, so the pools and the merged positions equal the
    JAX kernels' and the numpy lexsort oracle bit for bit, the lower
    position of each tied pair first."""
    rng = np.random.default_rng(11)
    n, d, q, k = 1024, 128, 128, 8
    base = rng.integers(-3, 4, size=(n // 2, d)).astype(np.float32)
    items = np.concatenate([base, base])
    Q = base[:q].copy()
    norms, valid, m = (items**2).sum(axis=1), np.ones(n, bool), _m(k, n)
    jv, jp = _jax_pool(items, norms, valid, Q, k, m)
    jd, jpos, jflags, _ = _jax_fused(items, norms, valid, Q, k, m)
    vals, pos, dist, fpos, flags, _, _ = _port(items, norms, valid, Q, k, m)
    np.testing.assert_array_equal(vals, jv)
    np.testing.assert_array_equal(pos, jp)
    np.testing.assert_array_equal(fpos, jpos)
    np.testing.assert_array_equal(dist, jd)
    want_d, want_pos = _brute(items, Q, k)
    np.testing.assert_array_equal(fpos, want_pos)
    np.testing.assert_allclose(dist, want_d, rtol=1e-6)
    assert not flags.any() and not jflags.any()


def test_ragged_pool_slots_match_jax_on_integer_data():
    """A last group of 52 items with m = 32 and k past the valid items:
    the -inf slots (value and position) equal the JAX pool's, and the merge
    pads past the finite candidates with inf distances."""
    rng = np.random.default_rng(3)
    n, d, q, k, m = 1076, 37, 33, 40, 32
    items = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    Q = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
    norms, valid = (items**2).sum(axis=1), np.ones(n, bool)
    valid[1040:] = False  # the last group keeps 16 valid items
    jv, jp = _jax_pool(items, norms, valid, Q, k, m)
    vals, pos, dist, fpos, _, _, _ = _port(items, norms, valid, Q, k, m)
    assert np.isneginf(vals[:, 1, 16:]).all()
    np.testing.assert_array_equal(vals, jv)
    np.testing.assert_array_equal(pos, jp)
    # k > the pool width: ranks past it read as -inf
    dist_w, pos_w, _, _, _ = kk.knn_fused_merge(_t(vals[:, 1:]), _t(pos[:, 1:]), k)
    assert np.isinf(dist_w.numpy()[:, 16:]).all() and np.isfinite(dist_w.numpy()[:, :16]).all()


def test_invalid_rows_never_enter_the_pool():
    rng = np.random.default_rng(5)
    n, d, q, k = 1536, 96, 128, 8
    items = rng.standard_normal((n, d)).astype(np.float32)
    Q = items[:q] + 1e-3  # near-duplicates force tight distances
    norms = (items**2).sum(axis=1)
    valid = np.ones(n, bool)
    valid[700:] = False
    m = _m(k, 700)
    vals, pos, dist, fpos, flags, _, _ = _port(items, norms, valid, Q, k, m)
    assert (pos[np.isfinite(vals)] < 700).all()
    assert int(fpos.max()) < 700 and np.isfinite(dist).all() and not flags.any()
    jd, jpos, _, _ = _jax_fused(items, norms, valid, Q, k, m)
    # the nearest item is ~1e-3 away: the norm expansion cancels there, so
    # that column agrees only to an absolute tolerance (JAX: 3-pass bf16)
    np.testing.assert_allclose(dist[:, 0], jd[:, 0], atol=5e-2)
    np.testing.assert_allclose(dist[:, 1:], jd[:, 1:], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(fpos[:, 0], jpos[:, 0])


def test_duplicate_distances_stay_distinct():
    rng = np.random.default_rng(9)
    n, d, k = 1024, 64, 6
    base = rng.standard_normal((n // 2, d)).astype(np.float32)
    items = np.concatenate([base, base])
    Q = base[:128].copy()
    norms, valid, m = (items**2).sum(axis=1), np.ones(n, bool), _m(k, n)
    _, _, dist, fpos, _, _, _ = _port(items, norms, valid, Q, k, m)
    # the norm expansion cancels at zero distance: the structure is exact
    assert np.allclose(dist[:, :2], 0, atol=5e-2)
    assert (fpos[:, 0] % (n // 2) == fpos[:, 1] % (n // 2)).all()
    assert (fpos[:, 0] != fpos[:, 1]).all()


def test_crafted_overflow_raises_the_flag_and_the_rerun_is_exact(monkeypatch):
    """The whole true top-k of every query packed into group 0 with m = 4:
    the flag must fire (as in the JAX kernel) and knn_search_prepared's
    exact rerun must return the brute-force neighbours."""
    rng = np.random.default_rng(17)
    n, d, q, k, m = 2048, 128, 128, 10, 4
    items = rng.standard_normal((n, d)).astype(np.float32) + 50.0
    Q = rng.standard_normal((q, d)).astype(np.float32)
    items[:k] = Q[:k].mean(axis=0) + 0.01 * rng.standard_normal((k, d)).astype(np.float32)
    Q[:] = items[:k].mean(axis=0) + 0.01 * rng.standard_normal((q, d)).astype(np.float32)
    norms, valid = (items**2).sum(axis=1), np.ones(n, bool)
    _, _, _, _, flags, _, _ = _port(items, norms, valid, Q, k, m)
    _, _, jflags, _ = _jax_fused(items, norms, valid, Q, k, m)
    assert flags.all() and jflags.all()

    prepared = port_knn.prepare_items(items, np.arange(n), shuffle=False)
    monkeypatch.setattr(port_knn, "_select_m", lambda k_, G, n_: m)
    monkeypatch.setattr(port_knn.knn_search_prepared, "flagged_rows", 0)
    monkeypatch.setattr(port_knn.knn_search_prepared, "rerun_rows", 0)
    got_d, got_i = port_knn.knn_search_prepared(prepared, Q, k, query_block=48)
    assert port_knn.knn_search_prepared.flagged_rows == q == port_knn.knn_search_prepared.rerun_rows
    want_d, want_i = _brute(items, Q, k)
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL)
    assert (got_i == want_i).all(axis=1).mean() >= 0.95


def test_count_is_exact_on_integer_data():
    """B8 against the JAX count kernel, at the thresholds of the port's own
    merge (the audit pairing): equal counts, and equal to the merged list's
    count above the threshold (no overflow)."""
    rng = np.random.default_rng(21)
    n, d, q, k = 1536, 128, 256, 9
    items = rng.integers(-3, 4, size=(n, d)).astype(np.float32)
    Q = rng.integers(-3, 4, size=(q, d)).astype(np.float32)
    norms, valid, m = (items**2).sum(axis=1), np.ones(n, bool), _m(k, n)
    vals, pos = kk.knn_candidates_audit(_t(items), _t(norms), _t(valid), _t(Q), m)
    _, _, flags, thresh, above = kk.knn_fused_merge(vals, pos, k)
    counts = kk.knn_count(_t(items), _t(norms), _t(valid), _t(Q), thresh).numpy()
    want = jax.device_get(knn_count_pallas(
        jnp.asarray(items), jnp.asarray(norms), jnp.asarray(valid), jnp.asarray(Q),
        jnp.asarray(thresh.numpy()), n, interpret=True,
    ))
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(counts, above.numpy())
    assert not flags.numpy().any()


def test_wrappers_check_their_arguments():
    rng = np.random.default_rng(1)
    items = _t(rng.standard_normal((50, 8)).astype(np.float32))
    norms, valid = (items * items).sum(1), torch.ones(50, dtype=torch.bool)
    Q = _t(rng.standard_normal((5, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="candidates per group"):
        kk.knn_candidates(items, norms, valid, Q, kk.MAX_M + 1)
    with pytest.raises(TypeError, match="float32"):
        kk.knn_candidates(items.double(), norms, valid, Q, 4)
    with pytest.raises(ValueError, match="must be"):
        kk.knn_candidates(items, norms, valid, Q[:, :4].contiguous(), 4)
    with pytest.raises(TypeError, match="bool"):
        kk.knn_candidates(items, norms, valid.int(), Q, 4)
    with pytest.raises(ValueError, match="thresh"):
        kk.knn_count(items, norms, valid, Q, torch.zeros(4))
    vals, pos = kk.knn_candidates(items, norms, valid, Q, 4)
    with pytest.raises(TypeError, match="int32"):
        kk.knn_fused_merge(vals, pos.long(), 3)
    with pytest.raises(ValueError, match="1 <= k"):
        kk.knn_fused_merge(vals, pos, 0)
