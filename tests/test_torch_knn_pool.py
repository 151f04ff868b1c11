# The exact-kNN candidate pool (B5/B6, ops/knn_kernels.knn_candidates and
# knn_candidates_audit) at the edges of the card kernel's geometry, against
# the JAX package's Pallas kernel in interpret mode, bit for bit.  The card
# kernel (csrc/knn_topm.cu) takes 128 queries and one 1024-item group a
# block and streams the group through 8 item tiles of 128, keeping a sorted
# list per query row; these cases put the group's end at every kind of tile
# boundary, leave groups with fewer finite candidates than m (their -inf
# slots must hold the group's first position, as the TPU kernel's
# first-occurrence argmax gives), and leave the last query tile ragged.
# Here on the CPU the wrappers take their plain PyTorch versions, which
# chip_smoke.py holds the CUDA kernel to on the card at the same kinds of
# shapes.  Small-integer data: every -d2 is exact in fp32 in any summation
# order, and ties are everywhere, so the (value descending, position
# ascending) order is tested too.
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu.ops.pallas_knn import knn_candidates_pallas
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import knn_kernels as kk


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _integer_case(seed, n, d, q):
    rng = np.random.default_rng(seed)
    items = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    Q = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
    return items, Q, (items * items).sum(axis=1)


def _jax_pool(items, norms, valid, Q, m):
    cv, ci = knn_candidates_pallas(
        jnp.asarray(items), jnp.asarray(norms), jnp.asarray(valid), jnp.asarray(Q), m, m,
        items.shape[0], interpret=True,
    )
    cv, ci = jax.device_get((cv, ci))
    ng = -(-items.shape[0] // kk.GROUP)
    return cv.reshape(len(Q), ng, m), ci.reshape(len(Q), ng, m)


def _port_pool(items, norms, valid, Q, m, audit=False):
    fn = kk.knn_candidates_audit if audit else kk.knn_candidates
    vals, pos = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (items, norms, valid, Q)), m)
    return vals.numpy(), pos.numpy()


def _assert_pool_contract(vals, pos, n):
    """Every row of every group ordered by (value desc, position asc), the
    finite positions distinct and inside the group, and every -inf slot
    (-inf, the group's first position)."""
    q, ng, m = vals.shape
    first = (np.arange(ng) * kk.GROUP)[None, :, None]
    finite = np.isfinite(vals)
    assert (pos[~finite] == np.broadcast_to(first, pos.shape)[~finite]).all()
    assert ((pos >= first) & (pos < np.minimum(first + kk.GROUP, n)))[finite].all()
    v0, v1, p0, p1 = vals[..., :-1], vals[..., 1:], pos[..., :-1], pos[..., 1:]
    both = np.isfinite(v0) & np.isfinite(v1)
    assert ((v0 > v1) | ((v0 == v1) & (p0 < p1)))[both].all()
    assert not (~np.isfinite(v0) & np.isfinite(v1)).any()  # -inf slots come last


# the last group ends 1, 127, 128, 129 and 1023 items into it: inside the
# first item tile, at its end, one past it, and one short of the group's 8
# tiles; the queries end inside their second or third tile of 128
@pytest.mark.parametrize("tail,q,m", [(1, 130, 9), (127, 200, 9), (128, 129, 5), (129, 257, 9), (1023, 131, 32)])
def test_pool_at_group_internal_tile_boundaries_matches_jax_bitwise(tail, q, m):
    n, d = 1024 + tail, 19
    items, Q, norms = _integer_case(tail, n, d, q)
    valid = np.ones(n, bool)
    jv, jp = _jax_pool(items, norms, valid, Q, m)
    vals, pos = _port_pool(items, norms, valid, Q, m)
    assert vals.shape == (q, 2, m) and pos.dtype == np.int32
    np.testing.assert_array_equal(vals.view(np.uint32), jv.view(np.uint32))
    np.testing.assert_array_equal(pos, jp)
    _assert_pool_contract(vals, pos, n)
    if tail < m:
        # the last group's one finite winner per row is its first item, and
        # its -inf slots hold that same position
        assert (pos[:, 1, :] == 1024).all() and np.isfinite(vals[:, 1, :tail]).all()


def test_groups_with_fewer_finite_items_than_m():
    """m = 32: group 0 keeps 29 valid items (3 -inf slots at position 0,
    which is also a finite winner's position in some rows), group 1 is
    full, group 2 has no valid item (every slot (-inf, 2048)) and group 3
    holds 20 items (12 -inf slots at 3072).  The audit route's wrapper
    gives the same pool."""
    n, d, q, m = 3 * 1024 + 20, 13, 140, 32
    items, Q, norms = _integer_case(7, n, d, q)
    valid = np.ones(n, bool)
    valid[5:1000] = False
    valid[2048:3072] = False
    items[0] = Q[0]  # row 0's nearest item is the first of group 0
    norms[0] = (items[0] * items[0]).sum()
    jv, jp = _jax_pool(items, norms, valid, Q, m)
    for audit in (False, True):
        vals, pos = _port_pool(items, norms, valid, Q, m, audit=audit)
        np.testing.assert_array_equal(vals.view(np.uint32), jv.view(np.uint32))
        np.testing.assert_array_equal(pos, jp)
        _assert_pool_contract(vals, pos, n)
    assert np.isfinite(vals[:, 0, :29]).all() and np.isneginf(vals[:, 0, 29:]).all()
    assert (pos[:, 0, 29:] == 0).all() and pos[0, 0, 0] == 0 and vals[0, 0, 0] == 0.0
    assert np.isfinite(vals[:, 1]).all()
    assert np.isneginf(vals[:, 2]).all() and (pos[:, 2] == 2048).all()
    assert np.isneginf(vals[:, 3, 20:]).all() and (pos[:, 3, 20:] == 3072).all()


def test_pool_keeps_the_lower_position_of_tied_items():
    """Every item four times over, 256 positions (two item tiles) apart in
    one group: each value ties four ways across tiles, and a full list must
    keep the lower positions (a later tie never displaces an entry)."""
    d, q, m = 11, 150, 9
    base, Q, _ = _integer_case(3, 256, d, q)
    items = np.concatenate([base] * 4)
    norms, valid = (items * items).sum(axis=1), np.ones(len(items), bool)
    jv, jp = _jax_pool(items, norms, valid, Q, m)
    vals, pos = _port_pool(items, norms, valid, Q, m)
    np.testing.assert_array_equal(vals, jv)
    np.testing.assert_array_equal(pos, jp)
    _assert_pool_contract(vals, pos, len(items))
    # a copy in a later tile enters only where its earlier copies did
    for row in pos[:, 0]:
        kept = set(row.tolist())
        assert all(p - 256 in kept for p in kept if p >= 256)
