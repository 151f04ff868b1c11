# B7's route and tie contract, and B9's probed entry (spark_rapids_ml_tpu_torch/
# ops/knn_kernels.knn_fused_merge, ops/pq_kernels.lut_accumulate_probed)
# against the JAX package, on the CPU, on the same numpy inputs.  Here the
# wrappers take their plain PyTorch versions (the CUDA kernels are held
# against those on the card by chip_smoke.py).
#
# Tolerance: none.  The merge orders by (value, slot) and the pools' values
# are small integers (exact in float32), so it equals the JAX package's
# lex_topk bit for bit; the ADC sums are sequential in float32 over exact
# table reads, so the probed entry equals the interpret-mode Pallas kernel
# bit for bit on every valid row.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ann.pq import build_ivfpq_packed as ref_build_pq
from spark_rapids_ml_tpu.ops.knn import lex_topk as ref_lex_topk
from spark_rapids_ml_tpu.ops.pallas_pq import _lut_accumulate_pallas
from spark_rapids_ml_tpu_torch.ann import ivfflat, pq
from spark_rapids_ml_tpu_torch.ann.tier import TieredListPlanes
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import knn as port_knn
from spark_rapids_ml_tpu_torch.ops import knn_kernels as kk
from spark_rapids_ml_tpu_torch.ops import pq_kernels as pk

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# B7: the route by shape, and the merge's tie contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "p,k,route",
    [
        (3519, 200, (1, 256)),                    # the exact-kNN flagship pool
        (5880, 200, (1, 256)),                    # the mesh's stacked pools
        (1, 1, (1, 256)),                         # one slot
        (kk.SLICE_KEYS, 200, (1, 256)),           # one CTA's slice, full
        (kk.SLICE_KEYS + 1, 200, (2, 512)),       # two CTAs a row
        (50_000, 200, (4, 512)),
        (158 * 2048, 200, (16, 512)),             # the ANN arms' pools
        (158 * 2048, 1600, (16, 512)),
        (158 * 2048, kk.RADIX_MAX_K, (16, 512)),
        (20_000, 9000, (0, 256)),                 # k past the radix kernel's sort
        (16 * kk.SLICE_KEYS + 1, 200, (0, 256)),  # a row past sixteen slices
    ],
    ids=lambda x: str(x),
)
def test_merge_route_by_shape_class(p, k, route):
    assert kk._merge_route(p, k) == route


def test_merge_route_is_monotone_in_width():
    """Wider rows never take fewer CTAs, and every radix route's slices
    hold at most SLICE_KEYS values."""
    last = 1
    for p in range(1, 16 * kk.SLICE_KEYS + 1, 4099):
        cluster, threads = kk._merge_route(p, 200)
        assert cluster >= last and -(-p // cluster) <= kk.SLICE_KEYS
        assert threads == (256 if cluster == 1 else kk.CLUSTER_THREADS)
        last = cluster


def _tied_pool(q, ng, m, lo, neg_share, seed):
    """A pool of small integer values (many slots tie at the k-th), some
    slots -inf, one row all -inf, positions rising with the slot."""
    rng = np.random.default_rng(seed)
    v = -rng.integers(lo, lo + 6, size=(q, ng, m)).astype(np.float32)
    v[rng.random((q, ng, m)) < neg_share] = -np.inf
    v[-1] = -np.inf
    p = (np.arange(ng * m, dtype=np.int32) * 3 + 5)[None, :].repeat(q, 0).reshape(q, ng, m)
    return v, p


@pytest.mark.parametrize(
    "shape,k,neg_share",
    [
        ((6, 40, 5), 37, 0.3),     # the k-th value tied across many slots
        ((5, 64, 8), 200, 0.7),    # the ANN pools' share of -inf slots
        ((4, 12, 5), 59, 0.5),     # k one short of the pool
        ((4, 12, 5), 75, 0.5),     # k past the pool
    ],
    ids=str,
)
def test_merge_on_tied_pools_equals_jax_lex_topk(shape, k, neg_share):
    """The merge (its plain version here) is the JAX package's lex_topk on
    the pool, bit for bit: distances, positions, ties to the lower slot,
    -inf slots last; ranks past the pool read -inf (inf distance) with
    position 0, and the threshold and the count above it follow the k-th."""
    q, ng, m = shape
    v, p = _tied_pool(q, ng, m, 1, neg_share, k)
    dist, pos, flags, thresh, above = kk.knn_fused_merge(torch.from_numpy(v), torch.from_numpy(p), k)
    width = ng * m
    kk_ = min(k, width)
    ref = ref_lex_topk(jnp.asarray(-v.reshape(q, width)), jnp.asarray(p.reshape(q, width)), kk_)
    rd, rp = np.array(ref[0]), np.array(ref[1])
    np.testing.assert_array_equal(_bits(dist[:, :kk_]), _bits(kk.sqrt_clamped(torch.from_numpy(rd))))
    np.testing.assert_array_equal(pos[:, :kk_].numpy(), np.asarray(rp))
    assert np.isinf(dist[:, kk_:].numpy()).all() and (pos[:, kk_:].numpy() == 0).all()
    # the k-th value and the margined threshold, as the kernel defines them
    kth = np.where(k <= width, -rd[:, -1], -np.inf).astype(np.float32)
    finite = np.where(np.isfinite(kth), kth, np.float32(0))
    want_t = np.where(np.isfinite(kth), finite + (np.abs(finite) * np.float32(1e-6) + np.float32(1e-30)), kth)
    np.testing.assert_array_equal(_bits(thresh), _bits(want_t))
    kept = -rd
    np.testing.assert_array_equal(above.numpy(), (kept > want_t[:, None]).sum(1))
    np.testing.assert_array_equal(flags.numpy(), (v[:, :, m - 1] > want_t[:, None]).any(1).astype(np.int32))
    assert not np.isfinite(dist[-1].numpy()).any()  # the all -inf row


def test_merge_counts_no_launch_on_the_cpu():
    before = kk.knn_fused_merge.launches
    v, p = _tied_pool(3, 10, 4, 1, 0.2, 0)
    kk.knn_fused_merge(torch.from_numpy(v), torch.from_numpy(p), 7)
    assert kk.knn_fused_merge.launches == before


# ---------------------------------------------------------------------------
# B9: the probed entry
# ---------------------------------------------------------------------------


def _probed_inputs(b, nprobe, n_planes, l_pad, m_sub, ksub, hi, seed):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((b, m_sub, ksub)).astype(np.float32)
    plane = rng.integers(0, hi, size=(n_planes, l_pad, m_sub)).astype(np.uint8)
    slots = rng.integers(0, n_planes, size=(b, nprobe)).astype(np.int64)
    counts = rng.integers(0, l_pad + 1, size=(b, nprobe)).astype(np.int32)
    counts[:, 0] = 0            # an empty list
    counts[0, -1] = l_pad + 5   # a count past the list
    counts[-1, -1] = -3         # and below zero
    return T, plane, slots, counts


def _want(T, plane, slots, counts):
    """The JAX interpret-mode kernel over the gathered tile, +inf on rows
    past each list's count and on slots outside the plane."""
    b, nprobe = slots.shape
    n_planes, l_pad, m_sub = plane.shape
    inside = (slots >= 0) & (slots < n_planes)
    tile = plane[np.where(inside, slots, 0)].reshape(b, nprobe * l_pad, m_sub)
    acc = np.asarray(_lut_accumulate_pallas(jnp.asarray(T), jnp.asarray(tile), interpret=True))
    acc = acc.reshape(b, nprobe, l_pad)
    n = np.where(inside, np.clip(counts, 0, l_pad), 0)
    return np.where(np.arange(l_pad)[None, None, :] < n[:, :, None], acc, np.float32(np.inf)).astype(np.float32)


@pytest.mark.parametrize(
    "case",
    [
        (3, 5, 9, 70, 32, 256, 256),   # the ANN arms' m_sub and ksub
        (2, 4, 6, 33, 8, 16, 16),
        (4, 3, 5, 40, 6, 200, 256),    # codes past ksub add 0.0
        (1, 7, 3, 17, 48, 256, 256),   # a 48-KB table
    ],
    ids=str,
)
def test_probed_equals_jax_on_the_gathered_tile(case):
    b, nprobe, n_planes, l_pad, m_sub, ksub, hi = case
    T, plane, slots, counts = _probed_inputs(b, nprobe, n_planes, l_pad, m_sub, ksub, hi, sum(case))
    slots[0, 1] = -1            # a slot outside the plane
    slots[-1, 1] = n_planes
    got = pk.lut_accumulate_probed(torch.from_numpy(T), torch.from_numpy(plane), torch.from_numpy(slots),
                                   torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_want(T, plane, slots, counts)))
    # int32 slots: the same
    got32 = pk.lut_accumulate_probed(torch.from_numpy(T), torch.from_numpy(plane),
                                     torch.from_numpy(slots.astype(np.int32)), torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(_bits(got32), _bits(got))


def test_probed_on_a_tiers_slot_maps_equals_the_resident_plane():
    """Through ann/tier.TieredListPlanes' pool planes and list -> slot map
    (lists paged in by acquire), every valid row equals the resident
    plane's bit for bit, and the JAX kernel's."""
    rng = np.random.default_rng(12)
    n_lists, l_pad, m_sub = 24, 40, 16
    host = rng.integers(0, 256, size=(n_lists, l_pad, m_sub)).astype(np.uint8)
    list_counts = rng.integers(0, l_pad + 1, size=n_lists).astype(np.int32)
    list_counts[3] = 0
    tier = TieredListPlanes(planes=[host], sentinels=[None], counts=list_counts, device=CPU, hot_fraction=0.25,
                            pool_slots=10)
    T = rng.standard_normal((6, m_sub, 256)).astype(np.float32)
    probes = np.stack([np.sort(rng.choice(n_lists, 4, replace=False)) for _ in range(6)])
    counts = torch.from_numpy(list_counts)[torch.from_numpy(probes)]
    resident = pk.lut_accumulate_probed(torch.from_numpy(T), torch.from_numpy(host), torch.from_numpy(probes), counts)
    groups = tier.plan_groups(probes)
    for s, e in groups:
        planes, slot_map = tier.acquire(probes[s:e].ravel())
        slots = slot_map[torch.from_numpy(probes)]
        got = pk.lut_accumulate_probed(torch.from_numpy(T), planes[0], slots, counts)
        np.testing.assert_array_equal(_bits(got[s:e]), _bits(resident[s:e]))
    assert tier.stats()["misses"] > 0
    np.testing.assert_array_equal(_bits(resident), _bits(_want(T, host, probes, counts.numpy())))


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(tables=torch.zeros(2, 4, 16, dtype=torch.float64)), TypeError),
        (dict(plane=torch.zeros(5, 9, 4, dtype=torch.int8)), TypeError),
        (dict(slots=torch.zeros(2, 3)), TypeError),
        (dict(counts=torch.zeros(2, 3, dtype=torch.int64)), TypeError),
        (dict(plane=torch.zeros(5, 9, 5, dtype=torch.uint8)), ValueError),
        (dict(slots=torch.zeros(3, 3, dtype=torch.int64)), ValueError),
        (dict(counts=torch.zeros(2, 4, dtype=torch.int32)), ValueError),
        (dict(tables=torch.zeros(2, 4, 300)), ValueError),
        (dict(plane=torch.zeros(5, 9, 4, dtype=torch.uint8, device="meta")), ValueError),
        (dict(plane=torch.zeros(5, 4, 9, dtype=torch.uint8).transpose(1, 2)), ValueError),
    ],
    ids=["tables_f64", "plane_int8", "slots_float", "counts_int64", "plane_width", "slots_batch", "counts_shape",
         "ksub_over_256", "plane_device", "plane_not_contiguous"],
)
def test_probed_rejects_what_the_kernel_does_not_take(change, error):
    args = dict(tables=torch.zeros(2, 4, 16), plane=torch.zeros(5, 9, 4, dtype=torch.uint8),
                slots=torch.zeros(2, 3, dtype=torch.int64), counts=torch.zeros(2, 3, dtype=torch.int32))
    args.update(change)
    with pytest.raises(error):
        pk.lut_accumulate_probed(args["tables"], args["plane"], args["slots"], args["counts"])


def test_probed_plain_version_counts_no_launch():
    before = pk.lut_accumulate_probed.launches
    T, plane, slots, counts = _probed_inputs(2, 3, 4, 9, 4, 16, 16, 0)
    pk.lut_accumulate_probed(*(torch.from_numpy(a) for a in (T, plane, slots, counts)))
    assert pk.lut_accumulate_probed.launches == before


def _gather_scorer(index):
    """The 8-bit scorer before the probed entry: the probed lists' codes
    gathered with index_select, then lut_accumulate over the tile."""

    def block(qb, _qn, d2p, _counts):
        tables = pq.adc_tables(qb, index.codebooks[0])

        def scores(planes, slots, sl):
            codes, scalars = planes
            c, p = slots.shape
            l_pad, m_bytes = codes.shape[1], codes.shape[2]
            flat = slots.reshape(-1)
            tile = codes.index_select(0, flat).view(c, p * l_pad, m_bytes)
            st = scalars.index_select(0, flat).view(c, p, l_pad)
            return d2p[sl, :, None] + (pk.lut_accumulate(tables[sl], tile).view(c, p, l_pad) + st)

        return scores

    return block


@pytest.mark.parametrize("tiered", [False, True], ids=["resident", "tiered"])
def test_pq_block_scorer_equals_the_gather_route(tiered):
    """probe_pool through pq_block_scorer (the probed entry) gives the pool
    of the gather + lut_accumulate route bit for bit, resident and through
    a tier that pages lists in."""
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((900, 16)) * 3).astype(np.float32)
    ids = np.arange(900, dtype=np.int64)
    r = ref_build_pq(X, ids, 12, m_sub=4, n_bits=8, seed=1)
    packed = pq.PackedPQ(r.codes, r.scalars, r.ids, r.items, r.counts, r.centroids, r.codebooks, r.n_lists,
                         r.n_items, r.dim, r.m_sub, r.n_bits, rotation=r.rotation)
    index = (pq.tiered_index_from_packed_pq(packed, 0.25, CPU, pool_slots=4) if tiered
             else pq.index_from_packed_pq(packed, CPU))
    assert not index.fastscan
    q = torch.from_numpy(X[:30])
    got = ivfflat.probe_pool(index, q, 5, pq.pq_block_scorer(index), 7)
    if tiered:  # the other route pages the same lists in again
        index = pq.tiered_index_from_packed_pq(packed, 0.25, CPU, pool_slots=4)
    want = ivfflat.probe_pool(index, q, 5, _gather_scorer(index), 7)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert np.isfinite(got[0].numpy()).any() and (got[1].numpy() != port_knn.LEX_POS_SENTINEL).any()
