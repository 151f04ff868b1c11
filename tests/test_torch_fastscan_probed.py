# B10's probed entry (spark_rapids_ml_tpu_torch/ops/pq_kernels.
# fastscan_lut_accumulate_probed) against the JAX package, on the CPU, on the
# same numpy inputs: the 4-bit packed codes of each query's probed lists read
# in place, +inf past a list's count.  Here the wrapper takes its plain
# PyTorch version (the CUDA kernel is held against it on the card by
# chip_smoke.py).
#
# Tolerance: none.  The ADC sums are sequential in float32 over exact table
# reads, so the probed entry equals the interpret-mode Pallas kernel on the
# gathered tile bit for bit on every valid row.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ann.pq import build_ivfpq_packed as ref_build_pq
from spark_rapids_ml_tpu.ops.pallas_pq import _fastscan_pallas
from spark_rapids_ml_tpu_torch.ann import ivfflat, pq
from spark_rapids_ml_tpu_torch.ann.tier import TieredListPlanes
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import knn as port_knn
from spark_rapids_ml_tpu_torch.ops import pq_kernels as pk

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _inputs(b, nprobe, n_planes, l_pad, m_sub, ksub, hi, seed):
    """Tables, a packed plane (codes in [0, hi), two a byte), slots and
    counts with an empty list, a count past the list and one below zero."""
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((b, m_sub, ksub)).astype(np.float32)
    codes = rng.integers(0, hi, size=(n_planes * l_pad, m_sub)).astype(np.uint8)
    plane = pk.pack_codes4(codes).reshape(n_planes, l_pad, m_sub // 2)
    slots = rng.integers(0, n_planes, size=(b, nprobe)).astype(np.int64)
    counts = rng.integers(0, l_pad + 1, size=(b, nprobe)).astype(np.int32)
    counts[:, 0] = 0            # an empty list
    counts[0, -1] = l_pad + 5   # a count past the list
    counts[-1, -1] = -3         # and below zero
    return T, plane, slots, counts


def _want(T, plane, slots, counts):
    """The JAX interpret-mode fast-scan kernel over the gathered tile, +inf
    on rows past each list's count and on slots outside the plane."""
    b, nprobe = slots.shape
    n_planes, l_pad, m_half = plane.shape
    inside = (slots >= 0) & (slots < n_planes)
    tile = plane[np.where(inside, slots, 0)].reshape(b, nprobe * l_pad, m_half)
    acc = np.asarray(_fastscan_pallas(jnp.asarray(T), jnp.asarray(tile), interpret=True)).reshape(b, nprobe, l_pad)
    n = np.where(inside, np.clip(counts, 0, l_pad), 0)
    return np.where(np.arange(l_pad)[None, None, :] < n[:, :, None], acc, np.float32(np.inf)).astype(np.float32)


def _probed(T, plane, slots, counts):
    return pk.fastscan_lut_accumulate_probed(torch.from_numpy(T), torch.from_numpy(plane), torch.from_numpy(slots),
                                             torch.from_numpy(counts)).numpy()


@pytest.mark.parametrize(
    "case",
    [
        (3, 5, 9, 70, 32, 16, 16),    # the 4-bit arm's m_sub and ksub
        (2, 4, 6, 33, 8, 16, 16),
        (4, 3, 5, 40, 6, 9, 16),      # nibbles past ksub add 0.0
        (1, 7, 3, 300, 64, 16, 16),   # two register-table chunks; L_pad not a multiple of 256
        (2, 3, 4, 129, 2, 1, 16),     # one subspace pair, ksub 1
    ],
    ids=str,
)
def test_fastscan_probed_equals_jax_on_the_gathered_tile(case):
    b, nprobe, n_planes, l_pad, m_sub, ksub, hi = case
    T, plane, slots, counts = _inputs(b, nprobe, n_planes, l_pad, m_sub, ksub, hi, sum(case))
    slots[0, 1] = -1            # a slot outside the plane
    slots[-1, 1] = n_planes
    got = _probed(T, plane, slots, counts)
    want = _want(T, plane, slots, counts)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.isinf(got[:, 0]).all() and np.isfinite(got).any()
    # int32 slots: the same
    np.testing.assert_array_equal(_bits(_probed(T, plane, slots.astype(np.int32), counts)), _bits(got))
    # the plain version called directly: the same
    plain = pk.fastscan_lut_accumulate_probed_plain(*(torch.from_numpy(a) for a in (T, plane, slots, counts)))
    np.testing.assert_array_equal(_bits(plain.numpy()), _bits(got))


def test_fastscan_probed_rows_equal_the_contiguous_entry():
    """Each valid row of a probed list is the contiguous entry's sum over
    that list's codes."""
    T, plane, slots, counts = _inputs(3, 4, 6, 50, 16, 16, 16, 5)
    got = _probed(T, plane, slots, counts)
    tile = torch.from_numpy(plane[slots].reshape(3, 4 * 50, 8))
    flat = pk.fastscan_lut_accumulate(torch.from_numpy(T), tile).numpy().reshape(3, 4, 50)
    valid = np.arange(50)[None, None, :] < np.clip(counts, 0, 50)[:, :, None]
    np.testing.assert_array_equal(_bits(got[valid]), _bits(flat[valid]))


def test_fastscan_probed_on_a_tiers_slot_maps_equals_the_resident_plane():
    """Through ann/tier.TieredListPlanes' pool planes and list -> slot map
    (lists paged in by acquire), every row equals the resident plane's bit
    for bit, and the JAX kernel's."""
    rng = np.random.default_rng(21)
    n_lists, l_pad, m_sub = 24, 40, 32
    host = rng.integers(0, 256, size=(n_lists, l_pad, m_sub // 2)).astype(np.uint8)
    list_counts = rng.integers(0, l_pad + 1, size=n_lists).astype(np.int32)
    list_counts[3] = 0
    tier = TieredListPlanes(planes=[host], sentinels=[None], counts=list_counts, device=CPU, hot_fraction=0.25,
                            pool_slots=10)
    T = rng.standard_normal((6, m_sub, 16)).astype(np.float32)
    probes = np.stack([np.sort(rng.choice(n_lists, 4, replace=False)) for _ in range(6)])
    counts = torch.from_numpy(list_counts)[torch.from_numpy(probes)]
    resident = pk.fastscan_lut_accumulate_probed(torch.from_numpy(T), torch.from_numpy(host),
                                                 torch.from_numpy(probes), counts)
    groups = tier.plan_groups(probes)
    for s, e in groups:
        planes, slot_map = tier.acquire(probes[s:e].ravel())
        slots = slot_map[torch.from_numpy(probes)]
        got = pk.fastscan_lut_accumulate_probed(torch.from_numpy(T), planes[0], slots, counts)
        np.testing.assert_array_equal(_bits(got[s:e]), _bits(resident[s:e]))
    assert tier.stats()["misses"] > 0
    np.testing.assert_array_equal(_bits(resident), _bits(_want(T, host, probes, counts.numpy())))


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(tables=torch.zeros(2, 4, 16, dtype=torch.float64)), TypeError),
        (dict(plane=torch.zeros(5, 9, 2, dtype=torch.int8)), TypeError),
        (dict(slots=torch.zeros(2, 3)), TypeError),
        (dict(counts=torch.zeros(2, 3, dtype=torch.int64)), TypeError),
        (dict(tables=torch.zeros(2, 4)), ValueError),
        (dict(tables=torch.zeros(2, 3, 16)), ValueError),
        (dict(tables=torch.zeros(2, 4, 17)), ValueError),
        (dict(plane=torch.zeros(5, 9, 3, dtype=torch.uint8)), ValueError),
        (dict(slots=torch.zeros(3, 3, dtype=torch.int64)), ValueError),
        (dict(counts=torch.zeros(2, 4, dtype=torch.int32)), ValueError),
        (dict(plane=torch.zeros(5, 9, 2, dtype=torch.uint8, device="meta")), ValueError),
        (dict(plane=torch.zeros(5, 2, 9, dtype=torch.uint8).transpose(1, 2)), ValueError),
    ],
    ids=["tables_f64", "plane_int8", "slots_float", "counts_int64", "tables_rank", "odd_m_sub", "ksub_over_16",
         "packed_width", "slots_batch", "counts_shape", "plane_device", "plane_not_contiguous"],
)
def test_fastscan_probed_rejects_what_the_kernel_does_not_take(change, error):
    args = dict(tables=torch.zeros(2, 4, 16), plane=torch.zeros(5, 9, 2, dtype=torch.uint8),
                slots=torch.zeros(2, 3, dtype=torch.int64), counts=torch.zeros(2, 3, dtype=torch.int32))
    args.update(change)
    with pytest.raises(error):
        pk.fastscan_lut_accumulate_probed(args["tables"], args["plane"], args["slots"], args["counts"])


@pytest.mark.parametrize(
    "t_shape,p_shape,match",
    [((1, 3, 16), (5, 9, 1), "even"), ((1, 4, 17), (5, 9, 2), "16"), ((1, 4, 16), (5, 9, 3), "bytes/item")],
    ids=["odd_m_sub", "ksub_over_16", "packed_width"],
)
def test_fastscan_probed_typed_rejections_match_the_jax_check(t_shape, p_shape, match):
    """_fastscan_check's three rejections, with the JAX package's messages."""
    from spark_rapids_ml_tpu.ops.pallas_pq import _fastscan_check as ref_check

    T, P = np.zeros(t_shape, np.float32), np.zeros(p_shape, np.uint8)
    with pytest.raises(ValueError, match=match) as ours:
        pk.fastscan_lut_accumulate_probed(torch.from_numpy(T), torch.from_numpy(P),
                                          torch.zeros((1, 2), dtype=torch.int64), torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError) as ref:
        ref_check(jnp.asarray(T), jnp.asarray(P))
    assert str(ours.value) == str(ref.value)


def test_fastscan_probed_plain_version_counts_no_launch():
    before = (pk.fastscan_lut_accumulate_probed.launches, pk.fastscan_lut_accumulate.launches)
    T, plane, slots, counts = _inputs(2, 3, 4, 9, 4, 16, 16, 0)
    _probed(T, plane, slots, counts)
    pk.fastscan_lut_accumulate(torch.from_numpy(T), torch.from_numpy(plane[:2]))
    assert (pk.fastscan_lut_accumulate_probed.launches, pk.fastscan_lut_accumulate.launches) == before


def _gather_scorer(index):
    """The 4-bit scorer before the probed entry: the probed lists' packed
    codes gathered with index_select, then fastscan_lut_accumulate over the
    tile."""

    def block(qb, _qn, d2p, _counts):
        tables = pq.adc_tables(qb, index.codebooks[0])

        def scores(planes, slots, sl):
            codes, scalars = planes
            c, p = slots.shape
            l_pad, m_bytes = codes.shape[1], codes.shape[2]
            flat = slots.reshape(-1)
            tile = codes.index_select(0, flat).view(c, p * l_pad, m_bytes)
            st = scalars.index_select(0, flat).view(c, p, l_pad)
            return d2p[sl, :, None] + (pk.fastscan_lut_accumulate(tables[sl], tile).view(c, p, l_pad) + st)

        return scores

    return block


@pytest.mark.parametrize("tiered", [False, True], ids=["resident", "tiered"])
def test_pq4_block_scorer_equals_the_gather_route(tiered):
    """probe_pool through pq_block_scorer on a 4-bit index (the probed
    fast-scan entry) gives the pool of the gather + fastscan_lut_accumulate
    route bit for bit, resident and through a tier that pages lists in."""
    rng = np.random.default_rng(4)
    X = (rng.standard_normal((900, 16)) * 3).astype(np.float32)
    ids = np.arange(900, dtype=np.int64)
    r = ref_build_pq(X, ids, 12, m_sub=4, n_bits=4, seed=1)
    packed = pq.PackedPQ(r.codes, r.scalars, r.ids, r.items, r.counts, r.centroids, r.codebooks, r.n_lists,
                         r.n_items, r.dim, r.m_sub, r.n_bits, rotation=r.rotation)
    index = (pq.tiered_index_from_packed_pq(packed, 0.25, CPU, pool_slots=4) if tiered
             else pq.index_from_packed_pq(packed, CPU))
    assert index.fastscan
    q = torch.from_numpy(X[:30])
    before = pk.fastscan_lut_accumulate_probed.launches
    got = ivfflat.probe_pool(index, q, 5, pq.pq_block_scorer(index), 7)
    assert pk.fastscan_lut_accumulate_probed.launches == before  # the plain version on the CPU
    if tiered:  # the other route pages the same lists in again
        index = pq.tiered_index_from_packed_pq(packed, 0.25, CPU, pool_slots=4)
    want = ivfflat.probe_pool(index, q, 5, _gather_scorer(index), 7)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert np.isfinite(got[0].numpy()).any() and (got[1].numpy() != port_knn.LEX_POS_SENTINEL).any()
