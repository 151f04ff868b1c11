# The port's ANN search on a mesh (spark_rapids_ml_tpu_torch/ann: the
# list-sharded IVF-Flat and IVF-PQ indexes, the per-shard tier pools and the
# cross-shard merge; models/approximate_nn on get_mesh(num_workers)) against
# itself on other shard counts and against the JAX package's search on its
# one-device and 8-device meshes, on the forced CPU devices of
# tests/conftest.py and the port's ["cpu"] * n meshes.  The JAX package's
# packed payload is handed to the port (the two k-means draw differently).
#
# Tolerances:
#   - the port on 1, 2 and 8 shards: bit for bit, on any data (every shard
#     scores a tile of the one-shard shape, and every selection orders by
#     the total (d2, position) key);
#   - the port against the JAX package: bit for bit on quarter-step data,
#     where every product and partial sum of a distance, a probe term and an
#     ADC table sum is exact in float32 (the refine is host numpy in both).
import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.ann.ivfflat import (
    build_ivfflat_packed as ref_build_flat,
    index_from_packed as ref_index_flat,
    ivfflat_search_prepared as ref_search_flat,
    tiered_index_from_packed as ref_tiered_flat,
)
from spark_rapids_ml_tpu.ann.pq import (
    build_ivfpq_packed as ref_build_pq,
    index_from_packed_pq as ref_index_pq,
    ivfpq_search_prepared as ref_search_pq,
    tiered_index_from_packed_pq as ref_tiered_pq,
)
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.parallel.mesh import get_mesh as ref_get_mesh

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.ann import ivfflat, pq
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import knn_kernels as kk
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh, get_mesh

CPU = torch.device("cpu")
SHARDS = (1, 2, 8)
K, NPROBE, NLIST = 10, 10, 40


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _mesh(n):
    return Mesh((CPU,) * n)


def _quarter(x):
    return (np.round(np.asarray(x) * 4) / 4).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def items():
    """The JAX tests' clustered items with non-contiguous ids, on the
    quarter-step grid."""
    rng = np.random.default_rng(0)
    centers = 20.0 * rng.normal(size=(24, 16))
    X = _quarter(centers[rng.integers(0, 24, size=2000)] + rng.normal(size=(2000, 16)))
    return X, np.arange(2000, dtype=np.int64) * 7 + 3


def _port_flat(p):
    return ivfflat.PackedIVF(p.items, p.ids, p.counts, p.centroids, p.n_lists, p.n_items)


def _port_pq(p):
    return pq.PackedPQ(p.codes, p.scalars, p.ids, p.items, p.counts, p.centroids, p.codebooks, p.n_lists,
                       p.n_items, p.dim, p.m_sub, p.n_bits, rotation=p.rotation)


@pytest.fixture(scope="module")
def payloads(items):
    """The JAX package's flat, 8-bit and 4-bit payloads, their centroids and
    codebooks on the quarter-step grid."""
    X, ids = items
    flat = ref_build_flat(X, ids, NLIST, seed=1)
    flat.centroids = _quarter(flat.centroids)
    out = {"flat": flat}
    for name, bits in (("pq8", 8), ("pq4", 4)):
        p = ref_build_pq(X, ids, NLIST, m_sub=8, n_bits=bits, seed=1)
        p.centroids, p.codebooks = _quarter(p.centroids), _quarter(p.codebooks)
        out[name] = p
    return out


def _port_search(algo, packed, mesh, Q, hot_fraction, pool_slots):
    if algo == "flat":
        p = _port_flat(packed)
        index = (ivfflat.index_from_packed(p, mesh) if hot_fraction >= 1.0
                 else ivfflat.tiered_index_from_packed(p, hot_fraction, mesh, pool_slots))
        return ivfflat.ivfflat_search_prepared(index, Q, K, NPROBE), index
    p = _port_pq(packed)
    index = (pq.index_from_packed_pq(p, mesh) if hot_fraction >= 1.0
             else pq.tiered_index_from_packed_pq(p, hot_fraction, mesh, pool_slots))
    return pq.ivfpq_search_prepared(index, Q, K, NPROBE, refine_items=packed.items, refine_ratio=4), index


def _ref_search(algo, packed, mesh, Q, hot_fraction, pool_slots):
    if algo == "flat":
        index = (ref_index_flat(packed, mesh) if hot_fraction >= 1.0
                 else ref_tiered_flat(packed, mesh, hot_fraction, pool_slots))
        return ref_search_flat(index, Q, K, NPROBE, mesh)
    index = (ref_index_pq(packed, mesh) if hot_fraction >= 1.0
             else ref_tiered_pq(packed, mesh, hot_fraction, pool_slots))
    return ref_search_pq(index, Q, K, NPROBE, mesh, refine_items=packed.items, refine_ratio=4)


@pytest.mark.parametrize("hot_fraction,pool_slots", [(1.0, None), (0.5, 10)], ids=["resident", "tiered"])
@pytest.mark.parametrize("algo", ["flat", "pq8", "pq4"])
def test_shards_equal_each_other_and_jax_bitwise(items, payloads, algo, hot_fraction, pool_slots):
    """1, 2 and 8 port shards against each other and against the JAX search
    on get_mesh(1) and get_mesh() (8 devices), resident and tiered (a pool
    of 10 slots a shard: on few shards the planner splits the queries and
    the pager evicts)."""
    X, _ = items
    Q = X[:200]
    packed = payloads[algo]
    want_d, want_i = (np.asarray(a) for a in _ref_search(algo, packed, ref_get_mesh(1), Q, hot_fraction, pool_slots))
    ref8_d, ref8_i = (np.asarray(a) for a in _ref_search(algo, packed, ref_get_mesh(), Q, hot_fraction, pool_slots))
    np.testing.assert_array_equal(ref8_i, want_i)
    for n in SHARDS:
        (got_d, got_i), index = _port_search(algo, packed, _mesh(n), Q, hot_fraction, pool_slots)
        np.testing.assert_array_equal(got_i, want_i, err_msg=f"{n} shards")
        np.testing.assert_array_equal(_bits(got_d), _bits(want_d), err_msg=f"{n} shards")
        assert index.mesh.size == n and index.nlist_pad % n == 0
        if hot_fraction < 1.0:
            stats = index.tier.stats()
            assert stats["shards"] == n and stats["misses"] > 0
            assert stats["hot_lists"] == n * -(-index.lps // 2)


@pytest.mark.parametrize("k", [10, 700])
def test_gaussian_data_and_unfillable_slots_equal_across_shards(items, k):
    """Off the quarter-step grid (a 64-probe search with k past some rows'
    candidates: unfillable slots), the shard counts still agree bit for
    bit."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1200, 12)).astype(np.float32)
    packed = _port_flat(ref_build_flat(X, np.arange(1200, dtype=np.int64), 64, seed=2))
    outs = [ivfflat.ivfflat_search_prepared(ivfflat.index_from_packed(packed, _mesh(n)), X[:64], k, 3)
            for n in SHARDS]
    assert (outs[0][1] == -1).any() == (k == 700)
    for d, i in outs[1:]:
        np.testing.assert_array_equal(i, outs[0][1])
        np.testing.assert_array_equal(_bits(d), _bits(outs[0][0]))


def test_shard_layout_and_merge_exchange_counters(items, payloads, monkeypatch):
    """The merge: one ann.probe_merge section a field a query block on N
    shards, none on one; each shard holds only its own lists and counts."""
    X, _ = items
    packed = _port_flat(payloads["flat"])
    blocks = 2
    for n in SHARDS:
        index = ivfflat.index_from_packed(packed, _mesh(n))
        assert [t.shape[0] for t in index.list_data] == [index.nlist_pad // n] * n
        assert sum(t.numel() for t in index.list_data) == index.nlist_pad * index.l_pad * index.dim
        for s in range(n):
            own = index.counts[s].numpy()
            lo, hi = s * index.lps, (s + 1) * index.lps
            assert (own[:lo] == 0).all() and (own[hi:] == 0).all()
        profiling.reset_counters("exchange.")
        monkeypatch.setattr(ivfflat, "_POOL_BYTES", 8 * NPROBE * index.l_pad * 100)
        ivfflat.ivfflat_search_prepared(index, X[:200], K, NPROBE)
        c = profiling.counters("exchange.ann.probe_merge")
        if n == 1:
            assert c == {}
        else:
            assert c["exchange.ann.probe_merge.calls"] == 2 * blocks
            assert c["exchange.ann.probe_merge.bytes"] == blocks * 100 * K * 8


def test_pool_values_read_back_the_ranked_values():
    """pool_values returns, for each selected position, the pool value the
    merge ranked (-d2), and -inf at the sentinel."""
    rng = np.random.default_rng(5)
    probes = torch.from_numpy(np.sort(np.stack([rng.choice(20, 4, replace=False) for _ in range(6)]), axis=1))
    l_pad = 8
    vals = torch.from_numpy(rng.normal(size=(6, 4, l_pad)).astype(np.float32))
    pos = (probes.to(torch.int32)[:, :, None] * l_pad + torch.arange(l_pad, dtype=torch.int32)).contiguous()
    pos[:, 1, 5:] = ivfflat._POS_SENTINEL
    vals[:, 1, 5:] = float("-inf")
    dist, fpos = kk.knn_fused_merge(vals, pos, 7)[:2]
    fpos = torch.where(torch.isinf(dist), ivfflat._POS_SENTINEL, fpos)
    got = ivfflat.pool_values(vals, probes, fpos, l_pad)
    np.testing.assert_array_equal(_bits(kk.sqrt_clamped(-got)), _bits(dist))
    top = torch.sort(vals.view(6, -1), dim=1, descending=True, stable=True)[0][:, :7]
    np.testing.assert_array_equal(_bits(got), _bits(top))


# -- the model surface on use_device(["cpu"] * 4) -------------------------------


def _knn(model, Q):
    knn = model.kneighbors(port.DataFrame.from_numpy(Q))[2]
    return knn.partitions[0]["distances"], knn.partitions[0]["indices"]


@pytest.mark.parametrize(
    "algorithm,params",
    [("ivfflat", {"nlist": 24, "nprobe": 6}), ("ivfpq", {"nlist": 24, "nprobe": 6, "M": 8, "n_bits": 4})],
)
def test_model_on_four_shards_equals_one_device(items, algorithm, params):
    """kneighbors (probed, tiered and exactSearch) and the serving entry on
    use_device(["cpu"] * 4) give the one-device results, and stage on the
    4-shard mesh."""
    X, _ = items
    Q = X[:120]
    model = port.ApproximateNearestNeighbors(k=K, algorithm=algorithm, algoParams=params).fit(
        port.DataFrame.from_numpy(X))
    one = _knn(model, Q)
    model.setExactSearch(True)
    one_exact = _knn(model, Q)
    model.setExactSearch(False)
    entry_one = model._serving_entry().call(Q[:40])
    with use_device(["cpu"] * 4):
        assert model.num_workers == 4
        four = _knn(model, Q)
        staged = (model._staged_pq if algorithm == "ivfpq" else model._staged_index)[1]
        assert staged.mesh == get_mesh(4) and staged.mesh.size == 4
        model.setExactSearch(True)
        four_exact = _knn(model, Q)
        assert model._staged_exact[0].size == 4
        model.setExactSearch(False)
        entry_four = model._serving_entry().call(Q[:40])
        model.setAlgoParams(dict(params, hot_fraction=0.5))
        tiered = _knn(model, Q)
    for got, want in ((four, one), (four_exact, one_exact), (tiered, one)):
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    np.testing.assert_array_equal(entry_four["indices"], entry_one["indices"])
    np.testing.assert_array_equal(_bits(entry_four["distances"]), _bits(entry_one["distances"]))


def test_serving_entry_on_a_slice_mesh(items):
    """_serving_entry(mesh) searches on the slice's mesh: a 2-shard slice
    stages there and answers as one device does."""
    X, _ = items
    model = port.ApproximateNearestNeighbors(k=K, algoParams={"nlist": 24, "nprobe": 6}).fit(
        port.DataFrame.from_numpy(X))
    want = _knn(model, X[:30])
    out = model._serving_entry(_mesh(2)).call(X[:30])
    assert model._staged_index[0][0] == _mesh(2)
    np.testing.assert_array_equal(out["indices"], want[1])
    np.testing.assert_array_equal(_bits(out["distances"]), _bits(want[0]))


def test_live_index_on_the_mesh_and_the_mesh_change_errors_as_jax(items):
    """mutable_index() stages on get_mesh(num_workers); a search or a
    mutable_index() on another mesh fails with the JAX package's words."""
    X, _ = items
    params = {"nlist": 16, "nprobe": 4}
    model = port.ApproximateNearestNeighbors(k=K, algoParams=params).fit(port.DataFrame.from_numpy(X))
    with use_device(["cpu"] * 4):
        holder = model.mutable_index()
        assert holder.mesh.size == 4 and holder.index.mesh.size == 4
        holder.delete_items(np.arange(10))
        d4, i4 = _knn(model, X[:50])
    port_errors = []
    with pytest.raises(ValueError) as ei:
        model.kneighbors(port.DataFrame.from_numpy(X[:5]))
    port_errors.append(str(ei.value))
    with pytest.raises(ValueError) as ei:
        model.mutable_index()
    port_errors.append(str(ei.value))

    ref_model = ref.ApproximateNearestNeighbors(k=K, algoParams=params).setFeaturesCol("features").fit(
        RefDataFrame.from_numpy(X[:400], num_partitions=1))
    ref_model.mutable_index(ref_get_mesh(4))
    ref_errors = []
    with pytest.raises(ValueError) as ei:
        ref_model._ensure_staged_index(ref_get_mesh(1))
    ref_errors.append(str(ei.value))
    with pytest.raises(ValueError) as ei:
        ref_model.mutable_index(ref_get_mesh(1))
    ref_errors.append(str(ei.value))
    assert port_errors == ref_errors
    assert not np.isin(i4, np.arange(10)).any()
    model.freeze_mutations()
    d1, i1 = _knn(model, X[:50])
    np.testing.assert_array_equal(i1, i4)
    np.testing.assert_array_equal(_bits(d1), _bits(d4))
