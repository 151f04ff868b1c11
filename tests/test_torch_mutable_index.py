# The port's live IVF-Flat index (spark_rapids_ml_tpu_torch/ann/mutable.py and
# the model's mutable_index / freeze_mutations) against the JAX package's
# MutableIVFIndex, on the CPU.  Both holders start from the JAX package's
# packed payload (its centroids handed across, as the ANN parity tests do)
# and take the same add / delete / overflow-repack / repack sequence.
#
# Tolerances:
#   - exact on quarter-step data: every distance is exact in float32, so the
#     assignments, the layouts and to_packed() (items, ids, counts), the
#     tombstone bitmaps and the geometry are equal, and search ids are equal
#     off near-ties (ties broken by the lower position on both sides; a
#     differing id must lie within 1e-5 relative plus 1e-6 of the largest
#     squared norm of the k-th distance, or of its own distance on the other
#     side);
#   - a snapshot searched again after later mutations, a tiered index
#     (hot_fraction 0.5) against the resident one, and a holder on 2 or 8
#     CPU shards (["cpu"] * n, its lists sharded over them) against the
#     one-shard holder, bit for bit; the 8-shard holder against the JAX
#     package's on its 8 forced devices as above;
#   - no deleted id is ever returned.
import threading

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu.ann.ivfflat as ref_ivf_mod
from spark_rapids_ml_tpu.ann.ivfflat import build_ivfflat_packed as ref_build_flat
from spark_rapids_ml_tpu.ann.mutable import MutableIVFIndex as RefMutableIVFIndex
from spark_rapids_ml_tpu.parallel.mesh import get_mesh

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.ann import MutableIVFIndex, ivfflat
from spark_rapids_ml_tpu_torch.convert import approximate_nearest_neighbors_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

CPU = torch.device("cpu")
RTOL = 1e-5
NORM_ATOL = 1e-6
K, NPROBE, NLIST = 10, 8, 16


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _quarter(x):
    return (np.round(np.asarray(x) * 4) / 4).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    """The JAX streaming tests' clustered items, queries, extra rows and a
    burst into one list, on the quarter-step grid."""
    rng = np.random.default_rng(17)
    n, d = 1500, 16
    centers = rng.standard_normal((8, d)) * 6
    X = _quarter(centers[rng.integers(0, 8, n)] + rng.standard_normal((n, d)))
    Q = _quarter(centers[rng.integers(0, 8, 48)] + rng.standard_normal((48, d)))
    extra = _quarter(centers[rng.integers(0, 8, 300)] + rng.standard_normal((300, d)))
    burst = _quarter(centers[0] + 0.5 * rng.standard_normal((1100, d)))
    return X, Q, extra, burst


@pytest.fixture(scope="module")
def ref_packed(data):
    X = data[0]
    real = ref_ivf_mod.train_coarse_quantizer
    ref_ivf_mod.train_coarse_quantizer = lambda *a, **k: _quarter(real(*a, **k))
    try:
        return ref_build_flat(X, np.arange(len(X), dtype=np.int64), NLIST, seed=0)
    finally:
        ref_ivf_mod.train_coarse_quantizer = real


def _port_packed(p):
    return ivfflat.PackedIVF(p.items.copy(), p.ids.copy(), p.counts.copy(), p.centroids.copy(), p.n_lists, p.n_items)


def _holders(ref_packed, hot_fraction=1.0):
    return (
        MutableIVFIndex(_port_packed(ref_packed), CPU, hot_fraction=hot_fraction),
        RefMutableIVFIndex(ref_packed, get_mesh(1), hot_fraction=hot_fraction),
    )


def _exact_ids(items, ids, Q, k=K):
    d2 = ((Q[:, None, :].astype(np.float64) - items[None].astype(np.float64)) ** 2).sum(-1)
    return np.asarray(ids)[np.argsort(d2, axis=1, kind="stable")[:, :k]]


def _assert_same_up_to_ties(got_d, got_i, want_d, want_i, scale):
    assert got_i.shape == want_i.shape and got_i.dtype == np.int64 and got_d.dtype == np.float32
    g2, w2 = np.asarray(got_d, np.float64) ** 2, np.asarray(want_d, np.float64) ** 2
    tol = RTOL * w2 + NORM_ATOL * scale
    fin = np.isfinite(w2)
    assert (np.isfinite(g2) == fin).all()
    assert (np.abs(g2 - w2)[fin] <= tol[fin]).all()
    kth = w2[:, -1:]
    for r, c in zip(*np.nonzero(got_i != want_i)):
        at = np.flatnonzero(want_i[r] == got_i[r, c])
        near_kth = abs(w2[r, c] - kth[r, 0]) <= 2 * tol[r, c]
        near_other = at.size and abs(w2[r, at[0]] - w2[r, c]) <= 2 * tol[r, c]
        assert near_kth or near_other, (r, c, got_i[r], want_i[r])


def _assert_holders_equal(h, r, Q, deleted, scale):
    got, want = h.to_packed(), r.to_packed()
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.items, want.items)
    np.testing.assert_array_equal(got.centroids, want.centroids)
    assert got.n_items == want.n_items == h.n_items
    np.testing.assert_array_equal(h.tombstone_bitmap(), r.tombstone_bitmap())
    hs, rs = h.stats(), r.stats()
    for key in ("n_items", "tombstoned", "n_lists", "l_pad", "repacks"):
        assert hs[key] == rs[key], key
    d, i = h.search(Q, K, NPROBE)
    rd, ri = r.search(Q, K, NPROBE)
    _assert_same_up_to_ties(d, i, np.asarray(rd), np.asarray(ri), scale)
    assert not np.isin(i, deleted).any()
    return d, i


@pytest.mark.parametrize("hot_fraction", [1.0, 0.5], ids=["resident", "tiered"])
def test_mutation_sequence_equals_jax(data, ref_packed, hot_fraction):
    X, Q, extra, burst = data
    n = len(X)
    scale = float((X.astype(np.float64) ** 2).sum(1).max())
    h, r = _holders(ref_packed, hot_fraction)
    deleted = np.zeros(0, np.int64)
    _assert_holders_equal(h, r, Q, deleted, scale)
    for holder in (h, r):  # add
        holder.add_items(extra, np.arange(n, n + len(extra)))
    _, ids = _assert_holders_equal(h, r, Q, deleted, scale)
    assert np.isin(ids, np.arange(n, n + len(extra))).any()
    deleted = np.arange(0, 300)
    for holder in (h, r):  # delete, twice: idempotent
        assert holder.delete_items(deleted) == 300
        assert holder.delete_items(deleted) == 0
    _assert_holders_equal(h, r, Q, deleted, scale)
    l_pad0 = h.stats()["l_pad"]
    for holder in (h, r):  # a burst into one list overflows L_pad: repack
        holder.add_items(burst, np.arange(50_000, 50_000 + len(burst)))
    assert h.stats()["l_pad"] > l_pad0 and h.stats()["repacks"] == 1 and h.stats()["tombstoned"] == 0
    _assert_holders_equal(h, r, Q, deleted, scale)
    more = np.arange(50_000, 50_100)
    for holder in (h, r):  # deletes after the repack, then a repack
        holder.delete_items(more)
        holder.repack()
    deleted = np.concatenate([deleted, more])
    _, ids = _assert_holders_equal(h, r, Q, deleted, scale)
    items = np.concatenate([X, extra, burst])
    all_ids = np.concatenate([np.arange(n + len(extra)), np.arange(50_000, 50_000 + len(burst))])
    keep = ~np.isin(all_ids, deleted)
    assert ivfflat.recall_at_k(ids, _exact_ids(items[keep], all_ids[keep], Q)) >= 0.95


@pytest.mark.parametrize("hot_fraction", [1.0, 0.5], ids=["resident", "tiered"])
def test_sharded_holders_equal_one_shard_and_jax(data, ref_packed, hot_fraction):
    """The add / delete / overflow / repack script on holders of 1, 2 and 8
    CPU shards and on the JAX package's holder over its 8 devices:
    to_packed() and the searches equal (bit for bit across the port's shard
    counts), deleted ids absent."""
    X, Q, extra, burst = data
    n = len(X)
    scale = float((X.astype(np.float64) ** 2).sum(1).max())
    holders = [MutableIVFIndex(_port_packed(ref_packed), Mesh((CPU,) * s), hot_fraction=hot_fraction)
               for s in (1, 2, 8)]
    r = RefMutableIVFIndex(ref_packed, get_mesh(), hot_fraction=hot_fraction)
    assert [h.index.mesh.size for h in holders] == [1, 2, 8]
    steps = (
        lambda h: h.add_items(extra, np.arange(n, n + len(extra))),
        lambda h: h.delete_items(np.arange(0, 300)),
        lambda h: h.add_items(burst, np.arange(50_000, 50_000 + len(burst))),
        lambda h: h.delete_items(np.arange(50_000, 50_100)),
        lambda h: h.repack(),
    )
    deleted = np.zeros(0, np.int64)
    for j, step in enumerate(steps):
        for h in holders + [r]:
            step(h)
        if j in (1, 3):
            deleted = np.concatenate([deleted, np.arange(0, 300) if j == 1 else np.arange(50_000, 50_100)])
        d1, i1 = _assert_holders_equal(holders[-1], r, Q, deleted, scale)
        for h in holders[:-1]:
            d, i = h.search(Q, K, NPROBE)
            np.testing.assert_array_equal(i, i1)
            np.testing.assert_array_equal(d.view(np.uint32), d1.view(np.uint32))
            packed, want = h.to_packed(), holders[-1].to_packed()
            np.testing.assert_array_equal(packed.ids, want.ids)
            np.testing.assert_array_equal(packed.items, want.items)
    assert holders[-1].stats()["repacks"] == 2


@pytest.mark.parametrize("hot_fraction", [0.5, 0.25])
def test_tiered_equals_resident(data, ref_packed, hot_fraction):
    X, Q, extra, burst = data
    n = len(X)
    res, tier = (MutableIVFIndex(_port_packed(ref_packed), CPU, hot_fraction=hf, pool_slots=8)
                 for hf in (1.0, hot_fraction))
    steps = (
        lambda h: h.add_items(extra, np.arange(n, n + len(extra))),
        lambda h: h.delete_items(np.arange(0, 400, 2)),
        lambda h: h.add_items(burst, np.arange(50_000, 50_000 + len(burst))),
        lambda h: h.delete_items(np.arange(50_000, 50_050)),
        lambda h: h.repack(),
    )
    for step in steps:
        for h in (res, tier):
            step(h)
        d0, i0 = res.search(Q, K, NPROBE)
        d1, i1 = tier.search(Q, K, NPROBE)
        np.testing.assert_array_equal(i1, i0)
        np.testing.assert_array_equal(d1.view(np.uint32), d0.view(np.uint32))
    stats = tier.index.tier.stats()
    assert stats["misses"] > 0 and (hot_fraction == 0.5 or stats["evictions"] > 0)


def test_snapshot_isolated_from_later_mutations(data, ref_packed):
    """A snapshot searched after later adds and deletes gives its own
    results bit for bit: the adds' in-place writes sit past its counts, the
    deletes build a new norm plane, and its id table is its own."""
    X, Q, extra, _ = data
    h = MutableIVFIndex(_port_packed(ref_packed), CPU)
    snap = h.index
    d0, i0 = ivfflat.ivfflat_search_prepared(snap, Q, K, NPROBE)
    victim = int(i0[0, 0])
    pos = h._pos_of_id[victim]
    h.add_items(extra, np.arange(10_000, 10_000 + len(extra)))
    h.delete_items(i0[:, 0])
    assert snap.ids[pos] == victim and h.index.ids[pos] == -1
    assert not np.isin(np.arange(10_000, 10_300), snap.ids).any()
    d1, i1 = ivfflat.ivfflat_search_prepared(snap, Q, K, NPROBE)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1.view(np.uint32), d0.view(np.uint32))
    _, i2 = h.search(Q, K, NPROBE)
    assert not np.isin(i2, i0[:, 0]).any()
    assert snap.list_data is h.index.list_data  # the add wrote in place
    assert snap.list_norm is not h.index.list_norm and snap.counts is not h.index.counts


@pytest.mark.parametrize("order", ["add_then_delete", "delete_then_add"])
def test_reader_thread_sees_whole_snapshots(data, ref_packed, order):
    """A reader thread searches snapshot after snapshot while the main
    thread mutates: each result equals a later search of the same snapshot,
    so no search saw a half-applied mutation."""
    X, Q, extra, _ = data
    h = MutableIVFIndex(_port_packed(ref_packed), CPU)
    seen = []
    stop = threading.Event()

    def reader():
        while not stop.is_set() or len(seen) < 3:
            snap = h.index
            seen.append((snap, ivfflat.ivfflat_search_prepared(snap, Q, K, NPROBE)))

    t = threading.Thread(target=reader, name="mutable-index-reader")
    t.start()
    try:
        for j in range(6):
            adds = (extra[j * 50 : (j + 1) * 50], np.arange(20_000 + j * 50, 20_000 + (j + 1) * 50))
            dels = np.arange(j * 40, (j + 1) * 40)
            if order == "add_then_delete":
                h.add_items(*adds)
                h.delete_items(dels)
            else:
                h.delete_items(dels)
                h.add_items(*adds)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and len(seen) >= 3
    for snap, (d, i) in seen:
        d2, i2 = ivfflat.ivfflat_search_prepared(snap, Q, K, NPROBE)
        np.testing.assert_array_equal(i2, i)
        np.testing.assert_array_equal(d2.view(np.uint32), d.view(np.uint32))
    _, i_last = h.search(Q, K, NPROBE)
    assert not np.isin(i_last, np.arange(0, 240)).any()


def test_search_never_blocks_on_mutator_lock(data, ref_packed):
    _, Q, _, _ = data
    h = MutableIVFIndex(_port_packed(ref_packed), CPU)
    done = threading.Event()
    out = {}

    def probe():
        out["ids"] = h.search(Q, K, NPROBE)[1]
        done.set()

    with h._lock:  # a mutation in flight holds the lock
        t = threading.Thread(target=probe, name="mutable-index-probe")
        t.start()
        finished = done.wait(timeout=30)
    t.join(timeout=30)
    assert finished, "search blocked behind the mutator lock"
    assert out["ids"].shape == (len(Q), K)


def test_validation_errors(data, ref_packed):
    _, _, extra, _ = data
    h = MutableIVFIndex(_port_packed(ref_packed), CPU)
    with pytest.raises(ValueError, match="duplicate ids"):
        h.add_items(extra[:2], np.array([99_000, 99_000]))
    with pytest.raises(ValueError, match="already present"):
        h.add_items(extra[:1], np.array([0]))
    with pytest.raises(ValueError, match="items must be"):
        h.add_items(extra[:, :4], np.array([99_001, 99_002]))
    with pytest.raises(ValueError, match="items vs"):
        h.add_items(extra[:3], np.array([99_003]))
    h.add_items(extra[:0], np.zeros(0, np.int64))
    assert h.delete_items(np.array([123_456])) == 0
    assert h.stats()["n_items"] == ref_packed.n_items and h.stats()["repacks"] == 0


def test_counters_and_b1_blocks(data, ref_packed):
    X, _, extra, _ = data
    h = MutableIVFIndex(_port_packed(ref_packed), CPU)
    profiling.reset_counters("ann.mutate.")
    h.add_items(extra, np.arange(5_000, 5_300))
    h.delete_items(np.arange(10))
    h.repack()
    c = profiling.counters("ann.mutate.")
    assert c["ann.mutate.adds"] == 300 and c["ann.mutate.deletes"] == 10 and c["ann.mutate.repacks"] == 1
    assert c["ann.mutate.assign_blocks"] == 1
    # the add restaged its rows (ids, rows, norms) and the counts; the
    # delete its positions; the repack the whole planes
    planes = sum(t.nbytes for t in h.index.list_data + h.index.list_norm)
    assert c["ann.mutate.bytes"] == 300 * (8 + 4 * X.shape[1] + 4) + 4 * h._nlist_pad + 10 * 8 + planes
    h.register_warm(K, NPROBE, 48)
    assert (K, NPROBE, 48) in h._warm_specs


def _fit_model(X, algorithm="ivfflat", **params):
    return port.ApproximateNearestNeighbors(
        k=K, algorithm=algorithm, algoParams={"nlist": NLIST, "nprobe": NPROBE, **params}
    ).fit(port.DataFrame.from_numpy(X))


def _knn(model, Q):
    _, _, knn = model.kneighbors(port.DataFrame.from_numpy(Q))
    return knn.partitions[0]["distances"], knn.partitions[0]["indices"]


def test_model_exact_search_rejected_while_mutable_and_pq_rejected(data):
    X, Q, extra, _ = data
    model = _fit_model(X)
    holder = model.mutable_index()
    assert model.mutable_index() is holder
    holder.add_items(extra[:10], np.arange(90_000, 90_010))
    model.setExactSearch(True)
    with pytest.raises(ValueError, match="freeze"):
        model.kneighbors(port.DataFrame.from_numpy(Q[:4]))
    model.freeze_mutations()
    assert model.freeze_mutations() is model  # no holder: a no-op
    assert _knn(model, Q[:4])[1].shape == (4, K)
    assert 90_005 in model.packed_ids_
    pq_model = _fit_model(X, algorithm="ivfpq", M=2, n_bits=4)
    with pytest.raises(ValueError, match="IVF-Flat-only"):
        pq_model.mutable_index()


def test_model_kneighbors_reads_the_live_index(data):
    X, Q, extra, _ = data
    model = _fit_model(X)
    holder = model.mutable_index()
    _, before = _knn(model, Q)
    holder.delete_items(before[:, 0])
    holder.add_items(extra, np.arange(70_000, 70_300))
    d, ids = _knn(model, Q)
    hd, hids = holder.search(Q, K, NPROBE)
    np.testing.assert_array_equal(ids, hids)
    np.testing.assert_array_equal(d, hd)
    assert not np.isin(ids, before[:, 0]).any()


def test_freeze_save_load_gives_identical_results(data, tmp_path):
    X, Q, extra, _ = data
    n = len(X)
    model = _fit_model(X)
    holder = model.mutable_index()
    holder.add_items(extra, np.arange(n, n + len(extra)))
    holder.delete_items(np.arange(0, 100))
    _, live_ids = holder.search(Q, K, NPROBE)
    model.freeze_mutations()
    assert model.n_items == n + len(extra) - 100
    frozen_d, frozen_i = _knn(model, Q)
    model.save(str(tmp_path / "mutated"))
    loaded = port.load(str(tmp_path / "mutated"))
    loaded_d, loaded_i = _knn(loaded, Q)
    np.testing.assert_array_equal(loaded_i, frozen_i)
    np.testing.assert_array_equal(loaded_d, frozen_d)
    assert not np.isin(loaded_i, np.arange(0, 100)).any()
    overlap = [np.intersect1d(a, b).size / a.shape[0] for a, b in zip(loaded_i, live_ids)]
    assert float(np.mean(overlap)) >= 0.95


def test_jax_payload_mutates_in_the_port(data, ref_packed):
    """A JAX-fitted model's payload (convert) takes the live mutations."""
    X, Q, extra, _ = data
    p = ref_packed
    model = approximate_nearest_neighbors_model_from_reference(
        dict(centroids_=p.centroids, packed_items_=p.items, packed_ids_=p.ids, list_counts_=p.counts,
             n_lists=p.n_lists, n_items=p.n_items, n_cols=X.shape[1], dtype="float32"),
        dict(k=K, algoParams={"nlist": NLIST, "nprobe": NPROBE}),
    )
    model.mutable_index().add_items(extra, np.arange(40_000, 40_300))
    ids = _knn(model, Q)[1]
    assert np.isin(ids, np.arange(40_000, 40_300)).any()


def test_mutable_index_raises_without_cuda(monkeypatch, data):
    X = data[0]
    model = _fit_model(X)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with use_device(None):
        with pytest.raises(RuntimeError, match="use_device"):
            model.mutable_index()
