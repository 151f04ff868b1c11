# The port's exact kNN on a mesh (spark_rapids_ml_tpu_torch/ops/knn.py over
# parallel/: row-sharded items, the kernel route per shard, the ring and
# gather exchange routes) against the JAX package's on the same inputs, on
# the CPU: 8 shards of ["cpu"] * 8 against the JAX package's 8 forced CPU
# devices (conftest), with the kernels' plain versions.
#
# Tolerances: on quarter-step data (every sum exact in float32) the routes,
# the shard counts and the two packages agree bit for bit; on Gaussian data
# the port's routes and shard counts still agree bit for bit among
# themselves (the fixed-tile contract of the exchange), and the port agrees
# with the JAX package within rtol 1e-5 in distance, positions equal off
# near-ties (1e-5 relative in float64).
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops import knn as ref_knn
from spark_rapids_ml_tpu.parallel.mesh import DATA_AXIS

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.convert import nearest_neighbors_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import knn as port_knn
from spark_rapids_ml_tpu_torch.parallel import topology
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

N_DEV = 8
DIST_RTOL = 1e-5
TIE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu_mesh():
    with use_device(["cpu"] * N_DEV):
        yield


def _jax_mesh(n_dev):
    return JaxMesh(np.array(jax.devices()[:n_dev]), (DATA_AXIS,))


_CPU = torch.device("cpu")


def _port_mesh(n_dev):
    return Mesh((_CPU,) * n_dev)


def _data(n, d, q, kind, seed=0):
    rng = np.random.default_rng(seed)
    items = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    if kind == "quarter":  # every product and partial sum exact in float32
        items = np.round(items * 4) / 4
        queries = np.round(queries * 4) / 4
    return items, queries


def _assert_positions_off_near_ties(items, queries, got, want):
    """Positions equal except where the two items lie within TIE_RTOL of each
    other in float64 distance to the query (items unshuffled, so a position
    is a row; a slot past the items holds the clamped last position)."""
    r, c = np.nonzero(got != want)
    if r.size:
        q = queries[r].astype(np.float64)
        da = np.linalg.norm(items[got[r, c]].astype(np.float64) - q, axis=1)
        db = np.linalg.norm(items[want[r, c]].astype(np.float64) - q, axis=1)
        assert (np.abs(da - db) <= TIE_RTOL * db).all(), "positions differ off near-ties"


def _exchange_matrix(items, queries, k, shard_counts):
    """{(n_dev, route): (distances, positions)} of both packages'
    knn_block_kernel_exchange at the same geometry."""
    ids = np.arange(len(items), dtype=np.int64)
    got, want = {}, {}
    for n_dev in shard_counts:
        jp = ref_knn.prepare_items(items, ids, _jax_mesh(n_dev), shuffle=False)
        pp = port_knn.prepare_items(items, ids, _port_mesh(n_dev), shuffle=False)
        assert pp.n_rows == jp.items.shape[0]
        n_loc = pp.n_rows // n_dev
        for route in ("ring", "gather"):
            chunk, qt = ref_knn._exchange_geometry(n_loc, len(queries), n_dev, route)
            assert port_knn._exchange_geometry(n_loc, len(queries), n_dev, route) == (chunk, qt)
            want[(n_dev, route)] = ref_knn.knn_block_kernel_exchange(
                jp.items, jp.norm, jp.pos, jp.valid, jnp.asarray(queries), _jax_mesh(n_dev), k, route, chunk, qt)
            d, p = port_knn.knn_block_kernel_exchange(pp, torch.from_numpy(queries), k, route, chunk, qt)
            got[(n_dev, route)] = (d.numpy(), p.numpy())
    return got, jax.device_get(want)


@pytest.mark.parametrize("kind", ["quarter", "gaussian"])
def test_exchange_parity_matrix(kind):
    """1, 2 and 8 shards x ring and gather: bit for bit among themselves,
    and against the JAX package's knn_block_kernel_exchange (bit for bit on
    quarter-step data)."""
    items, queries = _data(4096, 48, 512, kind)
    got, want = _exchange_matrix(items, queries, 17, (1, 2, 8))
    ref_d, ref_p = got[(1, "ring")]
    for key, (d, p) in got.items():
        np.testing.assert_array_equal(d, ref_d, err_msg=str(key))
        np.testing.assert_array_equal(p, ref_p, err_msg=str(key))
        wd, wp = want[key]
        if kind == "quarter":
            np.testing.assert_array_equal(d, wd, err_msg=str(key))
            np.testing.assert_array_equal(p, wp, err_msg=str(key))
        else:
            np.testing.assert_allclose(d, wd, rtol=DIST_RTOL, err_msg=str(key))
            _assert_positions_off_near_ties(items, queries, p, wp)
    d2 = ((queries[:, None].astype(np.float64) - items[None]) ** 2).sum(-1)
    np.testing.assert_allclose(ref_d, np.sqrt(np.sort(d2, axis=1)[:, :17]), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_items,k", [(509, 9), (509, 522)], ids=["invalid_rows", "k_over_items"])
def test_exchange_parity_with_invalid_rows_and_k_over_items(n_items, k):
    """509 items pad to 512 on 8 shards (3 invalid rows); with k past the
    items every route marks the unfillable slots with inf, as the JAX
    package does."""
    items, queries = _data(n_items, 32, 128, "quarter", seed=9)
    got, want = _exchange_matrix(items, queries, k, (1, 8))
    ref_d, ref_p = got[(1, "ring")]
    filled = np.isfinite(ref_d)
    for key, (d, p) in got.items():
        np.testing.assert_array_equal(d, ref_d, err_msg=str(key))
        # an unfilled slot holds the last padded position, which depends on
        # the padding of the shard count (in both packages)
        np.testing.assert_array_equal(p[filled], ref_p[filled], err_msg=str(key))
        assert (p[~filled] == (n_items if key[0] == 1 else 512) - 1).all()
        np.testing.assert_array_equal(d, want[key][0], err_msg=str(key))
        np.testing.assert_array_equal(p, want[key][1], err_msg=str(key))
    assert filled[:, : min(k, n_items)].all()
    assert not filled[:, n_items:].any() and ref_d.shape == (128, k)


def test_ring_sections_and_route_counters():
    """The ring reports per-hop payload bytes through the typed sections
    (the JAX package's tests/test_knn_exchange.py model), the gather its
    stacked candidates, and _exact_block_search the route that ran: the
    ring for any row count (a ragged block is padded to shard evenly), the
    gather only when asked for."""
    items, queries = _data(1024, 16, 128, "gaussian", seed=6)
    prepared = port_knn.prepare_items(items, np.arange(1024), _port_mesh(N_DEV), shuffle=False)
    chunk, qt = port_knn._exchange_geometry(1024 // N_DEV, 128, N_DEV, "ring")
    profiling.reset_counters()
    port_knn.knn_block_kernel_exchange(prepared, torch.from_numpy(queries), 5, "ring", chunk, qt)
    ctr = profiling.counters()
    # 8 hops x per-shard (16, 16) f32 query block
    assert ctr["exchange.knn.ring_q.bytes"] == 8 * (128 // 8) * 16 * 4
    # 8 hops x per-shard (16, 5) f32 + (16, 5) i32 running candidates
    assert ctr["exchange.knn.ring_cand.bytes"] == 8 * 2 * (128 // 8) * 5 * 4
    assert ctr["exchange.knn.ring_q.calls"] == 8 and ctr["exchange.knn.ring_cand.calls"] == 16
    profiling.reset_counters()
    q = torch.from_numpy(queries)
    port_knn._exact_block_search(prepared, q, 5)
    port_knn._exact_block_search(prepared, q[:100], 5)            # 100 rows pad to 128
    port_knn._exact_block_search(prepared, q, 5, exchange="gather")
    one = port_knn.prepare_items(items, np.arange(1024), _port_mesh(1), shuffle=False)
    port_knn._exact_block_search(one, q, 5)
    ctr = profiling.counters("knn.exchange_route.")
    assert ctr == {"knn.exchange_route.ring": 2, "knn.exchange_route.gather": 1, "knn.exchange_route.local": 1}
    # one gather of 128 rows: (128, 5) distances and positions
    assert profiling.counters("exchange.knn.gather_cand.")["exchange.knn.gather_cand.bytes"] == 2 * 128 * 5 * 4
    with pytest.raises(ValueError, match="exchange"):
        port_knn._exact_block_search(prepared, q, 5, exchange="legacy")
    with pytest.raises(ValueError, match="divide"):
        port_knn.knn_block_kernel_exchange(prepared, q[:100], 5, "ring", chunk, qt)


@pytest.mark.parametrize("q_rows,n_dev,padded,qt", [(37, 8, 64, 8), (37, 2, 64, 32), (1001, 8, 1024, 64),
                                                    (130, 8, 256, 32)])
def test_ragged_blocks_pad_onto_the_ring(q_rows, n_dev, padded, qt):
    """A block whose rows do not shard evenly (flagged rows, the exact
    route's last block) is zero-padded to whole sub-tiles per shard and runs
    the ring with one (qt, D) product per chunk and shard, not a one-row
    product per row; the rows returned equal the one-shard search, and the
    JAX package's search of the block padded to its pow2 bucket."""
    items, queries = _data(2048, 24, q_rows, "quarter", seed=q_rows)
    ids = np.arange(2048, dtype=np.int64)
    prepared = port_knn.prepare_items(items, ids, _port_mesh(n_dev), shuffle=False)
    assert port_knn._exchange_rows(q_rows, n_dev) == padded
    assert port_knn._exchange_geometry(2048 // n_dev, padded, n_dev, "ring")[1] == qt
    products = []
    real = torch.matmul
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch, "matmul", lambda a, b, **kw: products.append(a.shape[0]) or real(a, b, **kw))
    profiling.reset_counters()
    try:
        d, p = port_knn._exact_block_search(prepared, torch.from_numpy(queries), 9)
    finally:
        monkey.undo()
    assert profiling.counters("knn.exchange_route.") == {"knn.exchange_route.ring": 1}
    assert set(products) == {qt} and len(products) == n_dev * n_dev * (padded // n_dev // qt)
    assert profiling.counters()["exchange.knn.ring_q.bytes"] == n_dev * (padded // n_dev) * 24 * 4
    one = port_knn.prepare_items(items, ids, _port_mesh(1), shuffle=False)
    want_d, want_p = port_knn._exact_block_search(one, torch.from_numpy(queries), 9)
    assert d.shape == (q_rows, 9)
    np.testing.assert_array_equal(d.numpy(), want_d.numpy())
    np.testing.assert_array_equal(p.numpy(), want_p.numpy())
    jp = ref_knn.prepare_items(items, ids, _jax_mesh(n_dev), shuffle=False)
    bucket = np.zeros((max(64, 1 << (q_rows - 1).bit_length()), 24), np.float32)
    bucket[:q_rows] = queries
    jd, jpos = jax.device_get(ref_knn._exact_block_search(jp.items, jp.norm, jp.pos, jp.valid, jnp.asarray(bucket),
                                                          _jax_mesh(n_dev), 9))
    np.testing.assert_array_equal(d.numpy(), jd[:q_rows])
    np.testing.assert_array_equal(p.numpy(), jpos[:q_rows])


@pytest.mark.parametrize("groups", [((0, 1, 2, 3), (4, 5, 6, 7)), ((0, 2, 4, 6), (1, 3, 5, 7))],
                         ids=["hier", "interleaved"])
def test_gateway_cycle_ring_equals_flat(groups):
    """The hierarchical topology's gateway cycle visits the shards in
    another order; the lex merges land on the same bits, and the link
    counters split the hop's bytes as the JAX model does."""
    items, queries = _data(2048, 24, 256, "gaussian", seed=8)
    prepared = port_knn.prepare_items(items, np.arange(2048), _port_mesh(N_DEV), shuffle=False)
    chunk, qt = port_knn._exchange_geometry(2048 // N_DEV, 256, N_DEV, "ring")
    q = torch.from_numpy(queries)
    flat = port_knn.knn_block_kernel_exchange(prepared, q, 7, "ring", chunk, qt)
    topo = topology.TopologyMap(groups=groups, source="override")
    profiling.reset_counters()
    hier = port_knn.knn_block_kernel_exchange(prepared, q, 7, "ring", chunk, qt, topo)
    for a, b in zip(flat, hier):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ctr = profiling.counters("exchange.knn.ring_q.")
    ici, dcn = topology.link_split_ring_hop(topo, (256 // N_DEV) * 24 * 4)
    assert ctr["exchange.knn.ring_q.ici_bytes"] == 8 * ici and ctr["exchange.knn.ring_q.dcn_bytes"] == 8 * dcn
    gathered = port_knn.knn_block_kernel_exchange(prepared, q, 7, "gather", *port_knn._exchange_geometry(
        2048 // N_DEV, 256, N_DEV, "gather"), topo)
    for a, b in zip(flat, gathered):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_prepare_items_on_a_mesh_matches_the_jax_package():
    """The same permutation, rows padded to a shard multiple (padding
    invalid, id -1), shard i the i-th run of rows, positions global."""
    items, _ = _data(1003, 10, 1, "gaussian", seed=13)
    ids = np.arange(1003, dtype=np.int64) * 5 + 3
    want = ref_knn.prepare_items(items, ids, _jax_mesh(N_DEV))
    got = port_knn.prepare_items(items, ids, _port_mesh(N_DEV))
    assert len(got.shards) == N_DEV and got.n_rows == want.items.shape[0] == 1008 and got.n_items == 1003
    np.testing.assert_array_equal(torch.cat([sh.items for sh in got.shards]).numpy(), np.asarray(want.items))
    np.testing.assert_array_equal(torch.cat([sh.valid for sh in got.shards]).numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.ids, want.ids)
    assert [sh.base for sh in got.shards] == [int(np.asarray(want.pos)[i * 126]) for i in range(N_DEV)]
    np.testing.assert_allclose(torch.cat([sh.norm for sh in got.shards]).numpy(), np.asarray(want.norm), rtol=1e-6)
    with pytest.raises(ValueError, match="sharded 8 ways"):
        got.items
    # staged from row blocks, in small chunks: the same shards
    port_knn._STAGE_CHUNK_BYTES, saved = 40 * 10 * 4, port_knn._STAGE_CHUNK_BYTES
    try:
        again = port_knn.prepare_items([items[:500], items[500:]], ids, _port_mesh(N_DEV))
    finally:
        port_knn._STAGE_CHUNK_BYTES = saved
    for a, b in zip(again.shards, got.shards):
        assert torch.equal(a.items, b.items) and torch.equal(a.valid, b.valid)


def test_search_on_a_mesh_equals_one_shard():
    """knn_search_prepared on 8 shards: the kernel route (B5 per shard ->
    one B7 over the gathered pools) and the exact route through the ring
    (m > 32: 2,048 items, k = 9) both equal the one-shard search."""
    for n, d, q, k, kernel_route in ((32768, 8, 200, 2, True), (2048, 24, 304, 9, False)):
        items, queries = _data(n, d, q, "quarter", seed=n)
        ids = np.arange(n, dtype=np.int64) * 3 + 1
        one = port_knn.prepare_items(items, ids, _port_mesh(1))
        mesh = port_knn.prepare_items(items, ids, _port_mesh(N_DEV))
        assert port_knn._kernel_route(k, n // N_DEV)[0] == kernel_route
        profiling.reset_counters()
        calls = []
        real = port_knn.knn_kernels.knn_candidates_plain
        port_knn.knn_kernels.knn_candidates_plain = lambda *a: calls.append(a[0].shape[0]) or real(*a)
        try:
            want_d, want_i = port_knn.knn_search_prepared(one, queries, k, query_block=128)
            got_d, got_i = port_knn.knn_search_prepared(mesh, queries, k, query_block=128)
        finally:
            port_knn.knn_kernels.knn_candidates_plain = real
        np.testing.assert_array_equal(got_d, want_d)
        np.testing.assert_array_equal(got_i, want_i)
        ctr = profiling.counters()
        blocks = -(-q // 128)
        assert calls[:blocks] == [n] * blocks  # the one-shard search: the kernel route both times
        if kernel_route:
            assert calls[blocks:] == [n // N_DEV] * (N_DEV * blocks)
            assert ctr["exchange.knn.cand_pool.calls"] == 2 * blocks
        else:  # 128, 128 and 48 queries: every block shards 8 ways
            assert calls[blocks:] == [] and ctr["knn.exchange_route.ring"] == blocks


def test_flagged_rows_rerun_through_the_ring(monkeypatch):
    """On a mesh the kernel route's flagged rows re-run through the ring,
    whatever their count, and come back exact."""
    items, queries = _data(32768, 8, 160, "quarter", seed=21)
    mesh = port_knn.prepare_items(items, np.arange(32768), _port_mesh(N_DEV))
    want_d, want_i = port_knn.knn_search_prepared(mesh, queries, 3)
    real = port_knn.knn_kernels.knn_fused_merge

    def flag_every_row(vals, pos, k):
        dist, fpos, flags, thresh, above = real(vals, pos, k)
        return dist, fpos, torch.ones_like(flags), thresh, above

    monkeypatch.setattr(port_knn.knn_kernels, "knn_fused_merge", flag_every_row)
    monkeypatch.setattr(port_knn.knn_search_prepared, "rerun_rows", 0)
    profiling.reset_counters()
    got_d, got_i = port_knn.knn_search_prepared(mesh, queries, 3)
    assert port_knn.knn_search_prepared.rerun_rows == 160
    assert profiling.counters("knn.exchange_route.") == {"knn.exchange_route.ring": 1}
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_i, want_i)
    # the audit route on the mesh: per-shard counts summed (knn.count section)
    d_a, i_a = port_knn.knn_search_prepared(mesh, queries, 3, audit=True)
    np.testing.assert_array_equal(i_a, want_i)
    assert profiling.counters("exchange.knn.count.")["exchange.knn.count.calls"] == 1


def _port_result(knn_df, id_col="unique_id"):
    qid = np.concatenate([p[f"query_{id_col}"] for p in knn_df.partitions])
    order = np.argsort(qid, kind="stable")
    idx = np.concatenate([p["indices"] for p in knn_df.partitions])[order]
    dist = np.concatenate([p["distances"] for p in knn_df.partitions])[order]
    return idx, dist


def _ref_result(knn_df, id_col="unique_id"):
    pdf = knn_df.toPandas().sort_values(f"query_{id_col}", kind="stable")
    return np.stack(pdf["indices"].to_numpy()), np.stack(pdf["distances"].to_numpy())


@pytest.mark.parametrize("n_items,k", [(3000, 7), (640, 9)], ids=["kernel_route", "ring"])
def test_nearest_neighbors_on_a_mesh(n_items, k):
    """NearestNeighbors(num_workers=8) equals num_workers=1 and the JAX
    package's model on its 8-device mesh; the model stages the items once
    per mesh."""
    items, queries = _data(n_items, 12, 96, "quarter", seed=3)
    item_df = port.DataFrame.from_numpy(items, num_partitions=3)
    query_df = port.DataFrame.from_numpy(queries, num_partitions=2)
    one_i, one_d = _port_result(port.NearestNeighbors(k=k, num_workers=1).fit(item_df).kneighbors(query_df)[2])
    model = port.NearestNeighbors(k=k).fit(item_df)
    assert model.num_workers == N_DEV
    got_i, got_d = _port_result(model.kneighbors(query_df)[2])
    staged = model._staged_items[1]
    assert len(staged.shards) == N_DEV and staged.mesh == _port_mesh(N_DEV)
    np.testing.assert_array_equal(got_i, one_i)
    np.testing.assert_array_equal(got_d, one_d)
    model.kneighbors(query_df)
    assert model._staged_items[1] is staged  # the cached call staged nothing
    ref_model = ref.NearestNeighbors(k=k, num_workers=N_DEV).fit(RefDataFrame.from_numpy(items, num_partitions=3))
    want_i, want_d = _ref_result(ref_model.kneighbors(RefDataFrame.from_numpy(queries, num_partitions=2))[2])
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=DIST_RTOL)
    # a JAX model carried across keeps its num_workers
    carried = nearest_neighbors_model_from_reference(items, np.arange(n_items), {"k": k, "num_workers": 2})
    assert carried.num_workers == 2
    c_i, c_d = _port_result(carried.kneighbors(query_df)[2])
    assert len(carried._staged_items[1].shards) == 2
    np.testing.assert_array_equal(c_i, got_i)
    np.testing.assert_array_equal(c_d, got_d)


def test_streamed_blocks_on_a_mesh(monkeypatch):
    """Under a small item budget the items stream through in blocks of a
    shard multiple, the budget split among the shards that share the
    device; the results equal the in-core search's."""
    items, queries = _data(3000, 16, 120, "gaussian", seed=11)
    item_df = port.DataFrame.from_numpy(items, num_partitions=6)
    query_df = port.DataFrame.from_numpy(queries, num_partitions=2)
    want_i, want_d = _port_result(port.NearestNeighbors(k=7).fit(item_df).kneighbors(query_df)[2])
    budget = 512 * (16 * 4 + port_knn._ROW_OVERHEAD)
    monkeypatch.setattr(port_knn, "_item_budget_bytes", lambda dev: budget)
    assert port_knn._item_block_rows(16, _port_mesh(N_DEV)) == (512 // N_DEV) * N_DEV
    assert port_knn._item_block_rows(16, torch.device("cpu")) == 512
    blocks = []
    real = port_knn.prepare_items

    def spy(items, item_ids, device=None, shuffle=True):
        blocks.append((len(item_ids), device))
        return real(items, item_ids, device, shuffle)

    monkeypatch.setattr(port_knn, "prepare_items", spy)
    model = port.NearestNeighbors(k=7).fit(item_df)
    got_i, got_d = _port_result(model.kneighbors(query_df)[2])
    assert model._staged_items is None and len(blocks) == 6
    assert all(rows <= 512 and dev == _port_mesh(N_DEV) for rows, dev in blocks)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6)
    _assert_positions_off_near_ties(items, queries, got_i, want_i)  # ids are rows here
