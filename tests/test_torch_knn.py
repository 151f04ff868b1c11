# The port's exact NearestNeighbors (spark_rapids_ml_tpu_torch) against the
# JAX package's on the same frames, on the CPU: kneighbors through both of the
# port's routes (kernel route B5 -> B7 with the plain versions, exact route),
# ids, k > items, the streamed path, the join, staging, the audit route, the
# host helpers, and a model carried across.
#
# Tolerances: distances within atol 1e-4 (the JAX package's own kNN test
# against sklearn); indices equal except where the two packages' picks lie
# within 1e-5 relative of each other in float64 (near-ties, which fp32
# rounding may order either way).
import weakref

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops.knn import lex_topk as ref_lex_topk

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.convert import nearest_neighbors_model_from_reference
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import knn as port_knn

ATOL = 1e-4
TIE_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with use_device("cpu"):
        yield


def _data(n_items, n_queries, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_items, d)).astype(np.float32),
            rng.standard_normal((n_queries, d)).astype(np.float32))


def _port_result(knn_df, id_col="unique_id"):
    qid = np.concatenate([p[f"query_{id_col}"] for p in knn_df.partitions])
    order = np.argsort(qid, kind="stable")
    idx = np.concatenate([p["indices"] for p in knn_df.partitions])[order]
    dist = np.concatenate([p["distances"] for p in knn_df.partitions])[order]
    return idx, dist


def _ref_result(knn_df, id_col="unique_id"):
    pdf = knn_df.toPandas().sort_values(f"query_{id_col}", kind="stable")
    return np.stack(pdf["indices"].to_numpy()), np.stack(pdf["distances"].to_numpy())


def _assert_same_neighbours(items, Q, ids, got_i, got_d, want_i, want_d):
    """Distances within ATOL; indices equal off near-ties."""
    assert got_i.shape == want_i.shape and got_i.dtype == np.int64 and got_d.dtype == np.float32
    np.testing.assert_allclose(got_d, want_d, atol=ATOL)
    differ = got_i != want_i
    if differ.any():
        row_of = {int(v): r for r, v in enumerate(ids)}
        r, c = np.nonzero(differ)
        a = items[[row_of[int(v)] for v in got_i[r, c]]].astype(np.float64)
        b = items[[row_of[int(v)] for v in want_i[r, c]]].astype(np.float64)
        da = np.linalg.norm(a - Q[r].astype(np.float64), axis=1)
        db = np.linalg.norm(b - Q[r].astype(np.float64), axis=1)
        assert (np.abs(da - db) <= TIE_RTOL * db).all(), "indices differ off near-ties"


@pytest.mark.parametrize(
    "n_items,n_queries,d,k,kernel_route",
    [
        (200, 30, 6, 7, False),     # m > 32: the exact route
        (3000, 200, 16, 7, True),   # the kernel route (plain versions here)
    ],
)
def test_kneighbors_matches_jax(n_items, n_queries, d, k, kernel_route):
    X, Q = _data(n_items, n_queries, d)
    assert port_knn._kernel_route(k, n_items)[0] == kernel_route
    ref_model = ref.NearestNeighbors(k=k).fit(RefDataFrame.from_numpy(X, num_partitions=4))
    want_i, want_d = _ref_result(ref_model.kneighbors(RefDataFrame.from_numpy(Q, num_partitions=2))[2])
    model = port.NearestNeighbors(k=k).fit(port.DataFrame.from_numpy(X, num_partitions=4))
    _, qdf, knn_df = model.kneighbors(port.DataFrame.from_numpy(Q, num_partitions=2))
    assert knn_df.num_partitions == 2 and "unique_id" in qdf.columns
    got_i, got_d = _port_result(knn_df)
    _assert_same_neighbours(X, Q, np.arange(n_items), got_i, got_d, want_i, want_d)
    assert (np.diff(got_d, axis=1) >= 0).all()


def test_custom_id_col():
    X, Q = _data(50, 5, 6)
    ids = np.arange(100, 150)
    ref_model = ref.NearestNeighbors(k=3).setIdCol("my_id").fit(
        RefDataFrame.from_pandas(pd.DataFrame({"features": list(X), "my_id": ids}), 3))
    want_i, want_d = _ref_result(ref_model.kneighbors(RefDataFrame.from_pandas(
        pd.DataFrame({"features": list(Q), "my_id": np.arange(5)}), 1))[2], "my_id")
    model = port.NearestNeighbors(k=3).setIdCol("my_id").fit(
        port.DataFrame([{"features": X[:20], "my_id": ids[:20]}, {"features": X[20:], "my_id": ids[20:]}]))
    _, _, knn_df = model.kneighbors(port.DataFrame([{"features": Q, "my_id": np.arange(5)}]))
    assert knn_df.columns == ["query_my_id", "indices", "distances"]
    got_i, got_d = _port_result(knn_df, "my_id")
    _assert_same_neighbours(X, Q, ids, got_i, got_d, want_i, want_d)
    assert got_i.min() >= 100 and got_i.max() < 150


def test_int64_ids_survive():
    X, Q = _data(30, 4, 6)
    ids = (np.int64(1) << 40) + np.arange(30, dtype=np.int64) * (np.int64(1) << 33)
    model = port.NearestNeighbors(k=3).setIdCol("my_id").fit(port.DataFrame([{"features": X, "my_id": ids}]))
    got_i, got_d = _port_result(model.kneighbors(port.DataFrame.from_numpy(Q))[2], "my_id")
    d2 = ((Q[:, None].astype(np.float64) - X[None]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")[:, :3]
    np.testing.assert_array_equal(got_i, ids[order])
    np.testing.assert_allclose(got_d, np.sqrt(np.take_along_axis(d2, order, 1)), atol=ATOL)


def test_k_larger_than_items():
    X, Q = _data(4, 3, 6)
    ref_model = ref.NearestNeighbors(k=10).fit(RefDataFrame.from_numpy(X))
    want_i, want_d = _ref_result(ref_model.kneighbors(RefDataFrame.from_numpy(Q))[2])
    model = port.NearestNeighbors(k=10).fit(port.DataFrame.from_numpy(X))
    got_i, got_d = _port_result(model.kneighbors(port.DataFrame.from_numpy(Q))[2])
    assert got_i.shape == (3, 4)
    _assert_same_neighbours(X, Q, np.arange(4), got_i, got_d, want_i, want_d)


def test_streamed_path_equals_in_core(monkeypatch):
    """A small item budget splits the items into several staged blocks
    (merged on the host), each freed before the next is staged, and empty
    query partitions keep their place: the result equals the in-core
    search."""
    X, Q = _data(3000, 120, 16, seed=11)
    item_df = port.DataFrame.from_numpy(X, num_partitions=6)
    qdf = port.DataFrame.from_numpy(Q, num_partitions=3)
    qdf = port.DataFrame([qdf.partitions[0], {"features": np.zeros((0, 16), np.float32)}, *qdf.partitions[1:]])
    in_i, in_d = _port_result(port.NearestNeighbors(k=7).fit(item_df).kneighbors(qdf)[2])
    blocks, staged = [], []
    real_prepare = port_knn.prepare_items

    def spy(items, item_ids, device=None, shuffle=True):
        assert all(ref() is None for ref in staged), "an earlier item block was still alive"
        blocks.append(len(item_ids))
        prepared = real_prepare(items, item_ids, device, shuffle)
        staged.append(weakref.ref(prepared.items))
        return prepared

    monkeypatch.setattr(port_knn, "_item_budget_bytes", lambda dev: 512 * 16 * 4)
    monkeypatch.setattr(port_knn, "prepare_items", spy)
    model = port.NearestNeighbors(k=7).fit(item_df)
    _, _, knn_df = model.kneighbors(qdf)
    assert len(blocks) >= 5 and max(blocks) <= 512 and model._staged_items is None
    assert knn_df.num_partitions == 4 and len(knn_df.partitions[1]) == 0
    assert knn_df.partitions[1]["indices"].shape == (0, 7)
    got_i, got_d = _port_result(knn_df)
    _assert_same_neighbours(X, Q, np.arange(3000), got_i, got_d, in_i, in_d)


def test_knn_search_out_of_core_equals_in_core(monkeypatch):
    """knn_search over items beyond the budget streams item blocks and merges
    on the host: the same neighbours as one staged search (ids offset, so
    they are not positions)."""
    X, Q = _data(2500, 90, 12, seed=12)
    ids = np.arange(2500, dtype=np.int64) * 3 + 11
    in_d, in_i = port_knn.knn_search(X, ids, Q, 6, query_block=64)
    monkeypatch.setattr(port_knn, "_item_budget_bytes", lambda dev: 700 * 12 * 4)
    got_d, got_i = port_knn.knn_search(X, ids, Q, 6, query_block=64)
    _assert_same_neighbours(X, Q, ids, got_i, got_d, in_i, in_d)
    d2 = ((Q[:, None].astype(np.float64) - X[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got_d, np.sqrt(np.sort(d2, axis=1)[:, :6]), atol=ATOL)


@pytest.mark.parametrize("source", ["array", "blocks", "tensor"])
def test_prepare_items_matches_the_jax_permutation(monkeypatch, source):
    """Staging in small chunks, scattered into their shuffled rows, gives the
    JAX package's prepared rows and ids (its host-side items[perm])."""
    from spark_rapids_ml_tpu.ops.knn import prepare_items as ref_prepare
    from spark_rapids_ml_tpu.parallel.mesh import get_mesh

    X, _ = _data(1100, 1, 10, seed=13)
    ids = np.arange(1100, dtype=np.int64) * 5 + 3
    want = ref_prepare(X, ids, get_mesh(None))
    monkeypatch.setattr(port_knn, "_STAGE_CHUNK_BYTES", 64 * 10 * 4)
    items = {"array": X, "blocks": [X[:300], X[300:301], X[301:]], "tensor": torch.from_numpy(X)}[source]
    got = port_knn.prepare_items(items, ids)
    np.testing.assert_array_equal(got.items.numpy(), np.asarray(want.items)[:1100, :10])
    np.testing.assert_array_equal(got.ids, want.ids[:1100])
    np.testing.assert_array_equal(got.norm.numpy(), (got.items * got.items).sum(dim=1).numpy())
    assert got.n_items == want.n_items == 1100 and bool(got.valid.all())


def test_wide_pool_shortens_the_query_block(monkeypatch):
    """Where a block's pool would pass the block budget, the kernel route
    takes fewer queries a block and returns the same neighbours."""
    X, Q = _data(3000, 100, 16, seed=14)
    prepared = port_knn.prepare_items(X, np.arange(3000))
    want_d, want_i = port_knn.knn_search_prepared(prepared, Q, 7)
    pools = []
    real_pool = port_knn.knn_kernels.knn_candidates_plain

    def spy(items, inorm, queries, qnorm, m):
        pools.append(queries.shape[0])
        return real_pool(items, inorm, queries, qnorm, m)

    m = port_knn._kernel_route(7, 3000)[1]
    per_query = 4 * 16 + 8 * 3 * m + 8 * 7 + 16
    monkeypatch.setattr(port_knn, "_BLOCK_BYTES", 30 * per_query)
    monkeypatch.setattr(port_knn.knn_kernels, "knn_candidates_plain", spy)
    got_d, got_i = port_knn.knn_search_prepared(prepared, Q, 7)
    assert pools == [30, 30, 30, 10]
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


def test_exact_nearest_neighbors_join_matches_jax():
    X, Q = _data(40, 6, 5)
    ref_model = ref.NearestNeighbors(k=2).fit(RefDataFrame.from_numpy(X, num_partitions=2))
    want = ref_model.exactNearestNeighborsJoin(RefDataFrame.from_numpy(Q), distCol="dist").toPandas()
    model = port.NearestNeighbors(k=2).fit(port.DataFrame.from_numpy(X, num_partitions=2))
    join_df = model.exactNearestNeighborsJoin(port.DataFrame.from_numpy(Q), distCol="dist")
    assert join_df.columns == ["item_df", "query_df", "dist"]
    got = {c: np.concatenate([p[c] for p in join_df.partitions]) for c in join_df.columns}
    assert len(got["dist"]) == len(want) == 6 * 2 and got["dist"].dtype == np.float64
    np.testing.assert_allclose(got["dist"], want["dist"].to_numpy(), atol=ATOL)
    for g, w in zip(got["item_df"], want["item_df"]):
        assert set(g) == set(w) == {"features"}  # the generated id stays out
        np.testing.assert_array_equal(g["features"], w["features"])
    for g, w in zip(got["query_df"], want["query_df"]):
        np.testing.assert_array_equal(g["features"], w["features"])
    # a user id column stays in the structs
    model = port.NearestNeighbors(k=2).setIdCol("rid").fit(
        port.DataFrame([{"features": X, "rid": np.arange(40) + 7}]))
    join_df = model.exactNearestNeighborsJoin(port.DataFrame([{"features": Q, "rid": np.arange(6)}]))
    assert set(join_df.partitions[0]["item_df"][0]) == {"features", "rid"}


def test_no_persistence():
    X, _ = _data(20, 1, 3)
    nn = port.NearestNeighbors(k=2)
    with pytest.raises(NotImplementedError):
        nn.write()
    with pytest.raises(NotImplementedError):
        port.NearestNeighbors.read()
    model = nn.fit(port.DataFrame.from_numpy(X))
    with pytest.raises(NotImplementedError):
        model.write()
    with pytest.raises(NotImplementedError):
        port.NearestNeighborsModel.read()
    assert port.NearestNeighbors(k=9).tpu_params["n_neighbors"] == 9
    assert port.NearestNeighbors(n_neighbors=4).getK() == 4


def test_seed_staging_hits_the_staging_cache(monkeypatch):
    X, Q = _data(2000, 50, 8, seed=4)
    item_df = port.DataFrame.from_numpy(X, num_partitions=2)
    model = port.NearestNeighbors(k=5).fit(item_df)
    want_i, want_d = _port_result(model.kneighbors(port.DataFrame.from_numpy(Q))[2])
    seeded = port.NearestNeighbors(k=5).fit(item_df)
    seeded.seed_staging(port_knn.prepare_items(X, np.arange(2000)))

    def no_restaging(*args, **kwargs):
        raise AssertionError("kneighbors staged the items again: the seeded key missed")

    monkeypatch.setattr(port_knn, "iter_prepared_item_blocks", no_restaging)
    got_i, got_d = _port_result(seeded.kneighbors(port.DataFrame.from_numpy(Q))[2])
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)
    with pytest.raises(ValueError, match="row count"):
        seeded.seed_staging(port_knn.prepare_items(X[:10], np.arange(10)))


def test_query_partition_beyond_the_budget_is_not_cached(monkeypatch):
    """Items within the budget stay staged; a query partition larger than
    the budget is searched from the host, block by block, and not cached."""
    X, Q = _data(100, 2000, 8, seed=9)
    item_df = port.DataFrame.from_numpy(X)
    want_i, want_d = _port_result(port.NearestNeighbors(k=4).fit(item_df).kneighbors(port.DataFrame.from_numpy(Q))[2])
    monkeypatch.setattr(port_knn, "_item_budget_bytes", lambda dev: 5000)
    model = port.NearestNeighbors(k=4).fit(item_df)
    got_i, got_d = _port_result(model.kneighbors(port.DataFrame.from_numpy(Q))[2])
    assert model._staged_items is not None and not model._staged_queries
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


def test_audit_route_agrees_with_the_self_verify_route(monkeypatch):
    X, Q = _data(4000, 300, 24, seed=6)
    prepared = port_knn.prepare_items(X, np.arange(4000))
    assert port_knn._kernel_route(9, 4000)[0]
    for name in ("flagged_rows", "count_failed_rows", "count_failed_unflagged_rows"):
        monkeypatch.setattr(port_knn.knn_search_prepared, name, 0)
    d_main, i_main = port_knn.knn_search_prepared(prepared, Q, 9, query_block=128)
    d_audit, i_audit = port_knn.knn_search_prepared(prepared, Q, 9, query_block=128, audit=True)
    np.testing.assert_array_equal(i_audit, i_main)
    np.testing.assert_array_equal(d_audit, d_main)
    assert port_knn.knn_search_prepared.count_failed_unflagged_rows == 0
    assert port_knn.knn_search_prepared.count_failed_rows <= port_knn.knn_search_prepared.flagged_rows


def test_model_carried_across_from_the_reference():
    X, Q = _data(500, 20, 8, seed=8)
    ref_model = ref.NearestNeighbors(k=4).fit(RefDataFrame.from_numpy(X, num_partitions=2))
    want_i, want_d = _ref_result(ref_model.kneighbors(RefDataFrame.from_numpy(Q))[2])
    items = ref_model._item_df.toPandas()
    model = nearest_neighbors_model_from_reference(
        np.stack(items["features"].to_numpy()), items["unique_id"].to_numpy(), {"k": ref_model.getK()})
    assert isinstance(model, port.NearestNeighborsModel) and model.getK() == 4
    got_i, got_d = _port_result(model.kneighbors(port.DataFrame.from_numpy(Q))[2])
    _assert_same_neighbours(X, Q, np.arange(500), got_i, got_d, want_i, want_d)


@pytest.mark.parametrize("c,k", [(3000, 40), (20, 25)])
def test_lex_topk_matches_jax(c, k):
    """The (d2, pos) total order: heavy ties, positions in no order, fewer
    columns than k in the second case."""
    rng = np.random.default_rng(2 + c)
    d2 = rng.integers(0, 30, size=(6, c)).astype(np.float32)
    d2[:, ::7] = np.inf
    pos = np.stack([rng.permutation(c) for _ in range(6)]).astype(np.int32)
    want = jax.device_get(ref_lex_topk(jnp.asarray(d2), jnp.asarray(pos), k))
    got = port_knn.lex_topk(torch.from_numpy(d2), torch.from_numpy(pos), k)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_host_helpers_match_jax():
    from spark_rapids_ml_tpu import native
    from spark_rapids_ml_tpu.dataframe import DataFrame as RefDF
    from spark_rapids_ml_tpu.ops.knn import _pad_topk_to_k as ref_pad
    from spark_rapids_ml_tpu.ops.knn import _select_m as ref_select_m

    rng = np.random.default_rng(3)
    da = np.sort(rng.standard_normal((5, 6)).astype(np.float32), axis=1)
    db = np.sort(rng.standard_normal((5, 6)).astype(np.float32), axis=1)
    ia, ib = rng.integers(0, 99, (5, 6)), rng.integers(100, 199, (5, 6))
    for got, want in zip(port_knn.topk_merge(da, ia, db, ib), native.topk_merge(da, ia, db, ib)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_knn._pad_topk_to_k(da[:, :2], ia[:, :2], 5), ref_pad(da[:, :2], ia[:, :2], 5)):
        np.testing.assert_array_equal(got, want)
    for k, n in ((200, 400_384), (200, 400_000), (7, 3000), (1, 10), (2048, 32768)):
        assert port_knn._select_m(k, 1024, n) == ref_select_m(k, 1024, n)
    assert port_knn._select_m(200, 1024, 400_000) == 9
    parts = [np.zeros((3, 2), np.float32), np.zeros((0, 2), np.float32), np.zeros((4, 2), np.float32)]
    got = port.DataFrame([{"features": p} for p in parts]).with_row_id("rid")
    want = RefDF.from_pandas(pd.DataFrame({"features": list(np.zeros((7, 2)))}), 1)
    want = RefDF([want.partitions[0].iloc[lo:hi] for lo, hi in ((0, 3), (3, 3), (3, 7))]).with_row_id("rid")
    for g, w in zip(got.partitions, want.partitions):
        np.testing.assert_array_equal(g["rid"], w["rid"].to_numpy())
        assert g["rid"].dtype == np.int64
