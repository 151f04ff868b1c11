# The port's distributed_kneighbors (spark_rapids_ml_tpu_torch/ops/knn.py)
# against the JAX package's, on the CPU, with ranks mocked as threads of this
# process over one string control plane (each rank on its own slice of the
# device list, mesh.slice_meshes, as in the JAX package).
#
# Cases: the ring and the allgather routes; the route every rank takes when
# one rank's items exceed its item budget (tests/test_knn_exchange.py:
# 302-350); a rank with no items and a rank with no queries; k above the item
# count; 1, 2 and 4 ranks.  The data are small integers (and quarter steps),
# so every distance is exact in float32 and ties are frequent: ids and
# distances are compared bit for bit, and the route counters as the JAX test
# counts them.
import threading

import numpy as np
import pytest

from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu.ops.knn import distributed_kneighbors as ref_distributed_kneighbors

from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops.knn import distributed_kneighbors


@pytest.fixture(autouse=True)
def _cpu_mesh():
    with use_device(["cpu"] * 8):
        yield


class _StringBarrier:
    """A rank-indexed string allGather shared by thread-ranks."""

    def __init__(self, nranks):
        self._slots = [None] * nranks
        self._barrier = threading.Barrier(nranks)
        self._lock = threading.Lock()

    def plane(self, rank):
        outer = self

        class _P:
            def allGather(self, message):
                assert isinstance(message, str)
                with outer._lock:
                    outer._slots[rank] = message
                outer._barrier.wait()
                out = list(outer._slots)
                outer._barrier.wait()
                return out

        return _P()


def _run_ranks(nranks, fn):
    results, errors = {}, {}

    def run(r):
        try:
            results[r] = fn(r)
        except Exception as e:  # noqa: BLE001 - surfaced below
            errors[r] = e

    threads = [threading.Thread(target=run, args=(r,), name=f"dknn-rank{r}") for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return results


def _case(nranks, n=700, d=9, nq=37, k=11, quarter=False, empty_items=None, empty_queries=None, seed=3):
    rng = np.random.default_rng(seed)
    items = rng.integers(-4, 5, size=(n, d)).astype(np.float32)
    queries = rng.integers(-4, 5, size=(nq, d)).astype(np.float32)
    if quarter:
        items /= 4
        queries /= 4
    ids = np.arange(n, dtype=np.int64) * 7 + 3
    item_split = np.array_split(np.arange(n), nranks)
    q_split = np.array_split(np.arange(nq), nranks)
    if empty_items is not None:
        item_split[empty_items] = np.arange(0)
    if empty_queries is not None:
        q_split[empty_queries] = np.arange(0)
    return items, ids, queries, item_split, q_split, k


def _dist_routes(counters):
    """The distributed route counters (the in-mesh search inside each rank
    counts its own exchange route apart: the JAX package's SRML_KNN_EXCHANGE
    also steers it, the port's in-mesh search always rings)."""
    return {k: v for k, v in counters.items() if k.startswith("knn.exchange_route.dist_")}


def _both(case, route, monkeypatch, jax_budget=None, port_budget=None):
    """(JAX results, port results, distributed route counters of each) of
    one case."""
    items, ids, queries, item_split, q_split, k = case
    nranks = len(item_split)
    monkeypatch.setenv("SRML_KNN_EXCHANGE", route)
    if jax_budget is not None:
        monkeypatch.setenv("SRML_KNN_HBM_BUDGET", str(jax_budget))

    def parts(r):
        return [(items[item_split[r]], ids[item_split[r]])], [(queries[q_split[r]], q_split[r].astype(np.int64))]

    ref_profiling.reset_counters("knn.")
    jb = _StringBarrier(nranks)
    ref = _run_ranks(nranks, lambda r: ref_distributed_kneighbors(*parts(r), k, r, nranks, jb.plane(r)))
    ref_routes = _dist_routes(ref_profiling.counters("knn.exchange_route."))
    profiling.reset_counters("knn.")
    profiling.reset_counters("exchange.")
    pb = _StringBarrier(nranks)
    got = _run_ranks(nranks, lambda r: distributed_kneighbors(
        *parts(r), k, r, nranks, pb.plane(r), exchange=route, item_budget_bytes=port_budget))
    return ref, got, ref_routes, _dist_routes(profiling.counters("knn.exchange_route."))


def _assert_bitwise(ref, got, q_split):
    for r, rows in enumerate(q_split):
        ((d_ref, i_ref),) = ref[r]
        ((d_got, i_got),) = got[r]
        assert d_got.shape == d_ref.shape == i_got.shape == (len(rows), d_ref.shape[1])
        assert d_got.dtype == np.float32 and i_got.dtype == np.int64
        np.testing.assert_array_equal(d_got, d_ref)
        np.testing.assert_array_equal(i_got, i_ref)


@pytest.mark.parametrize("route", ["ring", "gather"])
@pytest.mark.parametrize("nranks", [1, 2, 4])
def test_routes_bitwise_the_jax_package_s(monkeypatch, route, nranks):
    case = _case(nranks)
    ref, got, ref_routes, routes = _both(case, route, monkeypatch)
    _assert_bitwise(ref, got, case[4])
    assert routes == ref_routes


@pytest.mark.parametrize("route", ["ring", "gather"])
def test_empty_item_rank_and_empty_query_rank(monkeypatch, route):
    """Rank 1 holds no items and rank 2 no queries; both still join every
    round, and every rank's rows come back as the JAX package's."""
    case = _case(4, empty_items=1, empty_queries=2)
    ref, got, ref_routes, routes = _both(case, route, monkeypatch)
    _assert_bitwise(ref, got, case[4])
    assert routes == ref_routes == {f"knn.exchange_route.dist_{'ring' if route == 'ring' else 'allgather'}": 4}


@pytest.mark.parametrize("route", ["ring", "gather"])
def test_k_above_the_item_count(monkeypatch, route):
    case = _case(2, n=9, k=20, quarter=True)
    ref, got, _, _ = _both(case, route, monkeypatch)
    _assert_bitwise(ref, got, case[4])
    assert got[0][0][0].shape[1] == 9


def test_item_budget_overflow_takes_the_allgather_route_everywhere(monkeypatch):
    """175 items a rank over a budget that holds 112 rows on a rank's two
    shards: the rank publishes ring_ok=0 and every rank takes the allgather
    route, streaming its items in two blocks (the JAX budget 2,048 bytes a
    device and the port's 2,520 bytes a shard give the same 112-row
    blocks)."""
    case = _case(4, seed=5)
    ref, got, ref_routes, routes = _both(case, "ring", monkeypatch, jax_budget=2048, port_budget=2520)
    _assert_bitwise(ref, got, case[4])
    assert routes == ref_routes == {"knn.exchange_route.dist_allgather": 4}
    calls = profiling.counters("exchange.")
    assert calls.get("exchange.ring.calls", 0) == 0 and calls["exchange.alltoall.calls"] == 4


def test_ring_passes_and_quarter_steps(monkeypatch):
    """The ring route on quarter-step data: nranks ring passes a rank, no
    alltoall, the JAX package's bits."""
    case = _case(4, quarter=True, seed=11)
    ref, got, _, routes = _both(case, "ring", monkeypatch)
    _assert_bitwise(ref, got, case[4])
    calls = profiling.counters("exchange.")
    assert calls["exchange.ring.calls"] == 4 * 4 and calls.get("exchange.alltoall.calls", 0) == 0
    assert routes == {"knn.exchange_route.dist_ring": 4}


def test_no_queries_anywhere_skips_the_data_rounds(monkeypatch):
    case = _case(2, nq=0)
    ref, got, _, routes = _both(case, "ring", monkeypatch)
    _assert_bitwise(ref, got, case[4])
    assert routes == {}
