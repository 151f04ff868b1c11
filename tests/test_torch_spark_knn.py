# kneighbors and exactNearestNeighborsJoin of live pyspark frames in the
# port run inside a Spark barrier stage (spark/adapter.
# run_barrier_kneighbors over ops/knn.distributed_kneighbors, spark_knn_join),
# as in the JAX package: item partitions stay with their tasks, only query
# blocks and (queries, k) candidate lists cross tasks, and nothing is
# collected (spark_to_facade is patched to fail in both packages).  pyspark
# is not installed; the fake is this file's own copy of the JAX package's
# tests/test_spark_knn.py fake, whose barrier tasks are threads with a real
# allGather rendezvous, so the control-plane rounds run at 2 ranks.  The
# same fake frames go through both packages: the barrier result, the
# generated int64 ids, the join, the generated id dropped, an empty rank with
# k beyond the items, the mixed-input TypeError and ANN's refusal.  On
# quarter-step data every distance is exact: the port's barrier result is
# the JAX package's bit for bit, and the port's local search's up to the
# order of a tie run (across ranks a run of equal distances is ordered by
# rank).
import sys
import threading
import types

import numpy as np
import pandas as pd
import pytest

import spark_rapids_ml_tpu as ref
from spark_rapids_ml_tpu.dataframe import DataFrame as RefDataFrame
from spark_rapids_ml_tpu.ops.knn import distributed_kneighbors as ref_distributed_kneighbors
from spark_rapids_ml_tpu.spark import adapter as ref_adapter

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops.knn import distributed_kneighbors
from spark_rapids_ml_tpu_torch.spark import adapter
from spark_rapids_ml_tpu_torch.spark.adapter import NUM_WORKERS_CONF

N_TASKS = 2


# -- expression sentinels for pyspark.sql.functions ---------------------------

class _Lit:
    def __init__(self, v):
        self.v = v


class _MonoId:
    pass


# -- threaded barrier context -------------------------------------------------

class _SharedBarrier:
    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=120)
        self.lock = threading.Lock()
        self.rounds = {}


class _FakeBarrierTaskContext:
    _tls = threading.local()

    def __init__(self, rank, shared):
        self._rank = rank
        self._shared = shared
        self._round = 0

    @classmethod
    def get(cls):
        return cls._tls.ctx

    def partitionId(self):
        return self._rank

    def allGather(self, message=""):
        sh = self._shared
        r = self._round
        self._round += 1
        with sh.lock:
            sh.rounds.setdefault(r, {})[self._rank] = message
        sh.barrier.wait()
        return [sh.rounds[r][i] for i in range(sh.n)]

    def barrier(self):
        self.allGather("")


# -- fake pyspark DataFrame ---------------------------------------------------

class _FakeField:
    def __init__(self, name, ddl):
        self.name = name
        self.dataType = types.SimpleNamespace(simpleString=lambda d=ddl: d)


def _parse_ddl(schema: str):
    """Top-level comma split of a DDL string, respecting <> nesting."""
    fields, depth, cur = [], 0, ""
    for ch in schema:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            fields.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        fields.append(cur.strip())
    out = []
    for f in fields:
        name, _, ddl = f.partition(" ")
        out.append(_FakeField(name.strip("`"), ddl.strip()))
    return out


class _FakeRdd:
    def __init__(self, df):
        self._df = df
        self.barriered = False

    def barrier(self):
        self.barriered = True
        return self

    def mapPartitions(self, f):
        return self

    def withResources(self, profile):
        return self


class _FakeSparkSession:
    version = "3.5.0"

    def __init__(self, conf=None):
        conf = conf or {
            "spark.master": "local[2]",
            NUM_WORKERS_CONF: str(N_TASKS),
        }
        self.sparkContext = types.SimpleNamespace(
            getConf=lambda: types.SimpleNamespace(
                get=lambda k, d=None: conf.get(k, d)
            )
        )

    def createDataFrame(self, rdd, schema):
        df = rdd._df
        assert rdd.barriered and df._udf is not None, (
            "createDataFrame in this mock only consumes barrier mapInPandas"
        )
        parts = _run_barrier_tasks(df._src_parts, df._udf, len(df._src_parts))
        fields = _parse_ddl(schema)
        cols = [f.name for f in fields]
        parts = [
            p if len(p.columns) else pd.DataFrame({c: [] for c in cols})
            for p in parts
        ]
        return _FakeSparkDataFrame(parts, fields)


def _run_barrier_tasks(src_parts, udf, n_tasks):
    shared = _SharedBarrier(n_tasks)
    results = [None] * n_tasks
    errs = []

    def work(rank):
        _FakeBarrierTaskContext._tls.ctx = _FakeBarrierTaskContext(rank, shared)
        try:
            results[rank] = list(udf(iter([src_parts[rank]])))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append((rank, e))
            shared.barrier.abort()
        finally:
            _FakeBarrierTaskContext._tls.ctx = None

    threads = [
        threading.Thread(target=work, args=(r,)) for r in range(n_tasks)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0][1]
    return [
        pd.concat(r, ignore_index=True) if r else pd.DataFrame()
        for r in results
    ]


class _FakeSparkDataFrame:
    """Eager pandas-backed stand-in for the pyspark surface the executor-side
    kNN path touches.  mapInPandas is LAZY: barrier consumption runs the UDF
    in concurrent threads (createDataFrame above); plain consumption (struct/
    explode frames feeding joins) runs it sequentially on materialization.
    Deliberately NO toPandas — a driver collect of any frame fails loudly."""

    def __init__(self, partitions, fields, udf=None):
        self._src_parts = partitions
        self._fields = fields
        self._udf = udf
        self.sparkSession = _FakeSparkSession()

    # -- materialization ------------------------------------------------
    def _parts(self):
        if self._udf is None:
            return self._src_parts
        out = []
        for p in self._src_parts:
            chunks = list(self._udf(iter([p])))
            out.append(
                pd.concat(chunks, ignore_index=True)
                if chunks
                else pd.DataFrame({f.name: [] for f in self._fields})
            )
        return out

    def _materialize(self):  # test helper, not pyspark surface
        parts = self._parts()
        return pd.concat(parts, ignore_index=True) if parts else pd.DataFrame()

    # -- pyspark surface ------------------------------------------------
    @property
    def schema(self):
        return types.SimpleNamespace(fields=list(self._fields))

    @property
    def columns(self):
        return [f.name for f in self._fields]

    @property
    def rdd(self):
        return _FakeRdd(self)

    def select(self, *cols):
        assert all(isinstance(c, str) for c in cols)
        fmap = {f.name: f for f in self._fields}
        return _FakeSparkDataFrame(
            [p[list(cols)] for p in self._parts()], [fmap[c] for c in cols]
        )

    def withColumn(self, name, expr):
        parts = []
        for pid, p in enumerate(self._parts()):
            p = p.copy()
            if isinstance(expr, _Lit):
                p[name] = expr.v
            elif isinstance(expr, _MonoId):
                # real monotonically_increasing_id packs the partition id in
                # the high bits — keeping that here proves int64 ids survive
                # the whole kneighbors pipeline
                p[name] = (np.int64(pid) << 33) + np.arange(len(p), dtype=np.int64)
            else:
                raise TypeError(f"unsupported expr {expr!r}")
            parts.append(p)
        ddl = "int" if isinstance(expr, _Lit) else "bigint"
        return _FakeSparkDataFrame(parts, self._fields + [_FakeField(name, ddl)])

    def union(self, other):
        assert self.columns == other.columns, "union requires aligned schemas"
        return _FakeSparkDataFrame(
            self._parts() + other._parts(), self._fields
        )

    def repartition(self, n):
        whole = self._materialize()
        idx = np.array_split(np.arange(len(whole)), n)
        return _FakeSparkDataFrame(
            [whole.iloc[ix].reset_index(drop=True) for ix in idx], self._fields
        )

    def mapInPandas(self, udf, schema=None):
        return _FakeSparkDataFrame(self._src_parts, _parse_ddl(schema), udf=udf)

    def sort(self, col):
        whole = self._materialize().sort_values(col).reset_index(drop=True)
        return _FakeSparkDataFrame([whole], self._fields)

    def join(self, other, on):
        merged = pd.merge(
            self._materialize(), other._materialize(), on=on, how="inner"
        )
        fmap = {f.name: f for f in list(self._fields) + list(other._fields)}
        return _FakeSparkDataFrame(
            [merged], [fmap[c] for c in merged.columns]
        )


_FakeSparkDataFrame.__module__ = "pyspark.sql.dataframe"


@pytest.fixture(autouse=True)
def fake_pyspark(monkeypatch):
    mod = types.ModuleType("pyspark")
    mod.BarrierTaskContext = _FakeBarrierTaskContext
    sqlmod = types.ModuleType("pyspark.sql")
    fmod = types.ModuleType("pyspark.sql.functions")
    fmod.lit = _Lit
    fmod.monotonically_increasing_id = lambda: _MonoId()
    fmod.col = lambda c: c
    mod.sql = sqlmod
    sqlmod.functions = fmod
    monkeypatch.setitem(sys.modules, "pyspark", mod)
    monkeypatch.setitem(sys.modules, "pyspark.sql", sqlmod)
    monkeypatch.setitem(sys.modules, "pyspark.sql.functions", fmod)
    monkeypatch.delenv("SRML_SPARK_COLLECT", raising=False)

    def _boom(sdf):
        raise AssertionError("kNN collected a dataset to the driver")

    monkeypatch.setattr(adapter, "spark_to_facade", _boom)
    monkeypatch.setattr(ref_adapter, "spark_to_facade", _boom)
    with use_device("cpu"):
        yield


def _data(n_items=500, n_query=120, d=8, seed=9, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        # quarter steps: every distance is exact in float32, ties are common
        items = (rng.integers(-8, 9, (n_items, d)) / 4).astype(np.float32)
        queries = (rng.integers(-8, 9, (n_query, d)) / 4).astype(np.float32)
    else:
        items = rng.standard_normal((n_items, d)).astype(np.float32)
        queries = rng.standard_normal((n_query, d)).astype(np.float32)
    return items, queries


def _fake_sdf(X, ids=None, n_parts=3):
    fields = [_FakeField("features", "array<float>")]
    parts = []
    for ix in np.array_split(np.arange(len(X)), n_parts):
        pdf = pd.DataFrame({"features": list(X[ix])})
        if ids is not None:
            pdf["row"] = ids[ix]
        parts.append(pdf.reset_index(drop=True))
    if ids is not None:
        fields.append(_FakeField("row", "bigint"))
    return _FakeSparkDataFrame(parts, fields)


def _sorted_knn(knn_df, qcol):
    got = knn_df._materialize().sort_values(qcol).reset_index(drop=True)
    return got[qcol].to_numpy(np.int64), np.stack(got["indices"].to_numpy()), np.stack(got["distances"].to_numpy())


def _local(items, item_ids, queries, query_ids, k):
    """The port's driver-local search of the same rows and ids."""
    model = port.NearestNeighbors(k=k).setIdCol("row").fit(
        port.DataFrame([{"features": items, "row": item_ids}]))
    _, _, knn = model.kneighbors(port.DataFrame([{"features": queries, "row": query_ids}]))
    q = np.concatenate([p["query_row"] for p in knn.partitions])
    order = np.argsort(q, kind="stable")
    return (q[order], np.concatenate([p["indices"] for p in knn.partitions])[order],
            np.concatenate([p["distances"] for p in knn.partitions])[order])


def _same_up_to_tie_order(ids_a, d_a, ids_b, d_b, items, item_ids, queries, query_rows):
    """Equal distances; in each row the same ids within each run of equal
    distances (the ranks order a tie run by rank), but the run at the k-th
    distance, which k may cut: there each id is an item at that distance."""
    np.testing.assert_array_equal(d_a, d_b)
    pos = {int(i): r for r, i in enumerate(item_ids)}
    for ra, rb, dr, q in zip(ids_a, ids_b, d_a, query_rows):
        for v in np.unique(dr)[:-1]:
            assert sorted(ra[dr == v]) == sorted(rb[dr == v])
        for i in ra[dr == dr[-1]]:
            diff = items[pos[int(i)]] - queries[q]
            assert np.sqrt(np.float32((diff.astype(np.float64) ** 2).sum())) == dr[-1]


@pytest.mark.parametrize("integer", [False, True], ids=["normal", "quarter_steps"])
def test_kneighbors_runs_in_a_barrier_stage(integer):
    items, queries = _data(integer=integer)
    k = 7
    item_ids = np.arange(len(items), dtype=np.int64) * 3 + 11
    query_ids = np.arange(len(queries), dtype=np.int64) * 7 + 5
    model = port.NearestNeighbors(k=k).setIdCol("row").fit(_fake_sdf(items, item_ids))
    assert isinstance(model._item_df, _FakeSparkDataFrame)
    item_out, query_out, knn_df = model.kneighbors(_fake_sdf(queries, query_ids))
    assert isinstance(knn_df, _FakeSparkDataFrame)
    q, ids, d = _sorted_knn(knn_df, "query_row")
    # the frame comes back sorted by query id
    np.testing.assert_array_equal(knn_df._materialize()["query_row"].to_numpy(np.int64), q)
    ref_model = ref.NearestNeighbors(k=k).setIdCol("row").fit(_fake_sdf(items, item_ids))
    rq, rids, rd = _sorted_knn(ref_model.kneighbors(_fake_sdf(queries, query_ids))[2], "query_row")
    lq, lids, ld = _local(items, item_ids, queries, query_ids, k)
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(q, lq)
    if integer:
        # exact distances: the barrier stage is the JAX package's bit for
        # bit, and the local search's up to the order of a tie run
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(d, rd)
        _same_up_to_tie_order(ids, d, lids, ld, items, item_ids, queries, (q - 5) // 7)
    else:
        np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(d, ld, rtol=1e-5, atol=1e-6)
        assert (ids == rids).mean() > 0.99 and (ids == lids).mean() > 0.99


def test_generated_id_and_int64_partition_encoding():
    items, queries = _data(n_items=300, n_query=64)
    k = 5
    model = port.NearestNeighbors(k=k).fit(_fake_sdf(items))
    _, query_out, knn_df = model.kneighbors(_fake_sdf(queries))
    got = knn_df._materialize()
    assert len(got) == len(queries)
    assert set(got.columns) == {"query_unique_id", "indices", "distances"}
    qids = got["query_unique_id"].to_numpy(np.int64)
    assert (np.sort(qids) == qids).all()
    assert qids.max() >= (np.int64(1) << 33)  # the high-bit ids survive the exchange
    ref_got = ref.NearestNeighbors(k=k).fit(_fake_sdf(items)).kneighbors(_fake_sdf(queries))[2]._materialize()
    np.testing.assert_array_equal(qids, ref_got["query_unique_id"].to_numpy(np.int64))
    d = np.stack(got["distances"].to_numpy())
    assert (np.diff(d, axis=1) >= 0).all()
    np.testing.assert_allclose(d, np.stack(ref_got["distances"].to_numpy()), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.stack(got["indices"].to_numpy()), np.stack(ref_got["indices"].to_numpy()))


def _join_map(got):
    qid = np.array([int(s["row"]) for s in got["query_df"]])
    iid = np.array([int(s["row"]) for s in got["item_df"]])
    return {int(q): sorted(zip(np.asarray(got["dc"])[qid == q].astype(np.float32).tolist(), iid[qid == q].tolist()))
            for q in np.unique(qid)}


def test_exact_join_runs_on_the_cluster():
    items, queries = _data(n_items=200, n_query=40, integer=True)
    k = 4
    item_ids = np.arange(len(items), dtype=np.int64)
    query_ids = np.arange(len(queries), dtype=np.int64)
    model = port.NearestNeighbors(k=k).setIdCol("row").fit(_fake_sdf(items, item_ids))
    got = model.exactNearestNeighborsJoin(_fake_sdf(queries, query_ids), distCol="dc")._materialize()
    assert set(got.columns) == {"item_df", "query_df", "dc"} and len(got) == len(queries) * k
    ref_model = ref.NearestNeighbors(k=k).setIdCol("row").fit(_fake_sdf(items, item_ids))
    want = ref_model.exactNearestNeighborsJoin(_fake_sdf(queries, query_ids), distCol="dc")._materialize()
    assert _join_map(got) == _join_map(want)
    # the structs carry the source rows
    row = got["item_df"].iloc[0]
    np.testing.assert_array_equal(np.asarray(row["features"], np.float32), items[int(row["row"])])


def test_join_drops_the_generated_id():
    items, queries = _data(n_items=120, n_query=16)
    got = port.NearestNeighbors(k=3).fit(_fake_sdf(items)).exactNearestNeighborsJoin(_fake_sdf(queries))
    got = got._materialize()
    assert len(got) == len(queries) * 3
    assert "unique_id" not in got["item_df"].iloc[0] and "unique_id" not in got["query_df"].iloc[0]
    assert "features" in got["item_df"].iloc[0]


def test_collect_override_routes_driver_local(monkeypatch):
    monkeypatch.setenv("SRML_SPARK_COLLECT", "1")
    items, _ = _data(n_items=60, n_query=8)
    for module in (port, ref):
        with pytest.raises(Exception):
            module.NearestNeighbors(k=3).fit(_fake_sdf(items))


def test_mixed_input_types_fail_loudly():
    items, queries = _data(n_items=60, n_query=8)
    model = port.NearestNeighbors(k=3).fit(_fake_sdf(items))
    with pytest.raises(TypeError, match="pyspark"):
        model.kneighbors(port.DataFrame.from_numpy(queries))
    ref_model = ref.NearestNeighbors(k=3).fit(_fake_sdf(items))
    with pytest.raises(TypeError, match="pyspark"):
        ref_model.kneighbors(RefDataFrame.from_numpy(queries))


def test_ann_refuses_live_frames_with_the_jax_messages():
    items, queries = _data(n_items=60, n_query=8)
    messages = []
    for module in (port, ref):
        with pytest.raises(NotImplementedError) as err:
            module.ApproximateNearestNeighbors(k=3, algoParams={"nlist": 2}).fit(_fake_sdf(items))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_kneighbors_empty_rank_and_k_beyond_items(package):
    """One rank has no items and no queries and k exceeds the item count:
    the empty rank joins both control-plane rounds and every row gets
    min(k, n_items) columns."""
    fn = distributed_kneighbors if package == "port" else ref_distributed_kneighbors
    rng = np.random.default_rng(11)
    items = rng.standard_normal((12, 5)).astype(np.float32)
    queries = rng.standard_normal((7, 5)).astype(np.float32)
    shared = _SharedBarrier(3)
    res, errs = {}, []

    def run(rank):
        ctx = _FakeBarrierTaskContext(rank, shared)
        ip = [(items, np.arange(12, dtype=np.int64))] if rank == 0 else []
        qp = [(queries, np.arange(7, dtype=np.int64))] if rank == 1 else []
        try:
            res[rank] = fn(ip, qp, 50, rank, 3, ctx)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
            shared.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    assert res[0] == [] and res[2] == []
    (d, i), = res[1]
    assert d.shape == (7, 12) and i.shape == (7, 12)
    want = np.sort(np.sqrt(((queries[:, None, :] - items[None]) ** 2).sum(-1)), axis=1)
    np.testing.assert_allclose(d, want, rtol=1e-4, atol=1e-5)
    assert all(set(row) == set(range(12)) for row in i)
