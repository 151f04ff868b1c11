#
# Exact NearestNeighbors estimator/model.
#
# Counterpart of spark_rapids_ml_tpu/models/knn.py: fit only
# captures the item frame (adding a generated int64 "unique_id" column when
# idCol is unset); kneighbors returns (item_df, query_df with ids, knn_df)
# where knn_df keeps the query partitioning with columns query_<idCol>,
# indices (rows, k) int64 and distances (rows, k) float32 (euclidean, float32
# inputs); exactNearestNeighborsJoin builds the exploded join; neither
# estimator nor model is persistable.  The search is ops/knn.py over the
# mesh get_mesh(num_workers) (num_workers defaults to the length of the
# device list, device.devices()): the item set is staged once, row-sharded
# over the mesh, and cached on the model under a key that carries the mesh;
# each query partition's upload (on the mesh's first device) is cached too,
# so a repeated kneighbors call is compute-only.  Item sets beyond the
# devices' item budget stream through in blocks, one on the devices at a
# time.
#
# _serving_entry serves each padded batch as one knn_search_prepared call
# (B5 -> B7) against the item set staged by _ensure_staged_items, with the
# batch's query block padded to at least 64 rows as the JAX search buckets
# it (SERVE_MIN_QUERIES).
#
# A live pyspark item frame stays on the executors: fit keeps the frame
# (with a monotonically increasing id column when idCol is unset),
# kneighbors of a pyspark query frame runs one barrier stage over both
# (spark/adapter.run_barrier_kneighbors: each task's rows through
# ops/knn.distributed_kneighbors, B5 -> B7 in every task) and returns the
# knn frame sorted by query id, and the join is two Spark equi-joins
# (spark_knn_join).  A port query frame against a pyspark item frame is a
# TypeError; serving refuses a pyspark item frame.
#
# Not carried over: warm_search_kernels (ahead-of-time XLA compiles; the
# serving engine warms by dispatching).
#

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import _TpuEstimatorSupervised, _TpuModel
from ..dataframe import DataFrame, as_dataframe
from ..ops import knn as knn_ops
from ..ops.knn import PreparedItems
from ..parallel.mesh import Mesh, get_mesh
from ..params import HasFeaturesCol, HasFeaturesCols, Param, TypeConverters, _dummy, _TpuParams
from ..utils import materialize_feature_block

# the smallest query block a served batch is searched at (the JAX search's
# _query_block_bucket floor)
SERVE_MIN_QUERIES = 64


def serve_padded(batch: np.ndarray) -> np.ndarray:
    """A served batch zero-padded to at least SERVE_MIN_QUERIES rows."""
    if batch.shape[0] >= SERVE_MIN_QUERIES:
        return batch
    out = np.zeros((SERVE_MIN_QUERIES, batch.shape[1]), batch.dtype)
    out[: batch.shape[0]] = batch
    return out


class NearestNeighborsClass(_TpuParams):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_neighbors"}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {"n_neighbors": 5, "verbose": False, "algorithm": "brute", "metric": "euclidean"}


class _NearestNeighborsParams(NearestNeighborsClass, HasFeaturesCol, HasFeaturesCols):
    k = Param(_dummy(), "k", "the number of nearest neighbors to retrieve (> 0)", TypeConverters.toInt)
    idCol = Param(
        _dummy(), "idCol",
        "id column name; if unset a monotonically increasing id column is generated",
        TypeConverters.toString,
    )

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(k=5)

    def getK(self) -> int:
        return self.getOrDefault("k")

    def setK(self, value: int):
        return self._set_params(k=value)

    def getIdCol(self) -> str:
        return self.getOrDefault("idCol") if self.isDefined("idCol") else "unique_id"

    def setIdCol(self, value: str):
        self.set(self.getParam("idCol"), value)
        return self

    def setInputCol(self, value: Union[str, List[str]]):
        if isinstance(value, str):
            self._set_params(featuresCol=value)
        else:
            self._set_params(featuresCols=value)
        return self


class NearestNeighbors(_NearestNeighborsParams, _TpuEstimatorSupervised):
    """Exact brute-force kNN on one device or a mesh (the Spark ML
    NearestNeighbors API of spark-rapids-ml)."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._initialize_tpu_params()
        self._set_params(**kwargs)

    def _fit(self, dataset: Any) -> "NearestNeighborsModel":
        from ..core import _use_executor_path

        if getattr(dataset, "_device_features", None) is not None:
            raise NotImplementedError(
                "NearestNeighbors.fit does not take DataFrame.from_device frames (their features "
                "column is a placeholder); fit a host frame and install a device-resident index "
                "with model.seed_staging(...)"
            )
        if _use_executor_path(dataset):
            # a live pyspark frame is kept as it is: its partitions stay on
            # the executors until kneighbors runs its barrier stage
            from ..spark.adapter import ensure_id_col

            return self._model_for(ensure_id_col(dataset, self.getIdCol()))
        df = as_dataframe(dataset)
        if not self.isDefined("idCol"):
            df = df.with_row_id("unique_id")
        return self._model_for(df)

    def _model_for(self, item_df: DataFrame) -> "NearestNeighborsModel":
        """A fitted model over `item_df`, carrying this estimator's params."""
        model = NearestNeighborsModel(item_df=item_df)
        self._copyValues(model)
        model._tpu_params.update(self._tpu_params)
        model._num_workers = self._num_workers
        model._float32_inputs = self._float32_inputs
        return model

    def fit(self, dataset: Any, params: Optional[Dict] = None) -> "NearestNeighborsModel":
        return self._fit(dataset)

    def _get_tpu_fit_func(self, dataset):  # pragma: no cover
        raise NotImplementedError("NearestNeighbors overrides _fit")

    def _create_model(self, result):  # pragma: no cover
        raise NotImplementedError("NearestNeighbors overrides _fit")

    def write(self):
        raise NotImplementedError(
            "NearestNeighbors does not support saving/loading, just re-create the estimator."
        )

    @classmethod
    def read(cls):
        raise NotImplementedError(
            "NearestNeighbors does not support saving/loading, just re-create the estimator."
        )


class NearestNeighborsModel(_NearestNeighborsParams, _TpuModel):
    def __init__(self, item_df: Optional[DataFrame] = None, **kwargs: Any) -> None:
        super().__init__()
        self._item_df = item_df
        # the staged item set (key, PreparedItems) when it fits the device's
        # item budget, and each query partition's upload keyed by partition
        # index (host array pinned, so its identity cannot be recycled);
        # both die with the model
        self._staged_items: Optional[Tuple[Any, PreparedItems]] = None
        self._staged_queries: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}

    def _iter_item_blocks(self, id_col: str, mesh: Mesh, block_rows: Optional[int] = None):
        """Prepared item blocks over the item partitions: the host holds one
        block's partitions at most."""
        input_col, input_cols = self._get_input_columns()

        def parts():
            for part in self._item_df.partitions:
                if len(part) == 0:
                    continue
                yield (
                    materialize_feature_block(part, input_col, input_cols, np.dtype(np.float32)),
                    np.asarray(part[id_col], np.int64),
                )

        return knn_ops.iter_prepared_item_blocks(parts(), mesh, block_rows)

    def kneighbors(self, query_df: Any) -> Tuple[DataFrame, DataFrame, DataFrame]:
        """Exact k nearest item neighbours of every query row, float32
        euclidean.  Returns (item_df, query_df with the id column,
        knn_df)."""
        assert self._item_df is not None, "fit() must be called before kneighbors"
        from ..core import _is_pyspark_dataframe

        if _is_pyspark_dataframe(self._item_df):
            # the executor route: query blocks and candidate lists move
            # between the barrier tasks; item rows never leave theirs
            if not _is_pyspark_dataframe(query_df):
                raise TypeError(
                    "the fitted item dataframe is a live pyspark DataFrame; "
                    "kneighbors requires a pyspark query DataFrame too"
                )
            from ..spark.adapter import ensure_id_col, infer_spark_num_workers, run_barrier_kneighbors

            id_col = self.getIdCol()
            qdf_spark = ensure_id_col(query_df, id_col)
            input_col, input_cols = self._get_input_columns()
            num_workers = infer_spark_num_workers(self, query_df.sparkSession)
            knn_df = run_barrier_kneighbors(
                self._item_df, qdf_spark, self.getK(), id_col, input_col, input_cols, num_workers
            )
            return self._item_df, qdf_spark, knn_df
        mesh = get_mesh(self.num_workers)  # raises without CUDA unless a device list was requested
        qdf = as_dataframe(query_df)
        id_col = self.getIdCol()
        if id_col not in qdf.columns:
            qdf = qdf.with_row_id(id_col)
        input_col, input_cols = self._get_input_columns()
        q_parts = list(qdf.partitions)
        k = self.getK()

        def query_feats(p: int) -> np.ndarray:
            return materialize_feature_block(q_parts[p], input_col, input_cols, np.dtype(np.float32))

        per_part = self._search_partitions(id_col, mesh, q_parts, query_feats, k)
        out_parts = [
            {f"query_{id_col}": np.asarray(part[id_col], np.int64) if len(part) else np.zeros(0, np.int64),
             "indices": np.asarray(ids, np.int64),
             "distances": np.asarray(dists, np.float32)}
            for part, (dists, ids) in zip(q_parts, per_part)
        ]
        return self._item_df, qdf, DataFrame(out_parts)

    def _search_partitions(self, id_col, mesh, q_parts, query_feats, k):
        """Exact search of every query partition.  An item set within the
        budget is staged once and cached (a repeat call pays only compute);
        a larger one streams through knn_search_streamed."""
        rows = [len(p) for p in q_parts]
        if not any(rows):
            k_eff = min(k, self._item_df.count())
            return [(np.zeros((r, k_eff), np.float32), np.zeros((r, k_eff), np.int64)) for r in rows]
        prepared = self._stage_in_core_items(id_col, mesh)
        if prepared is None:
            return knn_ops.knn_search_streamed(self._iter_item_blocks(id_col, mesh), query_feats, rows, k)
        k_eff = min(k, prepared.n_items)
        out = []
        for p, n_rows in enumerate(rows):
            if n_rows == 0:
                out.append((np.zeros((0, k_eff), np.float32), np.zeros((0, k_eff), np.int64)))
                continue
            out.append(knn_ops.knn_search_prepared(prepared, self._staged_query(p, query_feats(p), mesh.devices[0]), k))
        return out

    def _stage_in_core_items(self, id_col: str, mesh: Mesh) -> Optional[PreparedItems]:
        """The item set staged over the mesh and cached on the model, or None
        when it is more than one item block may hold (the caller streams).
        A cached set of another frame or mesh is dropped before the room is
        measured."""
        rows = self._item_df.count()
        dim = self._frame_dim()
        key = None if dim is None else self._staging_key(mesh, rows, dim)
        if self._staged_items is not None and self._staged_items[0] == key:
            return self._staged_items[1]
        self._staged_items = None
        self._staged_queries.clear()
        if dim is None:
            return None
        block_rows = knn_ops._item_block_rows(dim, mesh)
        if rows > block_rows:
            return None
        (prepared,) = self._iter_item_blocks(id_col, mesh, block_rows)
        self._staged_items = (key, prepared)
        return prepared

    def _ensure_staged_items(self, mesh: Mesh) -> PreparedItems:
        """The staged item set of the serving path: kneighbors' staging and
        cache, but an item set past one item block is an error here (an
        online server never streams the index a batch)."""
        from ..core import _is_pyspark_dataframe

        if self._item_df is None:
            raise ValueError("fit() must be called before serving")
        if _is_pyspark_dataframe(self._item_df):
            raise ValueError(
                "serving requires an in-process item frame; collect the pyspark item dataframe "
                "(SRML_SPARK_COLLECT=1) before registering the model"
            )
        prepared = self._stage_in_core_items(self.getIdCol(), mesh)
        if prepared is None:
            raise ValueError("the item set is larger than one item block of the devices; out-of-core item sets "
                             "are kneighbors-only")
        return prepared

    def _serving_entry(self, mesh: Any = None):
        """Online inference hook (serving/): each padded batch is ONE
        knn_search_prepared call against the staged item set, its query
        block at least SERVE_MIN_QUERIES rows."""
        from ..ops import precompile
        from ..serving.entry import HostStaging, ServingEntry

        mesh = mesh if mesh is not None else get_mesh(self.num_workers)
        prepared = self._ensure_staged_items(mesh)
        dev = prepared.shards[0].items.device
        dtype = np.dtype(np.float32)
        dim = prepared.n_cols
        k = self.getK()
        staging = HostStaging(dev, dtype)

        def key(rows: int):
            return precompile.warm_key("serve.knn", max(rows, SERVE_MIN_QUERIES), dtype, dev)

        def call(batch: np.ndarray) -> Dict[str, np.ndarray]:
            precompile.dispatch(key(batch.shape[0]))
            dists, ids = knn_ops.knn_search_prepared(prepared, staging.upload(serve_padded(batch)), k)
            n = batch.shape[0]
            return {"indices": ids[:n], "distances": dists[:n].astype(np.float32)}

        return ServingEntry(
            name="serve.knn",
            n_cols=int(dim),
            dtype=dtype,
            out_cols=["indices", "distances"],
            call=call,
            warm=lambda buckets: [key(b) for b in buckets],
            info={"k": int(min(k, prepared.n_items)), "n_items": int(prepared.n_items),
                  "exchange_route": knn_ops._exchange_route(mesh)},
            device=dev,
        )

    def _frame_dim(self) -> Optional[int]:
        """Feature dimension of the item frame (None when it has no rows)."""
        parts = [p for p in self._item_df.partitions if len(p)]
        if not parts:
            return None
        input_col, input_cols = self._get_input_columns()
        return parts[0][input_col].shape[1] if input_col is not None else len(input_cols)

    def _staging_key(self, mesh: Mesh, rows: int, dim: int):
        """Identity of the staged item set, shared by the lookup and
        seed_staging: the frame, the mesh it is sharded over, its shape."""
        return (tuple(id(p) for p in self._item_df.partitions), mesh, rows, dim)

    def seed_staging(self, prepared: PreparedItems,
                     query_blocks: Optional[Dict[int, Tuple[np.ndarray, torch.Tensor]]] = None) -> None:
        """Install an already device-resident item set (ops.knn.PreparedItems)
        and optionally per-query-partition (host features, device tensor)
        pairs as this model's staging caches: later kneighbors calls are
        compute-only."""
        rows = self._item_df.count()
        dim = self._frame_dim()
        if dim is None:
            raise ValueError("cannot seed staging for an empty item frame")
        if prepared.n_cols != dim:
            raise ValueError(f"prepared item columns ({prepared.n_cols}) != the frame's feature dim ({dim})")
        if prepared.n_items != rows:
            raise ValueError(f"prepared item count ({prepared.n_items}) != the frame's row count ({rows})")
        self._staged_items = (self._staging_key(prepared.mesh, rows, dim), prepared)
        self._staged_queries.clear()
        if query_blocks:
            self._staged_queries.update(query_blocks)

    def _staged_query(self, p: int, feats: np.ndarray, dev: torch.device) -> Union[np.ndarray, torch.Tensor]:
        """Query partition p on the device, uploaded once and cached; the
        host array itself (uploaded block by block by the search) when it is
        more than the device can hold beside the items and the search."""
        ent = self._staged_queries.get(p)
        if ent is not None and ent[0] is feats and tuple(ent[1].shape) == feats.shape and ent[1].device == dev:
            return ent[1]
        if feats.nbytes > knn_ops._item_budget_bytes(dev):
            return feats
        staged = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(dev)
        self._staged_queries[p] = (feats, staged)
        return staged

    def exactNearestNeighborsJoin(self, query_df: Any, distCol: str = "distCol") -> DataFrame:
        """Exploded kNN join: one row per (query, neighbour) with columns
        item_df and query_df (dicts of the source rows; a generated id column
        is left out) and distCol (float64), in the query frame's
        partitioning."""
        from ..core import _is_pyspark_dataframe

        id_col = self.getIdCol()
        item_df, query_df_withid, knn_df = self.kneighbors(query_df)
        drop_generated = not self.isDefined("idCol")
        if _is_pyspark_dataframe(item_df):
            # two Spark equi-joins on the executors; nothing is collected
            from ..spark.adapter import spark_knn_join

            return spark_knn_join(item_df, query_df_withid, knn_df, id_col, distCol, drop_generated)
        ind = np.concatenate([p["indices"] for p in knn_df.partitions])
        k = ind.shape[1] if ind.ndim == 2 else 0
        qids = np.concatenate([p[f"query_{id_col}"] for p in knn_df.partitions])
        i_structs = _structs(item_df, id_col, ind.ravel(), drop_generated)
        q_structs = _structs(query_df_withid, id_col, qids, drop_generated)
        dist = np.concatenate([p["distances"] for p in knn_df.partitions]).astype(np.float64)
        cols = {"item_df": i_structs, "query_df": np.repeat(q_structs, k), distCol: dist.ravel()}
        bounds = np.linspace(0, len(i_structs), max(1, query_df_withid.num_partitions) + 1, dtype=int)
        return DataFrame([{c: v[lo:hi] for c, v in cols.items()} for lo, hi in zip(bounds[:-1], bounds[1:])])

    def _get_tpu_transform_func(self, dataset):  # pragma: no cover
        raise NotImplementedError("NearestNeighborsModel has no transform; use kneighbors instead.")

    def write(self):
        raise NotImplementedError(
            "NearestNeighborsModel does not support saving/loading, just re-fit the estimator to re-create a model."
        )

    @classmethod
    def read(cls):
        raise NotImplementedError(
            "NearestNeighborsModel does not support saving/loading, just re-fit the estimator to re-create a model."
        )


def _structs(df: DataFrame, id_col: str, wanted: np.ndarray, drop_id: bool) -> np.ndarray:
    """One dict per wanted id: the row of `df` holding that id (without the
    id column when drop_id), looked up partition by partition, so the
    frame's columns are never concatenated."""
    parts = df.partitions
    ids = np.concatenate([p[id_col] for p in parts])
    starts = np.cumsum([0] + [len(p) for p in parts])
    order = np.argsort(ids, kind="stable")
    at = order[np.minimum(np.searchsorted(ids[order], wanted), max(len(ids) - 1, 0))] if len(ids) else wanted
    if len(wanted) and (len(ids) == 0 or not np.array_equal(ids[at], wanted)):
        raise ValueError("the kNN result names ids that its frames do not hold")
    names = [c for c in df.columns if not (drop_id and c == id_col)]
    part_of = np.searchsorted(starts, at, side="right") - 1
    out = np.empty(len(wanted), dtype=object)
    out[:] = [{c: parts[pi][c][r - starts[pi]] for c in names} for pi, r in zip(part_of, at)]
    return out
