#
# pyspark DataFrame -> facade conversion, and the Spark barrier-mode runner.
#
# Counterpart of spark_rapids_ml_tpu/spark/adapter.py: the layer that lets
# the port ride a Spark cluster.  fit of a live pyspark DataFrame
# repartitions it to the worker count and runs a barrier-mode mapInPandas
# stage; each barrier task is one rank of parallel/runner.
# run_distributed_fit, its control plane the task's BarrierTaskContext
# (SparkBarrierControlPlane), so torch.distributed bootstraps through
# allGather as the JAX package bootstraps jax.distributed.  transform,
# _transformEvaluate, the evaluators and kneighbors run on the executors in
# the same way: the dataset is never collected to the driver, only model
# payloads, metric rows and (queries, k) candidate lists move.  pyspark is
# imported only inside these functions.
#
# Departures from the JAX module:
#   - the stage-level resource is the card: "gpu"
#     (spark.executor.resource.gpu.amount / spark.task.resource.gpu.amount,
#     what a GPU Spark cluster advertises) where the JAX module reads "tpu";
#     the decision table is otherwise the JAX module's;
#   - a UDF reads each mapInPandas batch through dataframe.partition_of and
#     answers through _batch, the two places that tell a pandas frame (what
#     pyspark hands a UDF) from a port Partition (what a stand-in of the
#     pyspark surface that runs without pandas hands it); no other code here
#     knows the difference.
# The model payload (serialize_model) is the JAX module's wire letter for
# letter (runner.encode_attrs), so a payload the JAX adapter serialized
# decodes here (core._resolve_class maps its class names).
#

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Mapping

import numpy as np

from ..dataframe import Partition, partition_of


def spark_to_facade(sdf: Any) -> Any:
    """Collect a pyspark DataFrame into the local partitioned facade (the
    driver-local route, SRML_SPARK_COLLECT=1); the cluster routes below
    never collect."""
    from ..dataframe import DataFrame

    n_parts = max(1, sdf.rdd.getNumPartitions())
    return DataFrame.from_pandas(sdf.toPandas(), num_partitions=n_parts)


def _batch(like: Any, cols: Mapping[str, Any], keep: bool = False) -> Any:
    """A UDF's output batch of the kind of its input batch `like`: a port
    Partition for a Partition, else a pandas frame (a 2-D block, or an
    empty column, as per-row cells).  With keep, `like`'s own columns come
    first and `cols` are appended (or replace those of the same name)."""
    if isinstance(like, Partition):
        return like.with_columns(cols) if keep else Partition(cols)
    import pandas as pd

    cells = {k: list(v) if isinstance(v, np.ndarray) and (v.ndim == 2 or len(v) == 0) else v
             for k, v in cols.items()}
    if not keep:
        return pd.DataFrame(cells)
    out = like.copy()
    for name, values in cells.items():
        out[name] = values
    return out


class SparkBarrierControlPlane:
    """Control plane over pyspark's BarrierTaskContext."""

    def __init__(self, barrier_ctx: Any):
        self._ctx = barrier_ctx

    def allGather(self, message: str) -> List[str]:
        return self._ctx.allGather(message)

    def barrier(self) -> None:
        self._ctx.barrier()


RESOURCE_NAME = "gpu"


def skip_stage_level_scheduling(spark_version: str, conf_get: Callable[[str], Any]) -> str:
    """Whether to SKIP stage-level resource scheduling for the training
    barrier stage: the reason, or '' to use it.  `conf_get` takes a conf key
    and returns its value or None, so the table is testable on a dict."""
    if str(spark_version) < "3.4.0":
        return "requires spark 3.4.0+"
    master = conf_get("spark.master") or ""
    if not (master.startswith("spark://") or master.startswith("local-cluster")):
        return "requires standalone or local-cluster mode"
    executor_cores = conf_get("spark.executor.cores")
    executor_gpus = conf_get(f"spark.executor.resource.{RESOURCE_NAME}.amount")
    if executor_cores is None or executor_gpus is None:
        return f"requires spark.executor.cores and spark.executor.resource.{RESOURCE_NAME}.amount"
    if int(executor_cores) == 1:
        return "requires spark.executor.cores > 1"
    if int(executor_gpus) > 1:
        # one executor drives one card; more means the user places tasks
        return f"executor {RESOURCE_NAME} amount > 1 is user-managed"
    task_gpus = conf_get(f"spark.task.resource.{RESOURCE_NAME}.amount")
    if task_gpus is None:
        # ETL tasks do not take the card; the training stage claims it
        return ""
    if float(task_gpus) == float(executor_gpus):
        return "task already claims the whole executor resource"
    return ""


def try_stage_level_scheduling(rdd: Any, spark: Any, logger: Any = None) -> Any:
    """Attach a training resource profile to the barrier RDD: each training
    task claims the executor's card and more than half its cores, so one
    training task runs per executor."""
    sc = spark.sparkContext
    reason = skip_stage_level_scheduling(spark.version, sc.getConf().get)
    if reason:
        if logger:
            logger.info(f"stage-level scheduling skipped: {reason}")
        return rdd
    from pyspark.resource.profile import ResourceProfileBuilder
    from pyspark.resource.requests import TaskResourceRequests

    executor_cores = int(sc.getConf().get("spark.executor.cores"))
    task_cores = executor_cores // 2 + 1
    treqs = TaskResourceRequests().cpus(task_cores).resource(RESOURCE_NAME, 1.0)
    profile = ResourceProfileBuilder().require(treqs).build
    if logger:
        logger.info(f"training tasks require cores={task_cores}, {RESOURCE_NAME}=1.0")
    return rdd.withResources(profile)


def run_barrier_fit(
    sdf: Any,
    num_workers: int,
    fit_closure: Callable[[List[Any], int, int, Any], List[Dict[str, Any]]],
) -> List[Dict[str, Any]]:
    """Run `fit_closure(batches, rank, nranks, control_plane)` in a barrier
    stage of `num_workers` tasks; it returns JSON-safe encoded attribute
    dicts (runner.encode_attrs), and rank 0's are collected."""
    from pyspark import BarrierTaskContext

    sdf = sdf.repartition(num_workers)

    def _train_udf(iterator):
        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        cp = SparkBarrierControlPlane(ctx)
        parts = [pdf for pdf in iterator]
        results = fit_closure(parts, rank, num_workers, cp)
        ctx.barrier()
        if rank == 0:
            like = parts[0] if parts else None
            for attrs in results:
                yield _batch(like, {"model_attributes": np.array([json.dumps(attrs)], dtype=object)})

    rdd = sdf.mapInPandas(_train_udf, schema="model_attributes string").rdd.barrier().mapPartitions(lambda x: x)
    rdd = try_stage_level_scheduling(rdd, sdf.sparkSession)
    rows = rdd.collect()
    return [json.loads(r["model_attributes"]) for r in rows]


NUM_WORKERS_CONF = "spark.rapids.ml.tpu.numWorkers"


def infer_spark_num_workers(estimator: Any, spark: Any) -> int:
    """Barrier tasks (ranks) of a cluster fit: one a worker process.  The
    estimator's num_workers is not read: it counts mesh devices elsewhere.
    Order: the conf spark.rapids.ml.tpu.numWorkers, then
    spark.executor.instances, then 1 (with a log line)."""
    conf_get = spark.sparkContext.getConf().get
    own = conf_get(NUM_WORKERS_CONF)
    if own is not None:
        return int(own)
    instances = conf_get("spark.executor.instances")
    if instances is not None and int(instances) > 0:
        return int(instances)
    from ..utils import get_logger

    get_logger(infer_spark_num_workers).info(
        "cannot infer cluster worker count (set num_workers or %s); training with a single barrier task",
        NUM_WORKERS_CONF,
    )
    return 1


# -- executor-side inference -------------------------------------------------
# transform / _transformEvaluate of a live pyspark DataFrame run as
# mapInPandas on the executors with the model in the task closure.


def serialize_model(model: Any) -> Dict[str, Any]:
    """JSON-safe {metadata, attrs} payload of a model (arrays base64 through
    the runner's codec), small enough for a task closure."""
    from ..core import _params_metadata
    from ..parallel.runner import encode_attrs

    return {"metadata": _params_metadata(model), "attrs": encode_attrs(model._get_model_attributes())}


def deserialize_model(payload: Dict[str, Any]) -> Any:
    from ..core import _apply_params_metadata, _resolve_class
    from ..parallel.runner import decode_attrs

    cls = _resolve_class(payload["metadata"]["class"])
    model = cls._construct(decode_attrs(payload["attrs"]))
    _apply_params_metadata(payload["metadata"], model)
    return model


def transform_output_ddl(model: Any, sdf: Any) -> str:
    """The mapInPandas output schema: every input field plus the model's
    output columns, as a DDL string built from the frame's own
    simpleString()s (no pyspark type imports)."""
    out_fields = dict(model._out_schema_fields())
    # an input column named as an output column is replaced, type included
    fields = [f"`{f.name}` {out_fields.get(f.name, f.dataType.simpleString())}" for f in sdf.schema.fields]
    existing = {f.name for f in sdf.schema.fields}
    for name, ddl in out_fields.items():
        if name not in existing:
            fields.append(f"`{name}` {ddl}")
    return ", ".join(fields)


def _cast_vector_col(sdf: Any, input_col: str) -> Any:
    """A VectorUDT features column cast to array<double>, which Arrow can
    ship to the executors."""
    for f in sdf.schema.fields:
        if f.name == input_col and f.dataType.simpleString() == "vector":
            from pyspark.ml.functions import vector_to_array
            from pyspark.sql.functions import col

            return sdf.withColumn(input_col, vector_to_array(col(input_col)))
    return sdf


def _prepare_features_for_arrow(model: Any, sdf: Any) -> Any:
    input_col, _ = model._get_input_columns()
    if input_col is None:
        return sdf
    return _cast_vector_col(sdf, input_col)


def executor_transform(model: Any, sdf: Any) -> Any:
    """model.transform(pyspark_df) batch by batch on the executors: a lazy
    mapInPandas frame with the output columns appended."""
    sdf = _prepare_features_for_arrow(model, sdf)
    payload = serialize_model(model)
    schema = transform_output_ddl(model, sdf)
    out_fields = model._out_schema_fields()

    def _predict_udf(iterator):
        from ..core import extract_partition_features

        m = deserialize_model(payload)
        fn = m._get_tpu_transform_func(None)
        input_col, input_cols = m._get_input_columns()
        dtype = m._transform_dtype(m._model_attributes.get("dtype"))
        casts = dict(out_fields)
        for batch in iterator:
            if len(batch) == 0:
                yield _batch(batch, {n: np.zeros(0, np.int32 if t == "int" else np.float64)
                                     for n, t in out_fields}, keep=True)
                continue
            feats = extract_partition_features(
                batch, input_col, input_cols, dtype, densify_sparse=not m._supports_sparse_input
            )
            out = {}
            for name, values in fn(feats).items():
                if isinstance(values, np.ndarray) and values.ndim == 2:
                    out[name] = values
                elif casts.get(name) == "int":
                    out[name] = np.asarray(values, dtype=np.int32)
                else:
                    out[name] = np.asarray(values, dtype=np.float64)
            yield _batch(batch, out, keep=True)

    return sdf.mapInPandas(_predict_udf, schema=schema)


def executor_transform_evaluate(model: Any, sdf: Any, evaluator: Any, num_models: int) -> List[float]:
    """_transformEvaluate of a live pyspark DataFrame: each batch's
    mergeable metric partials, one JSON row a model tagged with its index,
    computed on the executors and merged and scored on the driver."""
    from ..evaluation import MulticlassClassificationEvaluator, RegressionEvaluator
    from ..metrics.multiclass import MulticlassMetrics
    from ..metrics.regression import RegressionMetrics

    if isinstance(evaluator, MulticlassClassificationEvaluator):
        metrics_cls: Any = MulticlassMetrics
    elif isinstance(evaluator, RegressionEvaluator):
        metrics_cls = RegressionMetrics
    else:
        raise NotImplementedError(f"{evaluator} is unsupported yet.")
    label_col = model.getOrDefault("labelCol")
    if label_col not in sdf.columns:
        raise RuntimeError("Label column is not existing.")
    sdf = _prepare_features_for_arrow(model, sdf)
    payload = serialize_model(model)

    def _metrics_udf(iterator):
        m = deserialize_model(payload)
        predict_all = m._get_eval_predict_func()  # staged once a task
        for batch in iterator:
            if len(batch) == 0:
                continue
            rows = [
                json.dumps(metric.to_row(i))
                for i, metric in enumerate(m._partition_metrics(batch, evaluator, num_models, predict_all))
            ]
            yield _batch(batch, {"metrics_json": np.array(rows, dtype=object)})

    rows = [json.loads(r["metrics_json"]) for r in sdf.mapInPandas(_metrics_udf, schema="metrics_json string").collect()]
    metrics = metrics_cls._from_rows(num_models, rows)
    return [m.evaluate(evaluator) for m in metrics]


def executor_evaluate(sdf: Any, evaluator: Any) -> float:
    """Evaluator.evaluate of a live pyspark prediction frame: each task's
    merged metric partials (a few numbers) leave the executors, merged and
    scored on the driver."""
    from ..evaluation import (
        BinaryClassificationEvaluator,
        ClusteringEvaluator,
        MulticlassClassificationEvaluator,
        RegressionEvaluator,
    )
    from ..metrics.binary import BinaryClassificationMetrics
    from ..metrics.multiclass import MulticlassMetrics
    from ..metrics.regression import RegressionMetrics

    if isinstance(evaluator, ClusteringEvaluator):
        return _executor_evaluate_clustering(sdf, evaluator)
    if isinstance(evaluator, MulticlassClassificationEvaluator):
        metrics_cls: Any = MulticlassMetrics
    elif isinstance(evaluator, RegressionEvaluator):
        metrics_cls = RegressionMetrics
    elif isinstance(evaluator, BinaryClassificationEvaluator):
        metrics_cls = BinaryClassificationMetrics
    else:
        raise NotImplementedError(f"{evaluator} is unsupported yet.")

    def _metrics_udf(iterator):
        m, like = None, None
        for batch in iterator:
            if len(batch) == 0:
                continue
            like = batch
            # the one per-batch extraction the local evaluate loop uses too
            mm = evaluator._partial_metrics_frame(partition_of(batch))
            m = mm if m is None else m.merge(mm)
        if m is not None:
            yield _batch(like, {"metrics_json": np.array([json.dumps(m.to_row(0))], dtype=object)})

    rows = [json.loads(r["metrics_json"]) for r in sdf.mapInPandas(_metrics_udf, schema="metrics_json string").collect()]
    assert rows, "empty dataset"
    return metrics_cls._from_rows(1, rows)[0].evaluate(evaluator)


def _executor_evaluate_clustering(sdf: Any, evaluator: Any) -> float:
    """The two-pass silhouette on the executors (metrics/clustering.py):
    pass 1 collects each task's cluster statistics (ClusterStats.merge pads
    the cluster ids, so no separate round for k), pass 2 ships the merged
    statistics back in the closure and collects one (sum, count) pair a
    task.  The frame is cached across the passes (a lazy transform would run
    twice)."""
    from ..metrics.clustering import ClusterStats, silhouette_partial

    feat_col = evaluator.getOrDefault("featuresCol")
    pred_col = evaluator.getOrDefault("predictionCol")

    def _cols(batch):
        part = partition_of(batch)
        block = part[feat_col]
        feats = np.asarray(block.toarray() if hasattr(block, "tocsr") else block, np.float64)
        return feats, np.asarray(part[pred_col])

    def _stats_udf(iterator):
        st, like = None, None
        for batch in iterator:
            if len(batch) == 0:
                continue
            like = batch
            feats, preds = _cols(batch)
            s = ClusterStats.from_arrays(feats, preds, int(preds.max()) + 1)
            st = s if st is None else st.merge(s)
        if st is not None:
            yield _batch(like, {"stats_json": np.array([json.dumps(st.to_row())], dtype=object)})

    sdf = sdf.cache()
    try:
        stats = ClusterStats.merge_rows(
            [json.loads(r["stats_json"]) for r in sdf.mapInPandas(_stats_udf, schema="stats_json string").collect()]
        )
        if int((stats.n > 0).sum()) < 2:
            raise AssertionError("Number of clusters must be greater than one.")

        def _sil_udf(iterator):
            tot, cnt, like = 0.0, 0, None
            for batch in iterator:
                if len(batch) == 0:
                    continue
                like = batch
                t, c = silhouette_partial(*_cols(batch), stats)
                tot += t
                cnt += c
            if cnt:
                yield _batch(like, {"s": np.array([tot], np.float64), "n": np.array([cnt], np.int64)})

        parts = sdf.mapInPandas(_sil_udf, schema="s double, n long").collect()
        total = sum(r["s"] for r in parts)
        count = sum(r["n"] for r in parts)
        return total / max(count, 1)
    finally:
        sdf.unpersist()


# -- executor-side kneighbors ------------------------------------------------
# The item and query frames are tagged, unioned and dispatched as ONE barrier
# stage; each task splits its rows back into items and queries and runs
# ops.knn.distributed_kneighbors over its BarrierTaskContext.  Only query
# blocks and (queries, k) candidate lists cross tasks; nothing is collected.

_KNN_MARKER = "__srml_knn_is_item__"


def ensure_id_col(sdf: Any, id_col: str) -> Any:
    """`sdf` with a monotonically increasing id column when `id_col` is
    absent."""
    if id_col in sdf.columns:
        return sdf
    from pyspark.sql.functions import monotonically_increasing_id

    return sdf.withColumn(id_col, monotonically_increasing_id())


def _rows_where(part: Partition, sel: np.ndarray) -> Partition:
    """The rows of `part` where `sel` holds (the partition itself when every
    row does: no copy)."""
    if sel.all():
        return part
    return Partition({c: part[c][sel] for c in part.columns})


def run_barrier_kneighbors(
    item_sdf: Any,
    query_sdf: Any,
    k: int,
    id_col: str,
    input_col: Any,
    input_cols: Any,
    num_workers: int,
) -> Any:
    """Exact kneighbors in a barrier stage: the knn pyspark DataFrame
    (query_<id>, indices, distances) sorted by query id."""
    from pyspark import BarrierTaskContext
    from pyspark.sql.functions import lit

    feat_cols = [input_col] if input_col is not None else list(input_cols)

    def _side(sdf: Any, is_item: bool) -> Any:
        if input_col is not None:
            sdf = _cast_vector_col(sdf, input_col)
        return sdf.select(*feat_cols, id_col).withColumn(_KNN_MARKER, lit(1 if is_item else 0))

    union = _side(item_sdf, True).union(_side(query_sdf, False)).repartition(num_workers)

    def _knn_udf(iterator):
        from ..core import extract_partition_features
        from ..ops.knn import distributed_kneighbors

        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        cp = SparkBarrierControlPlane(ctx)
        item_parts, query_parts, like = [], [], None
        for batch in iterator:
            if len(batch) == 0:
                continue
            like = batch
            part = partition_of(batch)
            mask = np.asarray(part[_KNN_MARKER]) == 1
            for is_item, sel in ((True, mask), (False, ~mask)):
                if not sel.any():
                    continue
                rows = _rows_where(part, sel)
                feats = extract_partition_features(rows, input_col, input_cols, np.float32)
                ids = np.asarray(rows[id_col], np.int64)
                (item_parts if is_item else query_parts).append((feats, ids))
        results = distributed_kneighbors(item_parts, query_parts, k, rank, num_workers, cp)
        ctx.barrier()
        for (d, ids), (_, qids) in zip(results, query_parts):
            yield _batch(like, {
                f"query_{id_col}": qids,
                "indices": np.asarray(ids, np.int64),
                "distances": np.asarray(d, np.float32),
            })

    out_schema = f"query_{id_col} bigint, indices array<bigint>, distances array<float>"
    rdd = union.mapInPandas(_knn_udf, schema=out_schema).rdd.barrier().mapPartitions(lambda it: it)
    rdd = try_stage_level_scheduling(rdd, item_sdf.sparkSession)
    knn_df = item_sdf.sparkSession.createDataFrame(rdd, schema=out_schema)
    return knn_df.sort(f"query_{id_col}")


def _records(batch: Any, names: List[str]) -> List[Dict[str, Any]]:
    """One dict of the `names` columns a row (a vector cell as its row of
    the column's block)."""
    part = partition_of(batch, names)
    return [{n: part[n][r] for n in names} for r in range(len(part))]


def _struct_frame(sdf: Any, struct_name: str, id_col: str, join_col: str, drop_id: bool) -> Any:
    """(join_col bigint, struct_name struct<every column>) built batch by
    batch, the struct a per-row dict typed by the DDL of the frame's own
    schema.  VectorUDT columns are cast to array<double> first (Arrow cannot
    ship a UDT, and 'vector' is no DDL)."""
    for f in list(sdf.schema.fields):
        if f.dataType.simpleString() == "vector":
            sdf = _cast_vector_col(sdf, f.name)
    fields = [(f.name, f.dataType.simpleString()) for f in sdf.schema.fields]
    keep = [(n, t) for n, t in fields if not (drop_id and n == id_col)]
    ddl = f"{join_col} bigint, {struct_name} struct<" + ",".join(f"{n}:{t}" for n, t in keep) + ">"
    names = [n for n, _ in keep]

    def _mk(iterator):
        for batch in iterator:
            if len(batch) == 0:
                continue
            structs = np.empty(len(batch), dtype=object)
            structs[:] = _records(batch, names)
            yield _batch(batch, {
                join_col: np.asarray(partition_of(batch, [id_col])[id_col], np.int64),
                struct_name: structs,
            })

    return sdf.mapInPandas(_mk, schema=ddl)


def spark_knn_join(
    item_df: Any,
    query_df: Any,
    knn_df: Any,
    id_col: str,
    dist_col: str,
    drop_generated_id: bool,
) -> Any:
    """exactNearestNeighborsJoin of live pyspark frames: the knn pairs
    exploded batch by batch, then two Spark equi-joins against the
    struct-packed item and query frames.  Nothing is collected."""
    qcol, icol = f"query_{id_col}", f"item_{id_col}"

    def _explode(iterator):
        for batch in iterator:
            if len(batch) == 0:
                continue
            part = partition_of(batch, [qcol, "indices", "distances"])
            ind = np.asarray(part["indices"], np.int64)
            dist = np.asarray(part["distances"], np.float32)
            if ind.ndim != 2 or ind.shape[1] == 0:
                continue
            kk = ind.shape[1]
            yield _batch(batch, {
                qcol: np.repeat(part[qcol], kk),
                icol: ind.ravel(),
                dist_col: dist.ravel(),
            })

    pair = knn_df.mapInPandas(_explode, schema=f"{qcol} bigint, {icol} bigint, {dist_col} float")
    item_struct = _struct_frame(item_df, "item_df", id_col, icol, drop_generated_id)
    query_struct = _struct_frame(query_df, "query_df", id_col, qcol, drop_generated_id)
    out = pair.join(item_struct, on=icol).join(query_struct, on=qcol)
    return out.select("item_df", "query_df", dist_col)


def barrier_fit_estimator(estimator: Any, sdf: Any, extra_params: Any = None) -> List[Dict[str, Any]]:
    """fit() of a live pyspark DataFrame: the fit runs inside the executors
    in a barrier stage, one rank a task (runner.run_distributed_fit), never
    collecting the dataset.  Returns the decoded model-attribute dicts."""
    from ..parallel import runner

    num_workers = infer_spark_num_workers(estimator, sdf.sparkSession)
    # an estimator that cannot fit across processes either runs as one
    # barrier task (_cluster_fit_single_task: UMAP samples, coalesces to one
    # task and fits there; inference stays distributed) or fails here, on
    # the driver, not as N task tracebacks
    if num_workers > 1 and not getattr(estimator, "_supports_multicontroller_fit", True):
        if getattr(estimator, "_cluster_fit_single_task", False):
            from ..utils import get_logger

            if estimator.hasParam("sample_fraction") and estimator.getOrDefault("sample_fraction") < 1.0:
                # sample with Spark before the coalesce, so only the sampled
                # rows travel to the one fit task
                frac = float(estimator.getOrDefault("sample_fraction"))
                seed = estimator._tpu_params.get("random_state")
                sdf = sdf.sample(fraction=frac, seed=int(seed) & 0x7FFFFFFF if seed is not None else None)
                estimator = estimator.copy({estimator.getParam("sample_fraction"): 1.0})
            get_logger(type(estimator)).info(
                "%s fits on a single worker; running a 1-task barrier stage (inference remains distributed)",
                type(estimator).__name__,
            )
            num_workers = 1
        else:
            raise NotImplementedError(
                f"{type(estimator).__name__} does not yet support "
                "multi-process (barrier) training. Train with num_workers=1 "
                "or SRML_SPARK_COLLECT=1 (driver-local fit)."
            )

    def _closure(partitions, rank, nranks, control_plane):
        parts = [partition_of(p) for p in partitions]
        return runner.run_distributed_fit(estimator, parts, rank, nranks, control_plane, extra_params=extra_params)

    rows = run_barrier_fit(sdf, num_workers, _closure)
    return [runner.decode_attrs(r) for r in rows]
