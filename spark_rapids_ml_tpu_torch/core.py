#
# Core estimator/model machinery: row-sharded ingest, fit dispatch, transform
# dispatch, persistence.
#
# Counterpart of spark_rapids_ml_tpu/core.py.  Ingest shards the rows over the
# mesh get_mesh(num_workers) (parallel/mesh.py; num_workers None: every
# device of the entry points' device list): rows zero-padded to a multiple of
# the shard count, as the JAX package pads them, shard i on the mesh's i-th
# device, each shard filled straight from the partitions' blocks
# (mesh.shard_rows) with no host concat.  A one-device mesh — the default
# on a host with one card — holds the whole dataset as one unpadded shard.
# FitInputs carries the features, the labels and the weights (user weight
# times the valid-row mask, both at least float32 with a label column) as
# lists of per-shard tensors, with host copies of the labels for label
# discovery.  Fit functions receive FitInputs and return a model-attribute
# dict.
# transform runs partition by partition.  Persistence keeps the JAX package's
# three-file layout (metadata.json, model_arrays.npz, model_attrs.json), and
# the reader maps the class prefix spark_rapids_ml_tpu. to
# spark_rapids_ml_tpu_torch., so models saved by the JAX package load here
# without importing it.
#
# CSR partitions (DataFrame.from_numpy of a sparse matrix) are ingested as
# one ELL pair with its column-major transpose per shard (ops/sparse.py) by
# estimators that declare _supports_sparse_input (the GLMs), and densified
# partition by partition for the others; a model with a sparse path
# transforms CSR partitions as they are.
#
# The fit-input cache holds one staged dataset (the JAX package's single
# slot): a fit whose feature blocks are a frame's own arrays, by identity,
# on the same mesh, reuses the shards of the last such fit (fitMultiple, the
# batched sweep's best-model refit, repeated fits of one frame).  Labels and
# weights are extracted anew each fit.  The counters ingest.staged (datasets
# uploaded) and ingest.cache_hit count both outcomes; clear_fit_cache() and
# DataFrame.unpersist() free the slot, and the slot is freed before a new
# dataset is staged, so the devices hold one staged dataset, not two.
#
# fit(dataset, [paramMaps]) and fitMultiple follow the JAX package: an
# estimator that fits every map in one pass over its data
# (_enable_fit_multiple_in_single_pass) gets the maps as solver-param
# overrides (extra_params of _get_tpu_fit_func); the others fit a copy per
# map.  The model-side hooks _combine / _transformEvaluate, and the batched
# sweep's _supportsBatchedSweep / _fitBatchedSweep, are overridden by the
# estimators that have them (tuning.CrossValidator).
#
# Multi-process fits (parallel/runner.py) build FitInputs over a mesh that
# spans processes: each rank's fields hold its local shards, `rank`,
# `nranks` and `control_plane` name the job, n_pad counts every rank's rows,
# and label discovery unions the ranks' labels over the control plane.  A
# multi-process fit's attributes carry the telemetry snapshot merged across
# ranks under TELEMETRY_ATTR, which _materialize_model pops into
# model._fit_telemetry.  An estimator whose fit cannot run across processes
# says so with _supports_multicontroller_fit = False (UMAP).
#
# A live pyspark DataFrame (recognised by its type's module, pyspark.sql;
# pyspark is never imported here) takes the Spark executor routes of
# spark/adapter.py, as in the JAX package: fit runs a barrier stage whose
# tasks call runner.run_distributed_fit, transform runs mapInPandas on the
# executors with the model in the task closure.  SRML_SPARK_COLLECT=1 takes
# the driver-local route instead (the frame collected through
# spark_to_facade).  extract_partition_features reads one mapInPandas batch
# (a pandas frame, or a port Partition from a stand-in that runs without
# pandas).
#
# SRML_PROFILE=<dir> wraps every fit function, local or a rank's, in
# profiling.maybe_trace (a torch.profiler trace under <dir>/<tag>).
#

from __future__ import annotations

import importlib
import json
import os
import threading
from abc import abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from . import device as _device
from . import profiling
from .dataframe import DataFrame, as_dataframe, partition_of
from .params import Param, _TpuParams
from .parallel.mesh import Mesh, get_mesh, shard_rows
from .parallel.partition import PartitionDescriptor
from .utils import get_logger, materialize_feature_block


def _is_pyspark_dataframe(dataset: Any) -> bool:
    """True for a live pyspark DataFrame, recognised by its type's module so
    pyspark is never imported here."""
    return (type(dataset).__module__ or "").startswith("pyspark.sql")


def _use_executor_path(dataset: Any) -> bool:
    """Whether `dataset` runs on the Spark executors (barrier fit,
    mapInPandas transform) rather than driver-local: a live pyspark
    DataFrame, unless SRML_SPARK_COLLECT=1 forces the driver-local collect."""
    return _is_pyspark_dataframe(dataset) and os.environ.get("SRML_SPARK_COLLECT", "0") != "1"


def extract_partition_features(
    part: Any,
    input_col: Optional[str],
    input_cols: Optional[List[str]],
    dtype: np.dtype,
    densify_sparse: bool = True,
) -> Any:
    """One mapInPandas batch's (rows, D) feature matrix in `dtype`: a pandas
    frame's vector cells stacked (one copy), a port Partition's block read
    as it is (dataframe.partition_of, utils.materialize_feature_block)."""
    cols = [input_col] if input_col is not None else list(input_cols or [])
    return materialize_feature_block(partition_of(part, cols), input_col, input_cols, dtype,
                                     densify_sparse=densify_sparse)


@dataclass
class FitInputs:
    """Row-sharded training inputs handed to fit functions: each sharded
    field is a list of per-shard tensors, shard i on mesh.devices[i] (one
    element on a one-device mesh)."""

    # per-shard (n_loc, D) tensors, or per-shard ops.sparse.EllMatrix for CSR
    # input to an estimator with a sparse path; a fit may drop them once it
    # is done with them
    X: Any
    weight: List[torch.Tensor]  # per-shard (n_loc,) user weight * valid-row mask: pad rows carry 0
    n_rows: int                 # valid rows (the global padded count >= n_rows)
    n_cols: int
    mesh: Mesh
    pdesc: PartitionDescriptor
    dtype: np.dtype
    y: Optional[List[torch.Tensor]] = None  # per-shard (n_loc,) labels (supervised only)
    # host copies of the (unpadded) labels / user weights, for label discovery
    host_y: Optional[np.ndarray] = None
    host_w: Optional[np.ndarray] = None
    # multi-process fits: this rank, the rank count and the job's control
    # plane (None on one process)
    rank: int = 0
    nranks: int = 1
    control_plane: Any = None

    @property
    def device(self) -> torch.device:
        """The mesh's first device: where replicated results (centers, the
        solved coefficients) live."""
        return self.mesh.devices[0]

    @property
    def n_pad(self) -> int:
        """Global padded row count: the shards' rows together, every rank's
        (each rank's share holds the same rows)."""
        return sum(int(w.shape[0]) for w in self.weight) * self.mesh.nranks


def gather_global_rows(shards: List[torch.Tensor], rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Global rows `rows` of a row-sharded tensor, in that order, on
    `device` (shard i holds global rows [i * per, (i + 1) * per))."""
    per = int(shards[0].shape[0])
    if len(shards) == 1:
        return shards[0][torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(shards[0].device)].to(device)
    rows = np.asarray(rows, dtype=np.int64)
    out = torch.empty((rows.size,) + tuple(shards[0].shape[1:]), dtype=shards[0].dtype, device=device)
    owner = rows // per
    for i, x in enumerate(shards):
        at = np.flatnonzero(owner == i)
        if at.size:
            local = torch.from_numpy(rows[at] - i * per).to(x.device)
            out[torch.from_numpy(at).to(device)] = x[local].to(device)
    return out


def whole_rows(shards: List[torch.Tensor]) -> torch.Tensor:
    """A row-sharded tensor as one tensor on the first shard's device: the
    shard itself on a one-device mesh, else the shards concatenated."""
    if len(shards) == 1:
        return shards[0]
    dev = shards[0].device
    return torch.cat([x.to(dev) for x in shards])


# fit function: (inputs, params-dict) -> model attribute dict
FitFunc = Callable[[FitInputs, Dict[str, Any]], Dict[str, Any]]
# transform function: feature batch -> {output column name: column values}
TransformFunc = Callable[[np.ndarray], Dict[str, np.ndarray]]


def torch_dtype(dtype: Any) -> torch.dtype:
    """numpy dtype -> torch dtype."""
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """torch dtype -> numpy dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


# the attribute key of a multi-process fit's merged telemetry snapshot
# (parallel/runner.DistributedFitSession.fit); never a model attribute
TELEMETRY_ATTR = "__srml_telemetry__"

# single-slot device-input cache; see _TpuCaller._build_fit_inputs
_FIT_INPUT_CACHE: Dict[str, Any] = {}
_FIT_INPUT_LOCK = threading.Lock()


def clear_fit_cache() -> None:
    """Release the device-resident fit-input cache (the staged feature
    tensor and the host blocks it was staged from).  Also reachable through
    DataFrame.unpersist()."""
    with _FIT_INPUT_LOCK:
        _FIT_INPUT_CACHE.pop("slot", None)


def _release_fit_features(inputs: "FitInputs") -> None:
    """Drop a fit's reference to its feature tensor, and the cache slot's
    if the slot holds that tensor, so the memory is freed (the forest,
    once its features are binned)."""
    with _FIT_INPUT_LOCK:
        slot = _FIT_INPUT_CACHE.get("slot")
        if slot is not None and slot[1][0] is inputs.X:
            del _FIT_INPUT_CACHE["slot"]
    inputs.X = None


def _validate_input_columns(instance: _TpuParams, df: DataFrame) -> None:
    input_col, input_cols = instance._get_input_columns()
    cols = df.columns
    missing = [
        c for c in ([input_col] if input_col else input_cols or []) if c not in cols
    ]
    if missing:
        raise ValueError(f"Input column(s) {missing} not found in dataset {cols}")


def _partition_features(
    instance: _TpuParams, part: Any, input_col: Optional[str], input_cols: Optional[List[str]], dtype: np.dtype
) -> Any:
    """One partition's features in `dtype`: a CSR block stays CSR for an
    estimator or model with a sparse path and is densified, with a warning,
    for the others."""
    sparse_ok = instance._supports_sparse_input
    if input_col is not None and hasattr(part[input_col], "tocsr") and not sparse_ok:
        get_logger(type(instance)).warning(
            "%s has no sparse path; densifying the CSR partition", type(instance).__name__
        )
    return materialize_feature_block(part, input_col, input_cols, dtype, densify_sparse=not sparse_ok)


def _stage_features(feats: List[Any], dtype: np.dtype, mesh: Mesh) -> List[Any]:
    """The partitions' feature blocks row-sharded over `mesh`: each shard
    filled straight from the blocks (mesh.shard_rows); CSR blocks as one ELL
    pair per shard, never densified."""
    if any(hasattr(f, "tocsr") for f in feats):
        import scipy.sparse as sp

        from .ops.sparse import ell_shards_from_scipy

        csr = sp.vstack(feats).tocsr() if len(feats) > 1 else feats[0]
        return ell_shards_from_scipy(csr, dtype, mesh)
    return shard_rows(feats, mesh, torch_dtype(dtype))[0]


class _TpuCaller(_TpuParams):
    """Shared ingest + fit dispatch."""

    def _use_dtype(
        self, df: DataFrame, input_col: Optional[str], input_cols: Optional[List[str]]
    ) -> np.dtype:
        dev = df._device_features
        if dev is not None:
            return numpy_dtype(dev[0].dtype)
        if self._float32_inputs:
            return np.dtype(np.float32)
        # float32_inputs=False preserves the input dtype
        for part in df.partitions:
            if len(part) == 0:
                continue
            cols = [input_col] if input_col is not None else input_cols
            dt = np.result_type(*(part[c].dtype for c in cols))
            if np.issubdtype(dt, np.floating):
                return np.dtype(dt)
            break
        return np.dtype(np.float64)

    def _build_fit_inputs(self, df: DataFrame) -> FitInputs:
        if df._device_features is not None:
            return self._build_fit_inputs_device(df, df._device_features)
        input_col, input_cols = self._get_input_columns()
        dtype = self._use_dtype(df, input_col, input_cols)
        parts = [p for p in df.partitions if len(p) > 0]
        feats = [_partition_features(self, p, input_col, input_cols, dtype) for p in parts]
        if not feats:
            raise RuntimeError("Dataset is empty; cannot fit")
        mesh = get_mesh(self.num_workers)
        n_rows, n_cols = sum(f.shape[0] for f in feats), feats[0].shape[1]
        # only feature arrays that ARE the frame's blocks are cached: their
        # ids are stable while the slot holds them (it keeps the blocks)
        cacheable = input_col is not None and all(f is p[input_col] for f, p in zip(feats, parts))
        key = (tuple(id(f) for f in feats), str(dtype), mesh)
        with _FIT_INPUT_LOCK:
            slot = _FIT_INPUT_CACHE.get("slot")
            if slot is not None and slot[0] == key:
                X = slot[1][0]
                profiling.incr_counter("ingest.cache_hit")
            else:
                # free the previous dataset before staging this one
                _FIT_INPUT_CACHE.pop("slot", None)
                X = _stage_features(feats, dtype, mesh)
                profiling.incr_counter("ingest.staged")
                if cacheable:
                    _FIT_INPUT_CACHE["slot"] = (key, (X, feats))
        inputs = FitInputs(
            X=X,
            weight=[],
            n_rows=n_rows,
            n_cols=n_cols,
            mesh=mesh,
            pdesc=PartitionDescriptor.build([len(p) for p in df.partitions], n_cols),
            dtype=dtype,
        )
        self._add_labels_and_weights(inputs, df)
        return inputs

    def _fit_label_col(self) -> Optional[str]:
        """Column to extract as FitInputs.y, or None: supervised estimators
        consume their labelCol."""
        if isinstance(self, _TpuEstimatorSupervised) and self.hasParam("labelCol"):
            return self.getOrDefault("labelCol")
        return None

    def _add_labels_and_weights(self, inputs: FitInputs, df: DataFrame) -> None:
        """The weight (and with a label column the labels) of the feature
        shards' rows into `inputs`, row-sharded as the features are: the
        rows past n_rows (a from_device tensor's and the shards' padding)
        carry weight 0.  Without a
        label or weight column the weight is the valid-row mask in the
        feature dtype; with one, labels and weights are at least float32
        whatever the feature dtype (integer class labels above the
        half-precision mantissa are not exact)."""
        label_col = self._fit_label_col()
        weight_col = (
            self.getOrDefault("weightCol")
            if self.hasParam("weightCol") and self.isSet("weightCol")
            else None
        )
        n = inputs.n_rows
        n_total = sum(int(x.shape[0]) for x in inputs.X)
        if label_col is None and weight_col is None:
            ldtype = np.dtype(inputs.dtype)
        else:
            ldtype = np.dtype(np.float32) if np.dtype(inputs.dtype).itemsize < 4 else np.dtype(inputs.dtype)

        def column(name: str) -> np.ndarray:
            if name not in df.columns:
                raise ValueError(f"Column '{name}' not found in dataset {df.columns}")
            values = np.concatenate([np.asarray(p[name], dtype=ldtype) for p in df.partitions])
            if values.shape != (n,):
                raise ValueError(f"column '{name}' holds {values.shape} values for {n} rows")
            return values

        def sharded(values: np.ndarray) -> List[torch.Tensor]:
            full = np.zeros(n_total, dtype=ldtype)
            full[:n] = values
            return shard_rows(full, inputs.mesh)[0]

        if weight_col is not None:
            inputs.host_w = column(weight_col)
            inputs.weight = sharded(inputs.host_w)
        else:
            inputs.weight = sharded(np.ones(n, dtype=ldtype))
        if label_col is not None:
            inputs.host_y = column(label_col)
            inputs.y = sharded(inputs.host_y)

    def _build_fit_inputs_device(self, df: DataFrame, dev_features: tuple) -> FitInputs:
        """FitInputs straight from a DataFrame.from_device tensor: no
        extraction, no upload.  The tensor is re-sharded onto the mesh: on a
        one-device mesh of its own device it is the one shard as it is, and
        shards on its device are slices of it.  Rows past n_rows are padding
        and carry weight 0."""
        X, n_rows, n_cols, _ = dev_features
        mesh = get_mesh(self.num_workers)
        inputs = FitInputs(
            X=shard_rows(X, mesh)[0],
            weight=[],
            n_rows=n_rows,
            n_cols=n_cols,
            mesh=mesh,
            pdesc=PartitionDescriptor.build([n_rows], n_cols),
            dtype=numpy_dtype(X.dtype),
        )
        self._add_labels_and_weights(inputs, df)
        return inputs

    def _call_tpu_fit_func(
        self, dataset: Any, paramMaps: Optional[List[Dict[Param, Any]]] = None
    ) -> Union[Dict[str, Any], List[Dict[str, Any]]]:
        """One fit, or with `paramMaps` one fit per map over one ingest (a
        list of attribute dicts, in the maps' order)."""
        if _use_executor_path(dataset):
            from .spark.adapter import barrier_fit_estimator

            # the input-column check on the driver, before the barrier stage
            # (a pyspark frame has .columns): a missing column fails here,
            # not as an executor traceback
            _validate_input_columns(self, dataset)
            extra = [self._paramMap_to_tpu_overrides(pm) for pm in paramMaps] if paramMaps is not None else None
            results = barrier_fit_estimator(self, dataset, extra_params=extra)
            # the executors' merged telemetry rides the result wire; the
            # driver's phase view comes from it (the fit never ran here)
            telem = results[0].get(TELEMETRY_ATTR) if results else None
            self._last_fit_phase_times = (
                profiling.TelemetrySnapshot.from_dict(telem).phase_seconds() if telem else {}
            )
            return results if paramMaps is not None else results[0]
        df = as_dataframe(dataset)
        _validate_input_columns(self, df)
        with profiling.phase("core.ingest"):
            inputs = self._build_fit_inputs(df)
        if paramMaps is None:
            fit_func = self._get_tpu_fit_func(df)
        else:
            extra = [self._paramMap_to_tpu_overrides(pm) for pm in paramMaps]
            fit_func = self._get_tpu_fit_func(df, extra_params=extra)
        get_logger(type(self)).info(
            "Invoking fit: %d rows x %d cols on %s",
            inputs.n_rows, inputs.n_cols, inputs.device,
        )
        with profiling.maybe_trace(type(self).__name__):
            return fit_func(inputs, dict(self._tpu_params))

    def _paramMap_to_tpu_overrides(self, paramMap: Dict[Param, Any]) -> Dict[str, Any]:
        """A param map -> the solver-param overrides it sets (mapped values),
        raising ValueError for a param or value the solver does not take."""
        mapping = self._param_mapping()
        value_mapping = self._param_value_mapping()
        overrides: Dict[str, Any] = {}
        for param, value in paramMap.items():
            solver = mapping.get(param.name)
            if solver:
                if solver in value_mapping:
                    mapped = value_mapping[solver](value)
                    if mapped is None:
                        raise ValueError(f"Value '{value}' for param '{param.name}' is not supported")
                    value = mapped
                overrides[solver] = value
            elif solver is None and param.name in mapping:
                raise ValueError(f"Param '{param.name}' is not supported")
        return overrides

    # -- abstract ----------------------------------------------------------
    @abstractmethod
    def _get_tpu_fit_func(self, dataset: DataFrame, extra_params: Optional[List[Dict[str, Any]]] = None) -> FitFunc:
        raise NotImplementedError


class _FitMultipleIterator:
    """Thread-safe (index, model) iterator over a single-pass multi-model
    fit: the first next() runs the fit of every map."""

    def __init__(self, fit_multiple_models: Callable[[], List["_TpuModel"]], num_models: int):
        self.fit_multiple_models = fit_multiple_models
        self.num_models = num_models
        self.counter = 0
        self.lock = threading.Lock()
        self.models: Optional[List[_TpuModel]] = None

    def __iter__(self) -> "_FitMultipleIterator":
        return self

    def __next__(self) -> Tuple[int, "_TpuModel"]:
        with self.lock:
            index = self.counter
            if index >= self.num_models:
                raise StopIteration()
            self.counter += 1
            if self.models is None:
                self.models = self.fit_multiple_models()
        return index, self.models[index]


class _TpuEstimator(_TpuCaller):
    """Base estimator."""

    # whether the fit function runs across processes
    # (runner.DistributedFitSession.fit raises for an estimator that says
    # False)
    _supports_multicontroller_fit = True

    def __init__(self) -> None:
        super().__init__()
        self.logger = get_logger(type(self))

    # -- public API --------------------------------------------------------
    def fit(
        self, dataset: Any, params: Optional[Union[Dict[Param, Any], List[Dict[Param, Any]]]] = None
    ) -> Any:
        """fit(df) -> model; fit(df, paramMap) -> the model of this
        estimator's copy with the map; fit(df, [maps]) -> a model per map,
        in the maps' order (through fitMultiple)."""
        if isinstance(params, (list, tuple)):
            return [m for _, m in sorted(self.fitMultiple(dataset, list(params)), key=lambda im: im[0])]
        if isinstance(params, dict) and params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)

    def _fit(self, dataset: Any) -> "_TpuModel":
        return self._fit_internal(dataset, None)[0]

    def fitMultiple(
        self, dataset: Any, paramMaps: List[Dict[Param, Any]]
    ) -> Iterator[Tuple[int, "_TpuModel"]]:
        """(index, model) for each param map: all of them from one pass over
        the data when the estimator fits them in a single pass, else a copy
        fitted per map."""
        if self._enable_fit_multiple_in_single_pass():
            return _FitMultipleIterator(lambda: self._fit_internal(dataset, paramMaps), len(paramMaps))
        return iter([(i, self.copy(pm)._fit(dataset)) for i, pm in enumerate(paramMaps)])

    def _fit_internal(
        self, dataset: Any, paramMaps: Optional[List[Dict[Param, Any]]]
    ) -> List["_TpuModel"]:
        results = self._call_tpu_fit_func(dataset, paramMaps)
        if paramMaps is None:
            return [self._materialize_model(results)]
        return [self._materialize_model(attrs, pm) for attrs, pm in zip(results, paramMaps)]

    def _materialize_model(
        self, attrs: Dict[str, Any], paramMap: Optional[Dict[Param, Any]] = None
    ) -> "_TpuModel":
        """Model-attribute dict -> model carrying this estimator's params and
        the map's own values (set through _set_params, which keeps the Spark
        param and the solver param in step), the one bookkeeping every fit
        route shares, the batched sweep's included.  A multi-process fit's
        merged telemetry (TELEMETRY_ATTR) becomes model._fit_telemetry."""
        telem = attrs.pop(TELEMETRY_ATTR, None)
        model = self._create_model(attrs)
        if telem is not None:
            model._fit_telemetry = profiling.TelemetrySnapshot.from_dict(telem)
        self._copyValues(model)
        model._tpu_params.update(self._tpu_params)
        model._num_workers = self._num_workers
        model._float32_inputs = self._float32_inputs
        if paramMap is not None:
            for p, v in paramMap.items():
                if model.hasParam(p.name):
                    model._set_params(**{p.name: v})
        return model

    def _enable_fit_multiple_in_single_pass(self) -> bool:
        return False

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        return False

    # -- batched hyperparameter sweep --------------------------------------
    def _supportsBatchedSweep(self, df: DataFrame, paramMaps: List[Dict[Param, Any]], evaluator: Any) -> bool:
        """Whether a CrossValidator sweep over `paramMaps` can run as the
        batched sweep (one staged dataset, folds as weight masks, candidates
        as solver lanes).  The GLMs override it; the default keeps the fold
        loop."""
        return False

    def _fitBatchedSweep(
        self, df: DataFrame, paramMaps: List[Dict[Param, Any]], n_folds: int, seed: int
    ) -> List[List[Dict[str, Any]]]:
        """Every (fold, map) fit over one staged dataset: n_folds lists of
        per-map model-attribute dicts.  Called only when
        _supportsBatchedSweep returned True."""
        raise NotImplementedError(f"{type(self).__name__} has no batched sweep")

    def _sweep_sparse_input(self, df: DataFrame) -> bool:
        """Whether any partition holds a CSR feature block: the batched sweep
        declines those (masked-fold ELL statistics are not a goal, as in the
        JAX package)."""
        input_col, _ = self._get_input_columns()
        if input_col is None or input_col not in df.columns:
            return False
        return any(hasattr(p[input_col], "tocsr") for p in df.partitions)

    # -- abstract ----------------------------------------------------------
    @abstractmethod
    def _create_model(self, result: Dict[str, Any]) -> "_TpuModel":
        raise NotImplementedError

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _METADATA_FILE), "w") as f:
            json.dump(_params_metadata(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "_TpuEstimator":
        meta = _read_metadata(path)
        est = _resolve_class(meta["class"])()
        _apply_params_metadata(meta, est)
        return est


class _TpuEstimatorSupervised(_TpuEstimator):
    """Estimator consuming (features, label[, weight])."""


def discover_label_classes(inputs: FitInputs, cast: Optional[Any] = None) -> np.ndarray:
    """Sorted unique label values of the rows with weight > 0, from the
    ingest's host copy of the labels; across processes each rank's values,
    unioned over the control plane (every rank returns the same array)."""
    if inputs.host_y is None:
        raise ValueError("label discovery needs the labels of a supervised fit")
    target = np.dtype(cast) if cast is not None else inputs.host_y.dtype
    vals = inputs.host_y
    if inputs.host_w is not None:
        vals = vals[inputs.host_w > 0]
    local = np.unique(vals.astype(target)).astype(target, copy=False)
    if inputs.nranks > 1 and inputs.control_plane is not None:
        from .parallel.runner import allgather_ndarray

        merged = [m for m in allgather_ndarray(inputs.control_plane, inputs.rank, local) if m.size]
        if merged:
            local = np.unique(np.concatenate([m.astype(target) for m in merged]))
    return local.astype(target, copy=False)


class _TpuModel(_TpuParams):
    """Base model/transformer."""

    def __init__(self, **model_attributes: Any) -> None:
        super().__init__()
        self._model_attributes = model_attributes
        self._initialize_tpu_params()
        self.logger = get_logger(type(self))

    def _get_model_attributes(self) -> Dict[str, Any]:
        return self._model_attributes

    @classmethod
    def _construct(cls, attrs: Dict[str, Any]) -> "_TpuModel":
        """Rebuild a model from its (decoded) attribute dict."""
        return cls(**attrs)

    # -- transform ---------------------------------------------------------
    def transform(self, dataset: Any) -> DataFrame:
        """Column-appending inference: the original columns are kept and the
        output columns named by the *Col params are appended, partition by
        partition.  A live pyspark frame is transformed on the executors
        (spark/adapter.executor_transform): a lazy mapInPandas frame."""
        if _use_executor_path(dataset):
            from .spark.adapter import executor_transform

            return executor_transform(self, dataset)
        df = as_dataframe(dataset)
        if df._device_features is not None:
            raise NotImplementedError(
                "DataFrame.from_device frames are fit-input only (their "
                "features column is a placeholder); transform a host frame"
            )
        _validate_input_columns(self, df)
        input_col, input_cols = self._get_input_columns()
        dtype = self._transform_dtype(self._model_attributes.get("dtype"))
        transform_fn = self._get_tpu_transform_func(df)
        outputs: List[Optional[Dict[str, np.ndarray]]] = []
        for part in df.partitions:
            if len(part) == 0:
                outputs.append(None)  # filled once the output columns are known
                continue
            outputs.append(
                transform_fn(_partition_features(self, part, input_col, input_cols, dtype))
            )
        # empty partitions get the same output columns as the others
        template = next((o for o in outputs if o is not None), None)
        empty = (
            {name: v[:0] for name, v in template.items()}
            if template is not None
            else {name: np.zeros(0) for name in self._out_columns()}
        )
        return DataFrame(
            [
                part.with_columns(out if out is not None else empty)
                for part, out in zip(df.partitions, outputs)
            ]
        )

    def _out_columns(self) -> List[str]:
        return [
            self.getOrDefault(p)
            for p in ("predictionCol",)
            if self.hasParam(p) and self.isDefined(p)
        ]

    _OUT_COLUMN_DDL = {
        "predictionCol": "double",
        "probabilityCol": "array<double>",
        "rawPredictionCol": "array<double>",
        "outputCol": "array<double>",
    }

    def _out_schema_fields(self) -> List[Tuple[str, str]]:
        """(column name, Spark DDL type) of each appended output column: the
        executor transform's mapInPandas schema.  A model whose outputs
        differ from the defaults overrides _OUT_COLUMN_DDL."""
        return [
            (self.getOrDefault(p), self._OUT_COLUMN_DDL[p])
            for p in ("predictionCol", "probabilityCol", "rawPredictionCol", "outputCol")
            if self.hasParam(p) and self.isDefined(p)
        ]

    # -- abstract ----------------------------------------------------------
    @abstractmethod
    def _get_tpu_transform_func(self, dataset: DataFrame) -> TransformFunc:
        raise NotImplementedError

    # -- online serving ----------------------------------------------------
    def _serving_entry(self, mesh: Any = None):
        """ServingEntry for the online inference engine (serving/engine.py).
        Served model classes override it; the base raises, so ModelServer
        gives an actionable error for a model with no online path."""
        raise NotImplementedError(
            f"{type(self).__name__} has no serving entry; servable models "
            "are KMeans/PCA/LinearRegression/LogisticRegression/"
            "RandomForest*/NearestNeighbors/ApproximateNearestNeighbors"
        )

    # -- multi-model -------------------------------------------------------
    @classmethod
    def _combine(cls, models: List["_TpuModel"]) -> "_TpuModel":
        """One model scoring every model of `models` in one pass
        (_transformEvaluate); the estimators with a single-pass
        transform-evaluate override it."""
        raise NotImplementedError(f"{cls.__name__} has no combined multi-model")

    def _transformEvaluate(self, dataset: Any, evaluator: Any, params: Any = None) -> List[float]:
        raise NotImplementedError(f"{type(self).__name__} has no single-pass transform-evaluate")

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _METADATA_FILE), "w") as f:
            json.dump(_params_metadata(self), f, indent=2)
        arrays, attrs = {}, {}
        for k, v in self._get_model_attributes().items():
            if isinstance(v, torch.Tensor):
                arrays[k] = v.detach().cpu().numpy()
            elif isinstance(v, np.ndarray):
                arrays[k] = v
            else:
                attrs[k] = _jsonable(v)
        np.savez(os.path.join(path, _ARRAYS_FILE), **arrays)
        with open(os.path.join(path, _ATTRS_FILE), "w") as f:
            json.dump(attrs, f)

    @classmethod
    def load(cls, path: str) -> "_TpuModel":
        meta = _read_metadata(path)
        with open(os.path.join(path, _ATTRS_FILE)) as f:
            attrs = json.load(f)
        with np.load(os.path.join(path, _ARRAYS_FILE), allow_pickle=False) as npz:
            for k in npz.files:
                attrs[k] = npz[k]
        model = _resolve_class(meta["class"])._construct(attrs)
        _apply_params_metadata(meta, model)
        return model


class _TpuModelWithPredictionCol(_TpuModel):
    """Model appending a predictionCol (set with setPredictionCol, which
    every _TpuParams has)."""


# ---------------------------------------------------------------------------
# Persistence: the JAX package's layout, model attributes as npz + json
# ---------------------------------------------------------------------------

_METADATA_FILE = "metadata.json"
_ARRAYS_FILE = "model_arrays.npz"
_ATTRS_FILE = "model_attrs.json"
# classes saved by the JAX package resolve to their counterpart here
_JAX_PREFIX = "spark_rapids_ml_tpu."
_PORT_PREFIX = "spark_rapids_ml_tpu_torch."


def _params_metadata(instance: _TpuParams) -> Dict[str, Any]:
    from .version import __version__

    return {
        "class": f"{type(instance).__module__}.{type(instance).__name__}",
        "uid": instance.uid,
        "paramMap": {p.name: _jsonable(v) for p, v in instance._paramMap.items()},
        "defaultParamMap": {p.name: _jsonable(v) for p, v in instance._defaultParamMap.items()},
        "tpu_params": {k: _jsonable(v) for k, v in instance._tpu_params.items()},
        "num_workers": instance._num_workers,
        "float32_inputs": instance._float32_inputs,
        "sparkRapidsMlTpuVersion": __version__,
    }


def _jsonable(v: Any) -> Any:
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _read_metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, _METADATA_FILE)) as f:
        return json.load(f)


def _apply_params_metadata(meta: Dict[str, Any], instance: _TpuParams) -> None:
    for name, value in meta.get("defaultParamMap", {}).items():
        if instance.hasParam(name):
            instance._defaultParamMap[instance.getParam(name)] = value
    for name, value in meta.get("paramMap", {}).items():
        if instance.hasParam(name):
            instance.set(instance.getParam(name), value)
    instance._tpu_params = dict(meta.get("tpu_params", {}))
    instance._num_workers = meta.get("num_workers")
    instance._float32_inputs = meta.get("float32_inputs", True)
    instance.uid = meta.get("uid", instance.uid)


def _resolve_class(qualname: str) -> type:
    """The class a saved qualname names, with the JAX package's prefix mapped
    to this package's (the JAX package itself is never imported)."""
    if qualname.startswith(_JAX_PREFIX):
        qualname = _PORT_PREFIX + qualname[len(_JAX_PREFIX):]
    module, _, name = qualname.rpartition(".")
    if not module.startswith(_PORT_PREFIX):
        raise ValueError(f"cannot load a {qualname}: not a class of {_PORT_PREFIX[:-1]}")
    return getattr(importlib.import_module(module), name)


def load(path: str) -> Union[_TpuEstimator, _TpuModel]:
    """Load any saved estimator or model, resolving its class from the
    metadata (models saved by the JAX package included)."""
    cls = _resolve_class(_read_metadata(path)["class"])
    return cls.load(path)
