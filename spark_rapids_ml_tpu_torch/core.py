#
# Core estimator/model machinery: ingest -> one device tensor, fit dispatch,
# transform dispatch, persistence.
#
# Counterpart of spark_rapids_ml_tpu/core.py on one device.  Ingest copies
# each partition's feature block straight into its rows of one (N, D) tensor
# on the device that device.resolve() picks — no host concat, no row padding.
# Supervised estimators also get the labels and the weights (user weight
# times the valid-row mask), both at least float32, with host copies for
# label discovery.  Fit functions receive FitInputs and return a
# model-attribute dict.
# transform runs partition by partition.  Persistence keeps the JAX package's
# three-file layout (metadata.json, model_arrays.npz, model_attrs.json), and
# the reader maps the class prefix spark_rapids_ml_tpu. to
# spark_rapids_ml_tpu_torch., so models saved by the JAX package load here
# without importing it.
#
# CSR partitions (DataFrame.from_numpy of a sparse matrix) are ingested as
# one ELL pair with its column-major transpose (ops/sparse.py) by estimators
# that declare _supports_sparse_input (the GLMs), and densified partition by
# partition for the others; a model with a sparse path transforms CSR
# partitions as they are.
#
# Not carried over yet: the Spark executor paths, the fit-input cache,
# fitMultiple, and the profiling / watch / sanitize / fault-injection hooks.
#

from __future__ import annotations

import importlib
import json
import os
from abc import abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from . import device as _device
from .dataframe import DataFrame, as_dataframe
from .params import Param, _TpuParams
from .parallel.partition import PartitionDescriptor
from .utils import get_logger, materialize_feature_block


@dataclass
class FitInputs:
    """Training inputs on one device, handed to fit functions."""

    # (N_pad, D), or an ops.sparse.EllMatrix for CSR input to an estimator
    # with a sparse path; a fit may drop it once it is done with it
    X: Any
    weight: torch.Tensor     # (N_pad,) user weight * valid-row mask: pad rows carry 0
    n_rows: int              # valid rows (N_pad >= n_rows)
    n_cols: int
    device: torch.device
    pdesc: PartitionDescriptor
    dtype: np.dtype
    y: Optional[torch.Tensor] = None       # (N_pad,) labels (supervised only)
    # host copies of the (unpadded) labels / user weights, for label discovery
    host_y: Optional[np.ndarray] = None
    host_w: Optional[np.ndarray] = None


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
        feats = [
            _partition_features(self, p, input_col, input_cols, dtype)
            for p in df.partitions
            if len(p) > 0
        ]
        if not feats:
            raise RuntimeError("Dataset is empty; cannot fit")
        dev = _device.resolve()
        n_rows, n_cols = sum(f.shape[0] for f in feats), feats[0].shape[1]
        if any(hasattr(f, "tocsr") for f in feats):
            # CSR partitions -> one ELL pair on the device, never densified
            import scipy.sparse as sp

            from .ops.sparse import ell_device_from_scipy

            csr = sp.vstack(feats).tocsr() if len(feats) > 1 else feats[0]
            X = ell_device_from_scipy(csr, dtype, dev)
        else:
            X = torch.empty((n_rows, n_cols), dtype=torch_dtype(dtype), device=dev)
            offset = 0
            for f in feats:
                X[offset : offset + f.shape[0]].copy_(torch.from_numpy(f))
                offset += f.shape[0]
        inputs = FitInputs(
            X=X,
            weight=torch.ones(n_rows, dtype=torch_dtype(dtype), device=dev),
            n_rows=n_rows,
            n_cols=n_cols,
            device=dev,
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
        """Labels and weights of the valid rows into `inputs`, at least
        float32 whatever the feature dtype (integer class labels above the
        half-precision mantissa are not exact), padded with zeros to the
        feature tensor's rows: pad rows carry weight 0."""
        label_col = self._fit_label_col()
        weight_col = (
            self.getOrDefault("weightCol")
            if self.hasParam("weightCol") and self.isSet("weightCol")
            else None
        )
        if label_col is None and weight_col is None:
            return
        ldtype = np.dtype(np.float32) if np.dtype(inputs.dtype).itemsize < 4 else np.dtype(inputs.dtype)
        n_pad, n = inputs.weight.shape[0], inputs.n_rows

        def column(name: str) -> np.ndarray:
            if name not in df.columns:
                raise ValueError(f"Column '{name}' not found in dataset {df.columns}")
            values = np.concatenate([np.asarray(p[name], dtype=ldtype) for p in df.partitions])
            if values.shape != (n,):
                raise ValueError(f"column '{name}' holds {values.shape} values for {n} rows")
            return values

        def padded(values: np.ndarray) -> torch.Tensor:
            out = torch.zeros(n_pad, dtype=torch_dtype(ldtype), device=inputs.device)
            out[:n].copy_(torch.from_numpy(values))
            return out

        if weight_col is not None:
            inputs.host_w = column(weight_col)
            inputs.weight = padded(inputs.host_w)
        else:
            inputs.weight = inputs.weight.to(torch_dtype(ldtype))
        if label_col is not None:
            inputs.host_y = column(label_col)
            inputs.y = padded(inputs.host_y)

    def _build_fit_inputs_device(self, df: DataFrame, dev_features: tuple) -> FitInputs:
        """FitInputs straight from a DataFrame.from_device tensor: no
        extraction, no upload (the tensor moves only if it lies on another
        device than the entry points run on).  Rows past n_rows are padding
        and carry weight 0."""
        X, n_rows, n_cols, _ = dev_features
        dev = _device.resolve()
        X = X.to(dev)
        weight = torch.zeros(X.shape[0], dtype=X.dtype, device=dev)
        weight[:n_rows] = 1.0
        inputs = FitInputs(
            X=X,
            weight=weight,
            n_rows=n_rows,
            n_cols=n_cols,
            device=dev,
            pdesc=PartitionDescriptor.build([n_rows], n_cols),
            dtype=numpy_dtype(X.dtype),
        )
        self._add_labels_and_weights(inputs, df)
        return inputs

    def _call_tpu_fit_func(self, dataset: Any) -> Dict[str, Any]:
        df = as_dataframe(dataset)
        _validate_input_columns(self, df)
        with record_function("core.ingest"):
            inputs = self._build_fit_inputs(df)
        fit_func = self._get_tpu_fit_func(df)
        get_logger(type(self)).info(
            "Invoking fit: %d rows x %d cols on %s",
            inputs.n_rows, inputs.n_cols, inputs.device,
        )
        return fit_func(inputs, dict(self._tpu_params))

    # -- abstract ----------------------------------------------------------
    @abstractmethod
    def _get_tpu_fit_func(self, dataset: DataFrame) -> FitFunc:
        raise NotImplementedError


class _TpuEstimator(_TpuCaller):
    """Base estimator."""

    def __init__(self) -> None:
        super().__init__()
        self.logger = get_logger(type(self))

    # -- public API --------------------------------------------------------
    def fit(self, dataset: Any, params: Optional[Dict[Param, Any]] = None) -> "_TpuModel":
        if params:
            return self.copy(params)._fit(dataset)
        return self._fit(dataset)

    def _fit(self, dataset: Any) -> "_TpuModel":
        return self._fit_internal(dataset)[0]

    def _fit_internal(self, dataset: Any) -> List["_TpuModel"]:
        return [self._materialize_model(self._call_tpu_fit_func(dataset))]

    def _materialize_model(self, attrs: Dict[str, Any]) -> "_TpuModel":
        """Model-attribute dict -> model carrying this estimator's params."""
        model = self._create_model(attrs)
        self._copyValues(model)
        model._tpu_params.update(self._tpu_params)
        model._num_workers = self._num_workers
        model._float32_inputs = self._float32_inputs
        return model

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
    ingest's host copy of the labels (one device, one process)."""
    if inputs.host_y is None:
        raise ValueError("label discovery needs the labels of a supervised fit")
    target = np.dtype(cast) if cast is not None else inputs.host_y.dtype
    vals = inputs.host_y
    if inputs.host_w is not None:
        vals = vals[inputs.host_w > 0]
    return np.unique(vals.astype(target)).astype(target, copy=False)


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
        partition."""
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

    # -- abstract ----------------------------------------------------------
    @abstractmethod
    def _get_tpu_transform_func(self, dataset: DataFrame) -> TransformFunc:
        raise NotImplementedError

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
