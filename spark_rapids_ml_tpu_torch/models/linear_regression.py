#
# LinearRegression estimator/model (OLS, ridge, lasso / elastic net).
#
# Counterpart of spark_rapids_ml_tpu/models/linear_regression.py: the same
# Spark param mapping and value mapping, the same solver choice by
# (regParam, elasticNetParam) (OLS and ridge in closed form with ridge's
# alpha scaled by the total weight, elastic net by coordinate descent), the
# same model attributes (coef_, intercept_, n_cols, dtype) and a float64
# prediction column.  The statistics pass runs on each of the fit's row
# shards (core.FitInputs) and one psum combines them; the solve runs on the
# mesh's first device (ops/glm.py); the intercept is computed on the host in float64 from the
# solved coefficients and the weighted means, as in the JAX package, on
# every route: that is what lets a batched sweep's sub-model equal the
# sequential fit's.  CSR input fits and transforms through the ELL layout
# (ops/sparse.py).
#
# Model selection: fitMultiple fits every param map from one statistics
# pass (a solve per map); _fitBatchedSweep fits every (fold, map) of a
# CrossValidator over one staged dataset (ops/glm.py sweep_*), when the
# grid varies only regParam and elasticNetParam and the input is dense;
# _combine stacks models and _transformEvaluate scores them all in one pass
# over each partition (RegressionEvaluator), on the Spark executors for a
# live pyspark frame (_partition_metrics a batch,
# spark/adapter.executor_transform_evaluate).
#
# streaming() returns the partial_fit / merge / finalize engine
# (stream/engines.StreamingLinearRegression).
#
# _serving_entry serves the dense Xw + b prediction (one fp32 matmul, TF32
# off, serving/entry.kernel_entry); sparse bulk scoring stays on transform.
#
# _lane_entry is the multiplexed hook (serving/multiplex.py): (coef,
# intercept) as one lane of ops/glm.lane_linear_predict_kernel.
#
# cpu() converts to a pyspark.ml LinearRegressionModel (spark/interop.py;
# it needs pyspark and an active SparkSession).
#

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as _device
from .. import profiling
from ..core import (
    FitInputs,
    _partition_features,
    _TpuEstimatorSupervised,
    _TpuModelWithPredictionCol,
    numpy_dtype,
    torch_dtype,
)
from ..dataframe import DataFrame, as_dataframe, partition_of
from ..metrics.regression import RegressionMetrics
from ..ops.glm import (
    lane_linear_predict_kernel,
    linear_predict_kernel,
    linreg_sufficient_stats,
    multi_linear_predict_kernel,
    solve_elasticnet_cd,
    solve_linear,
    sweep_linreg_fold_stats,
    sweep_solve_elasticnet_cd,
    sweep_solve_linear,
)
from ..ops.lanes import pack_lane_subset
from ..ops.sweep import stage_fold_ids
from ..ops.sparse import EllMatrix, ell_device_from_scipy, ell_sufficient_stats
from ..params import (
    HasElasticNetParam,
    HasFeaturesCol,
    HasFeaturesCols,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasRegParam,
    HasStandardization,
    HasTol,
    HasVerbose,
    HasWeightCol,
    Param,
    TypeConverters,
    _dummy,
    _TpuParams,
)
from ..utils import get_logger


class _RegressionModelEvaluationMixIn:
    """Single-pass transform-evaluate of a (combined) regression model:
    every sub-model's predictions of a block of rows in one pass, merged
    into RegressionMetrics per sub-model (shared with the forest
    regressor)."""

    def _partition_metrics(
        self, part: Any, evaluator: Any, num_models: int, predict_all: Any = None
    ) -> List[RegressionMetrics]:
        """One partition's (or mapInPandas batch's) metric partials, one a
        sub-model: the Spark executor route's unit (a caller looping over
        partitions passes one predict_all, staged once)."""
        from ..core import extract_partition_features

        input_col, input_cols = self._get_input_columns()
        dtype = self._transform_dtype(self._model_attributes.get("dtype"))
        feats = extract_partition_features(part, input_col, input_cols, dtype)
        label_col = self.getOrDefault("labelCol")
        labels = np.asarray(partition_of(part, [label_col])[label_col])
        if predict_all is None:
            predict_all = self._get_eval_predict_func()
        preds = predict_all(feats)  # (M, n)
        return [RegressionMetrics.from_arrays(labels, preds[i]) for i in range(num_models)]

    def _transform_evaluate(self, dataset: Any, evaluator: Any, num_models: int) -> List[float]:
        from ..core import _use_executor_path
        from ..evaluation import RegressionEvaluator

        if not isinstance(evaluator, RegressionEvaluator):
            raise NotImplementedError(f"{evaluator} is unsupported yet.")
        if _use_executor_path(dataset):
            from ..spark.adapter import executor_transform_evaluate

            return executor_transform_evaluate(self, dataset, evaluator, num_models)
        return self._evaluate_blocks(_frame_blocks(self, as_dataframe(dataset)), evaluator, num_models)

    def _evaluate_blocks(self, blocks: Iterable[Tuple[Any, np.ndarray]], evaluator: Any, num_models: int) -> List[float]:
        """The metrics of each sub-model over (features, labels) blocks, one
        partial a block, merged in order; features a host block or a tensor
        on the device."""
        predict_all = self._get_eval_predict_func()
        metrics: List[Optional[RegressionMetrics]] = [None] * num_models
        for features, labels in blocks:
            preds = predict_all(features)  # (M, n)
            for i in range(num_models):
                m = RegressionMetrics.from_arrays(labels, preds[i])
                metrics[i] = m if metrics[i] is None else metrics[i].merge(m)
        return [m.evaluate(evaluator) for m in metrics]  # type: ignore[union-attr]


def _frame_blocks(model: Any, df: DataFrame) -> Iterator[Tuple[Any, np.ndarray]]:
    """(features, labels) of each nonempty partition of `df`, the features
    in the model's transform dtype."""
    label_col = model.getOrDefault("labelCol")
    if label_col not in df.columns:
        raise RuntimeError("Label column is not existing.")
    input_col, input_cols = model._get_input_columns()
    dtype = model._transform_dtype(model._model_attributes.get("dtype"))
    for part in df.partitions:
        if len(part):
            yield _partition_features(model, part, input_col, input_cols, dtype), np.asarray(part[label_col])


def _device_rows(features: Any, np_dtype: np.dtype, dev: torch.device) -> Any:
    """A block of rows on the device: a tensor as it is (in the dtype), a
    host block uploaded, a CSR block as ELL."""
    if isinstance(features, torch.Tensor):
        return features.to(device=dev, dtype=torch_dtype(np_dtype))
    if hasattr(features, "tocsr"):
        return ell_device_from_scipy(features, np_dtype, dev, transpose=False)
    return torch.from_numpy(np.ascontiguousarray(features, dtype=np_dtype)).to(dev)


def _host_intercept(coef64: np.ndarray, x_mean: Any, y_mean: Any, fit_intercept: bool) -> float:
    """intercept = y_mean - x_mean . coef, on the host in float64 from the
    means, as the JAX package derives it: the same on the sequential and
    the batched route by construction."""
    if not fit_intercept:
        return 0.0
    return float(np.asarray(y_mean, dtype=np.float64) - np.asarray(x_mean, dtype=np.float64) @ coef64)


class LinearRegressionClass(_TpuParams):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "aggregationDepth": "",
            "elasticNetParam": "l1_ratio",
            "epsilon": "",
            "fitIntercept": "fit_intercept",
            "loss": "loss",
            "maxBlockSizeInMB": "",
            "maxIter": "max_iter",
            "regParam": "alpha",
            "solver": "solver",
            "standardization": "normalize",
            "tol": "tol",
            "weightCol": None,
        }

    @classmethod
    def _param_value_mapping(cls):
        return {
            "loss": lambda x: {"squaredError": "squared_loss", "squared_loss": "squared_loss"}.get(x),
            "solver": lambda x: {"auto": "eig", "normal": "eig", "eig": "eig"}.get(x),
        }

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "algorithm": "eig",
            "fit_intercept": True,
            "normalize": False,
            "verbose": False,
            "alpha": 0.0001,
            "solver": "eig",
            "loss": "squared_loss",
            "l1_ratio": 0.15,
            "max_iter": 1000,
            "tol": 0.001,
            "shuffle": True,
        }


class _LinearRegressionParams(
    LinearRegressionClass,
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasMaxIter,
    HasTol,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasWeightCol,
    HasVerbose,
):
    # CSR input fits and transforms through the ELL layout (ops/sparse.py)
    _supports_sparse_input = True

    loss = Param(_dummy(), "loss", "the loss function to be optimized (squaredError)", TypeConverters.toString)
    solver = Param(_dummy(), "solver", "the solver algorithm (auto|normal|eig)", TypeConverters.toString)
    aggregationDepth = Param(_dummy(), "aggregationDepth", "suggested depth for treeAggregate", TypeConverters.toInt)
    epsilon = Param(_dummy(), "epsilon", "shape parameter of huber loss (unsupported loss)", TypeConverters.toFloat)
    maxBlockSizeInMB = Param(
        _dummy(), "maxBlockSizeInMB", "maximum memory in MB for stacking input data", TypeConverters.toFloat
    )

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(
            maxIter=100,
            regParam=0.0,
            elasticNetParam=0.0,
            tol=1e-6,
            loss="squaredError",
            solver="auto",
            standardization=True,
            aggregationDepth=2,
            epsilon=1.35,
            maxBlockSizeInMB=0.0,
        )

    def setMaxIter(self, value: int):
        return self._set_params(maxIter=value)

    def setRegParam(self, value: float):
        return self._set_params(regParam=value)

    def setElasticNetParam(self, value: float):
        return self._set_params(elasticNetParam=value)

    def setStandardization(self, value: bool):
        return self._set_params(standardization=value)

    def setTol(self, value: float):
        return self._set_params(tol=value)

    def setFitIntercept(self, value: bool):
        return self._set_params(fitIntercept=value)

    def setLossFunction(self, value: str):
        return self._set_params(loss=value)


class LinearRegression(_LinearRegressionParams, _TpuEstimatorSupervised):
    """Linear regression over the fit's row shards: one pass forms the
    normal-equation statistics; OLS and ridge solve in closed form, lasso
    and elastic net run covariance-update coordinate descent."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._initialize_tpu_params()
        self._set_params(**kwargs)

    def _enable_fit_multiple_in_single_pass(self) -> bool:
        return True

    def _supportsTransformEvaluate(self, evaluator: Any) -> bool:
        from ..evaluation import RegressionEvaluator

        return isinstance(evaluator, RegressionEvaluator)

    def _get_tpu_fit_func(self, dataset: DataFrame, extra_params: Optional[List[Dict[str, Any]]] = None):
        logger = get_logger(type(self))

        def _single_fit(stats, params: Dict[str, Any], inputs: FitInputs) -> Dict[str, Any]:
            alpha = float(params["alpha"])
            l1_ratio = float(params["l1_ratio"])
            fit_intercept = bool(params["fit_intercept"])
            normalize = bool(params["normalize"])
            if alpha == 0.0 or l1_ratio == 0.0:
                # OLS, or ridge with alpha scaled by the total weight inside
                with record_function("glm.solve"):
                    coef, _ = solve_linear(stats, alpha, fit_intercept=fit_intercept, normalize=normalize)
            else:
                with record_function("glm.cd"):
                    coef, _, n_iter = solve_elasticnet_cd(
                        stats,
                        alpha,
                        l1_ratio,
                        fit_intercept=fit_intercept,
                        normalize=normalize,
                        max_iter=int(params["max_iter"]),
                        tol=float(params["tol"]),
                    )
                profiling.incr_counter("glm.cd_sweeps", n_iter)
                logger.info("CD sweeps: %d", n_iter)
            coef64 = coef.cpu().numpy().astype(np.float64)
            return {
                "coef_": coef64,
                "intercept_": _host_intercept(
                    coef64, stats.x_mean.cpu().numpy(), stats.y_mean.cpu().numpy(), fit_intercept
                ),
                "n_cols": inputs.n_cols,
                "dtype": str(inputs.dtype),
            }

        def _fit(inputs: FitInputs, params: Dict[str, Any]):
            if inputs.y is None:
                raise ValueError("LinearRegression needs a label column")
            with record_function("glm.stats"):
                if isinstance(inputs.X[0], EllMatrix):
                    stats = ell_sufficient_stats(inputs.X, inputs.y, inputs.weight)
                else:
                    stats = linreg_sufficient_stats(inputs.X, inputs.y, inputs.weight)
            if extra_params is None:
                return _single_fit(stats, params, inputs)
            # every param map from the one statistics pass
            return [_single_fit(stats, {**params, **override}, inputs) for override in extra_params]

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "LinearRegressionModel":
        return LinearRegressionModel(**result)

    # -- batched sweep -----------------------------------------------------
    def _supportsBatchedSweep(self, df: Any, paramMaps: List[Dict[Param, Any]], evaluator: Any) -> bool:
        if not paramMaps or not self._supportsTransformEvaluate(evaluator):
            return False
        try:
            overrides = [self._paramMap_to_tpu_overrides(pm) for pm in paramMaps]
        except ValueError:
            return False  # the fold loop raises its own error
        if any(set(ov) - {"alpha", "l1_ratio"} for ov in overrides):
            return False  # only the regularizer axes ride as lanes
        return not self._sweep_sparse_input(as_dataframe(df))

    def _fitBatchedSweep(
        self, df: Any, paramMaps: List[Dict[Param, Any]], n_folds: int, seed: int
    ) -> List[List[Dict[str, Any]]]:
        """Every (fold, map) fit over one staged dataset: one masked-fold
        statistics pass, then the closed-form lanes and the CD lanes, each
        lane the sequential fit's own solve on its fold's statistics."""
        params = dict(self._tpu_params)
        cand = []
        for pm in paramMaps:
            p = {**params, **self._paramMap_to_tpu_overrides(pm)}
            cand.append((float(p["alpha"]), float(p["l1_ratio"])))
        fit_intercept = bool(params["fit_intercept"])
        normalize = bool(params["normalize"])
        # the sequential fit's solver choice per candidate
        closed = [i for i, (a, l1r) in enumerate(cand) if a == 0.0 or l1r == 0.0]
        cd = [i for i in range(len(cand)) if i not in closed]
        dev = _device.resolve()
        with profiling.phase("tuning.sweep.ingest", dev):
            inputs = self._build_fit_inputs(as_dataframe(df))
        if inputs.y is None:
            raise ValueError("LinearRegression needs a label column")
        if isinstance(inputs.X[0], EllMatrix):
            raise ValueError("the batched sweep takes dense features")
        fid = stage_fold_ids(inputs.n_rows, inputs.n_pad, n_folds, seed, inputs.mesh)
        with profiling.phase("tuning.sweep.stats", dev):
            stats = sweep_linreg_fold_stats(inputs.X, inputs.y, inputs.weight, fid, n_folds)
        del inputs, fid
        xm_h, ym_h = stats.x_mean.cpu().numpy(), stats.y_mean.cpu().numpy()
        n_cols, dtype = int(stats.G.shape[1]), str(numpy_dtype(stats.G.dtype))
        results: List[List[Dict[str, Any]]] = [[{} for _ in cand] for _ in range(n_folds)]

        def collect(idxs: List[int], coef_h: np.ndarray) -> None:
            for j, i in enumerate(idxs):
                for f in range(n_folds):
                    coef64 = np.asarray(coef_h[f, j], dtype=np.float64)
                    results[f][i] = {
                        "coef_": coef64,
                        "intercept_": _host_intercept(coef64, xm_h[f], ym_h[f], fit_intercept),
                        "n_cols": n_cols,
                        "dtype": dtype,
                    }

        if closed:
            with profiling.phase("tuning.sweep.solve", dev):
                _, (alphas,) = pack_lane_subset(cand, closed)
                coef, _ = sweep_solve_linear(stats, alphas.tolist(), fit_intercept=fit_intercept, normalize=normalize)
                collect(closed, coef.cpu().numpy())
        if cd:
            with profiling.phase("tuning.sweep.cd", dev):
                _, (alphas, l1s) = pack_lane_subset(cand, cd, fields=(0, 1))
                coef, _, sweeps = sweep_solve_elasticnet_cd(
                    stats, alphas.tolist(), l1s.tolist(), float(params["tol"]),
                    fit_intercept=fit_intercept, normalize=normalize, max_iter=int(params["max_iter"]),
                )
                collect(cd, coef.cpu().numpy())
            profiling.incr_counter("glm.cd_sweeps", int(sweeps[:, : len(cd)].sum()))
            get_logger(type(self)).info("sweep CD sweeps (fold x candidate): %s", sweeps[:, : len(cd)].tolist())
        return results

    def streaming(self, **kwargs: Any):
        """The streaming engine over this estimator (partial_fit / merge /
        finalize; stream/engines.StreamingLinearRegression)."""
        from ..stream.engines import StreamingLinearRegression

        return StreamingLinearRegression(self, **kwargs)


class LinearRegressionModel(_LinearRegressionParams, _RegressionModelEvaluationMixIn, _TpuModelWithPredictionCol):
    """A fitted linear model; a _combine'd model holds M models' coef_
    (M, D) and intercept_ (M,) and only scores them (_transformEvaluate)."""

    def __init__(self, coef_: Any, intercept_: Union[float, List[float]], n_cols: int, dtype: str) -> None:
        super().__init__(coef_=np.asarray(coef_), intercept_=intercept_, n_cols=int(n_cols), dtype=str(dtype))
        self.coef_ = np.asarray(coef_)
        self.intercept_ = intercept_
        self.n_cols = int(n_cols)
        self.dtype = str(dtype)

    @property
    def _num_models(self) -> int:
        return len(self.intercept_) if isinstance(self.intercept_, (list, np.ndarray)) and self.coef_.ndim == 2 else 1

    @property
    def coefficients(self) -> np.ndarray:
        assert self._num_models == 1
        return self.coef_

    @property
    def intercept(self) -> float:
        assert self._num_models == 1
        return float(self.intercept_)

    @property
    def scale(self) -> float:
        """Huber loss is not supported: 1.0, for the API."""
        return 1.0

    @property
    def hasSummary(self) -> bool:
        return False

    def _device_params(self, np_dtype: np.dtype):
        dev = _device.resolve()
        coef = torch.as_tensor(np.asarray(self.coef_, dtype=np_dtype), device=dev)
        intercept = torch.as_tensor(np_dtype.type(self.intercept_), device=dev)
        return coef, intercept

    def predict(self, value: np.ndarray) -> float:
        np_dtype = self._transform_dtype(self.dtype)
        coef, intercept = self._device_params(np_dtype)
        x = torch.as_tensor(np.asarray(value, dtype=np_dtype)[None, :], device=coef.device)
        return float(linear_predict_kernel(x, coef, intercept)[0])

    def cpu(self):
        """This model as a pyspark.ml.regression.LinearRegressionModel
        (needs pyspark and an active SparkSession)."""
        from ..spark.interop import to_spark_linear_model

        return to_spark_linear_model(self)

    def _serving_entry(self, mesh: Any = None):
        """Online inference hook (serving/): the dense Xw + b prediction of
        a padded batch."""
        if self._num_models != 1:
            raise ValueError("combined multi-models are not servable")
        from ..serving.entry import kernel_entry

        np_dtype = self._transform_dtype(self.dtype)
        dev = mesh.devices[0] if mesh is not None else _device.resolve()
        coef = torch.as_tensor(np.asarray(self.coef_, dtype=np_dtype), device=dev)
        intercept = torch.as_tensor(np_dtype.type(self.intercept_), device=dev)
        pred_col = self.getOrDefault("predictionCol")
        return kernel_entry(
            "serve.linreg",
            linear_predict_kernel,
            (coef, intercept),
            lambda out: {pred_col: out[0].astype(np.float64)},
            device=dev,
            dtype=np_dtype,
            n_cols=self.n_cols,
            out_cols=[pred_col],
        )

    def _lane_entry(self, mesh: Any = None):
        """Multiplexed serving hook (serving/multiplex): this model's
        (coef, intercept) as ONE lane of a lane-stacked GLM predict — K
        same-shape variants share one lane_linear_predict_kernel call per
        micro-batch, bitwise-equal per tenant to the dedicated entry above
        on integer-exact data."""
        if self._num_models != 1:
            raise ValueError("combined multi-models are not servable")
        from ..serving.multiplex import LaneEntry

        np_dtype = self._transform_dtype(self.dtype)
        pred_col = self.getOrDefault("predictionCol")
        return LaneEntry(
            name="lanes.linreg",
            n_cols=self.n_cols,
            dtype=np_dtype,
            out_cols=[pred_col],
            leaves=(np.ascontiguousarray(np.asarray(self.coef_, dtype=np_dtype)), np.asarray(np_dtype.type(self.intercept_))),
            kernel=lane_linear_predict_kernel,
            statics={},
            postprocess=lambda out: {pred_col: out[0].astype(np.float64)},
            device=mesh.devices[0] if mesh is not None else _device.resolve(),
        )

    @classmethod
    def _combine(cls, models: List["LinearRegressionModel"]) -> "LinearRegressionModel":
        assert models and all(isinstance(m, cls) for m in models)
        first = models[0]
        combined = cls(
            coef_=np.stack([np.asarray(m.coef_) for m in models]),
            intercept_=[float(m.intercept_) for m in models],
            n_cols=first.n_cols,
            dtype=first.dtype,
        )
        first._copyValues(combined)
        combined._tpu_params.update(first._tpu_params)
        combined._float32_inputs = first._float32_inputs
        return combined

    def _transformEvaluate(self, dataset: Any, evaluator: Any, params: Any = None) -> List[float]:
        return self._transform_evaluate(dataset, evaluator, self._num_models)

    def _get_eval_predict_func(self):
        """features -> (M, n) float64 predictions of every sub-model: one
        (n, D) x (D, M) product a partition."""
        np_dtype = self._transform_dtype(self.dtype)
        dev = _device.resolve()
        coefs = torch.as_tensor(np.atleast_2d(np.asarray(self.coef_, dtype=np_dtype)), device=dev)
        intercepts = torch.as_tensor(np.atleast_1d(np.asarray(self.intercept_, dtype=np_dtype)), device=dev)

        def _predict_all(features: Any) -> np.ndarray:
            X = _device_rows(features, np_dtype, dev)
            if isinstance(X, EllMatrix):
                preds = torch.stack([linear_predict_kernel(X, c, b) for c, b in zip(coefs, intercepts)])
            else:
                preds = multi_linear_predict_kernel(X, coefs, intercepts)
            return preds.cpu().numpy().astype(np.float64)

        return _predict_all

    def _get_tpu_transform_func(self, dataset: DataFrame):
        assert self._num_models == 1, "transform() of a combined multi-model: use _transformEvaluate"
        np_dtype = self._transform_dtype(self.dtype)
        coef, intercept = self._device_params(np_dtype)
        pred_col = self.getOrDefault("predictionCol")

        def _transform(features: Any) -> Dict[str, Any]:
            if hasattr(features, "tocsr"):  # a CSR partition: ELL on the device
                X = ell_device_from_scipy(features, np_dtype, coef.device, transpose=False)
            else:
                X = torch.from_numpy(np.ascontiguousarray(features, dtype=np_dtype)).to(coef.device)
            preds = linear_predict_kernel(X, coef, intercept)
            return {pred_col: preds.cpu().numpy().astype(np.float64)}

        return _transform
