#
# LinearRegression estimator/model (OLS, ridge, lasso / elastic net).
#
# Counterpart of spark_rapids_ml_tpu/models/linear_regression.py: the same
# Spark param mapping and value mapping, the same solver choice by
# (regParam, elasticNetParam) (OLS and ridge in closed form with ridge's
# alpha scaled by the total weight, elastic net by coordinate descent), the
# same model attributes (coef_, intercept_, n_cols, dtype) and a float64
# prediction column.  The statistics pass and the solve run on one device
# (ops/glm.py); the intercept is computed on the host in float64 from the
# solved coefficients and the weighted means, as in the JAX package.  CSR
# input fits and transforms through the ELL layout (ops/sparse.py).
#
# Not carried over yet: fitMultiple, _fitBatchedSweep, _transformEvaluate
# and _combine (ROADMAP A7), streaming() (A12), the serving hooks
# _serving_entry / _lane_entry (A13) and cpu() (A14c); each raises
# NotImplementedError.
#

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as _device
from .. import profiling
from ..core import FitInputs, _TpuEstimatorSupervised, _TpuModelWithPredictionCol
from ..dataframe import DataFrame
from ..ops.glm import linear_predict_kernel, linreg_sufficient_stats, solve_elasticnet_cd, solve_linear
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

_NOT_PORTED = "is not in this port yet (ROADMAP {})"


def _host_intercept(coef64: np.ndarray, x_mean: Any, y_mean: Any, fit_intercept: bool) -> float:
    """intercept = y_mean - x_mean . coef, on the host in float64 from the
    means, as the JAX package derives it."""
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
    """Linear regression on one device: one pass forms the normal-equation
    statistics; OLS and ridge solve in closed form, lasso and elastic net run
    covariance-update coordinate descent."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._initialize_tpu_params()
        self._set_params(**kwargs)

    def _get_tpu_fit_func(self, dataset: DataFrame):
        logger = get_logger(type(self))

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            if inputs.y is None:
                raise ValueError("LinearRegression needs a label column")
            with record_function("glm.stats"):
                if isinstance(inputs.X, EllMatrix):
                    stats = ell_sufficient_stats(inputs.X, inputs.y, inputs.weight)
                else:
                    stats = linreg_sufficient_stats(inputs.X, inputs.y, inputs.weight)
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

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "LinearRegressionModel":
        return LinearRegressionModel(**result)

    def fitMultiple(self, dataset: Any, paramMaps: Any):
        raise NotImplementedError("LinearRegression.fitMultiple " + _NOT_PORTED.format("A7"))

    def _fitBatchedSweep(self, *args: Any, **kwargs: Any):
        raise NotImplementedError("LinearRegression._fitBatchedSweep " + _NOT_PORTED.format("A7"))

    def streaming(self):
        raise NotImplementedError("LinearRegression.streaming() " + _NOT_PORTED.format("A12"))


class LinearRegressionModel(_LinearRegressionParams, _TpuModelWithPredictionCol):
    def __init__(self, coef_: Any, intercept_: float, n_cols: int, dtype: str) -> None:
        super().__init__(coef_=np.asarray(coef_), intercept_=intercept_, n_cols=int(n_cols), dtype=str(dtype))
        self.coef_ = np.asarray(coef_)
        self.intercept_ = intercept_
        self.n_cols = int(n_cols)
        self.dtype = str(dtype)

    @property
    def coefficients(self) -> np.ndarray:
        return self.coef_

    @property
    def intercept(self) -> float:
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
        raise NotImplementedError("LinearRegressionModel.cpu() " + _NOT_PORTED.format("A14c"))

    def _serving_entry(self, mesh: Any = None):
        raise NotImplementedError("LinearRegressionModel._serving_entry " + _NOT_PORTED.format("A13"))

    def _lane_entry(self, mesh: Any = None):
        raise NotImplementedError("LinearRegressionModel._lane_entry " + _NOT_PORTED.format("A13"))

    @classmethod
    def _combine(cls, models: List["LinearRegressionModel"]):
        raise NotImplementedError("LinearRegressionModel._combine " + _NOT_PORTED.format("A7"))

    def _transformEvaluate(self, dataset: Any, evaluator: Any, params: Any = None):
        raise NotImplementedError("LinearRegressionModel._transformEvaluate " + _NOT_PORTED.format("A7"))

    def _get_tpu_transform_func(self, dataset: DataFrame):
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
