#
# LogisticRegression estimator/model (binary sigmoid and multinomial
# softmax; L2, L1 and elastic net through L-BFGS / OWL-QN).
#
# Counterpart of spark_rapids_ml_tpu/models/logistic_regression.py: the same
# param mapping (regParam -> C = 1 / regParam) and penalty derivation from
# (regParam, elasticNetParam), the same model attributes (coef_ (k, D),
# intercept_ (k,), classes_, n_cols, dtype, num_iters) and transform
# columns: prediction, probability (binary: the sigmoid, multinomial: a
# stable softmax) and rawPrediction ([-z, z] for binary).  Classes come from
# core.discover_label_classes and the labels are encoded on their device
# (ops/labels.encode_labels); the solve runs on the same device
# (ops/logistic.py).  CSR input fits and transforms through the ELL layout,
# with a deterministic gradient (ops/sparse.ell_rmatmat).
#
# Not carried over yet: fitMultiple, _fitBatchedSweep, _transformEvaluate
# and _combine (ROADMAP A7), streaming() (A12), the serving hooks
# _serving_entry / _lane_entry (A13) and cpu() (A14c); each raises
# NotImplementedError.
#

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as _device
from .. import profiling
from ..core import FitInputs, _TpuEstimatorSupervised, _TpuModelWithPredictionCol, discover_label_classes
from ..dataframe import DataFrame
from ..ops.labels import encode_labels
from ..ops.logistic import logistic_decision_kernel, logistic_fit_kernel, scores_to_labels, scores_to_probs
from ..ops.sparse import ell_device_from_scipy
from ..params import (
    HasElasticNetParam,
    HasFeaturesCol,
    HasFeaturesCols,
    HasFitIntercept,
    HasLabelCol,
    HasMaxIter,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
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


class LogisticRegressionClass(_TpuParams):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {
            "maxIter": "max_iter",
            "regParam": "C",
            "elasticNetParam": "l1_ratio",
            "tol": "tol",
            "fitIntercept": "fit_intercept",
            "threshold": None,
            "thresholds": None,
            "standardization": "",
            "weightCol": None,
            "aggregationDepth": None,
            "family": "",
            "maxBlockSizeInMB": None,
        }

    @classmethod
    def _param_value_mapping(cls):
        # Spark's regParam -> C = 1 / regParam (0 stays 0)
        return {"C": lambda x: 1 / x if x > 0.0 else (0.0 if x == 0.0 else None)}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "fit_intercept": True,
            "verbose": False,
            "C": 1.0,
            "penalty": "l2",
            "l1_ratio": None,
            "max_iter": 1000,
            "tol": 0.0001,
        }

    @staticmethod
    def _reg_params_value_mapping(reg_param: float, elasticnet_param: float):
        """(regParam, elasticNetParam) -> (penalty, C, l1_ratio)."""
        if reg_param == 0.0:
            return "none", 0.0, elasticnet_param
        if elasticnet_param == 0.0:
            return "l2", 1.0 / reg_param, elasticnet_param
        if elasticnet_param == 1.0:
            return "l1", 1.0 / reg_param, elasticnet_param
        return "elasticnet", 1.0 / reg_param, elasticnet_param


class _LogisticRegressionParams(
    LogisticRegressionClass,
    HasFeaturesCol,
    HasFeaturesCols,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasMaxIter,
    HasTol,
    HasRegParam,
    HasElasticNetParam,
    HasFitIntercept,
    HasStandardization,
    HasWeightCol,
    HasVerbose,
):
    family = Param(
        _dummy(), "family", "the name of family (auto|binomial|multinomial); detected automatically",
        TypeConverters.toString,
    )
    threshold = Param(_dummy(), "threshold", "binary classification threshold", TypeConverters.toFloat)

    # CSR input fits and transforms through the ELL layout (ops/sparse.py)
    _supports_sparse_input = True

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(
            maxIter=100,
            regParam=0.0,
            elasticNetParam=0.0,
            tol=1e-6,
            standardization=True,
            family="auto",
        )

    def setMaxIter(self, value: int):
        return self._set_params(maxIter=value)

    def setRegParam(self, value: float):
        return self._set_params(regParam=value)

    def setElasticNetParam(self, value: float):
        return self._set_params(elasticNetParam=value)

    def setTol(self, value: float):
        return self._set_params(tol=value)

    def setFitIntercept(self, value: bool):
        return self._set_params(fitIntercept=value)

    def setProbabilityCol(self, value: str):
        return self._set_params(probabilityCol=value)

    def setRawPredictionCol(self, value: str):
        return self._set_params(rawPredictionCol=value)


class LogisticRegression(_LogisticRegressionParams, _TpuEstimatorSupervised):
    """Logistic regression on one device through L-BFGS / OWL-QN.  The
    solver's iterations, objective evaluations and converged fits are
    counted in profiling counters lbfgs.iterations, lbfgs.evaluations and
    lbfgs.converged."""

    def __init__(self, **kwargs: Any) -> None:
        if not kwargs.get("float32_inputs", True):
            get_logger(type(self)).warning(
                "This estimator does not support double precision inputs. "
                "Setting float32_inputs to False will be ignored."
            )
            kwargs.pop("float32_inputs")
        super().__init__()
        self._initialize_tpu_params()
        self._set_tpu_reg_params()
        self._set_params(**kwargs)
        self._set_tpu_reg_params()

    def _set_tpu_reg_params(self) -> None:
        penalty, C, l1_ratio = self._reg_params_value_mapping(
            self.getOrDefault("regParam"), self.getOrDefault("elasticNetParam")
        )
        self._tpu_params["penalty"] = penalty
        self._tpu_params["C"] = C
        self._tpu_params["l1_ratio"] = l1_ratio

    def _set_params(self, **kwargs: Any):
        out = super()._set_params(**kwargs)
        if hasattr(self, "_tpu_params") and ("regParam" in kwargs or "elasticNetParam" in kwargs):
            self._set_tpu_reg_params()
        return out

    def _get_tpu_fit_func(self, dataset: DataFrame):
        logger = get_logger(type(self))

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            if inputs.y is None:
                raise ValueError("LogisticRegression needs a label column")
            classes = discover_label_classes(inputs)
            if len(classes) < 2:
                raise RuntimeError("LogisticRegression requires at least two distinct labels")
            # class indices on the labels' device (pad rows clamp into
            # range; their weight is 0)
            y_enc = encode_labels(inputs.y, torch.as_tensor(classes.astype(inputs.host_y.dtype)))
            C = float(params["C"])
            l1_ratio = float(params.get("l1_ratio") or 0.0)
            reg = 1.0 / C if C > 0 else 0.0
            k = 1 if len(classes) == 2 else len(classes)
            with record_function("lbfgs.fit"):
                W, b, n_iter, converged, n_evals = logistic_fit_kernel(
                    inputs.X,
                    y_enc,
                    inputs.weight,
                    k,
                    reg,
                    l1_ratio,
                    bool(params["fit_intercept"]),
                    int(params["max_iter"]),
                    float(params["tol"]),
                    reg > 0 and l1_ratio > 0,
                )
            profiling.incr_counter("lbfgs.iterations", n_iter)
            profiling.incr_counter("lbfgs.evaluations", n_evals)
            profiling.incr_counter("lbfgs.converged", int(converged))
            logger.info("L-BFGS iters: %d converged: %s", n_iter, converged)
            return {
                "coef_": W.cpu().numpy().astype(np.float64),
                "intercept_": b.cpu().numpy().astype(np.float64),
                "classes_": np.asarray(classes, dtype=np.float64),
                "n_cols": inputs.n_cols,
                "dtype": str(inputs.dtype),
                "num_iters": n_iter,
            }

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "LogisticRegressionModel":
        return LogisticRegressionModel(**result)

    def fitMultiple(self, dataset: Any, paramMaps: Any):
        raise NotImplementedError("LogisticRegression.fitMultiple " + _NOT_PORTED.format("A7"))

    def _fitBatchedSweep(self, *args: Any, **kwargs: Any):
        raise NotImplementedError("LogisticRegression._fitBatchedSweep " + _NOT_PORTED.format("A7"))

    def streaming(self, classes: Any = None):
        raise NotImplementedError("LogisticRegression.streaming() " + _NOT_PORTED.format("A12"))


class LogisticRegressionModel(_LogisticRegressionParams, _TpuModelWithPredictionCol):
    def __init__(
        self,
        coef_: np.ndarray,
        intercept_: np.ndarray,
        classes_: np.ndarray,
        n_cols: int,
        dtype: str,
        num_iters: Union[int, List[int]] = 0,
    ) -> None:
        super().__init__(
            coef_=np.asarray(coef_),
            intercept_=np.asarray(intercept_),
            classes_=np.asarray(classes_),
            n_cols=int(n_cols),
            dtype=str(dtype),
            num_iters=num_iters,
        )
        self.coef_ = np.asarray(coef_)
        self.intercept_ = np.asarray(intercept_)
        self.classes_ = np.asarray(classes_)
        self.n_cols = int(n_cols)
        self.dtype = str(dtype)
        self.num_iters = num_iters
        self._num_classes = len(self.classes_)

    @property
    def numClasses(self) -> int:
        return self._num_classes

    @property
    def coefficients(self) -> np.ndarray:
        if self.coef_.shape[0] == 1:
            return self.coef_[0]
        raise AttributeError(
            "Multinomial models contain a matrix of coefficients, use coefficientMatrix instead."
        )

    @property
    def intercept(self) -> float:
        if len(self.intercept_) == 1:
            return float(self.intercept_[0])
        raise AttributeError("Multinomial models contain a vector of intercepts, use interceptVector instead.")

    @property
    def coefficientMatrix(self) -> np.ndarray:
        return self.coef_

    @property
    def interceptVector(self) -> Any:
        """The intercepts, dense or sparse by Spark's compression rule
        (sparse when 1.5 (nnz + 1) < size): a pyspark Vector when pyspark is
        installed, else the numpy array."""
        intercepts = self.intercept_
        try:
            from pyspark.ml.linalg import Vectors
        except ImportError:
            return intercepts
        nnz = int(np.count_nonzero(intercepts))
        if 1.5 * (nnz + 1.0) < len(intercepts):
            return Vectors.sparse(len(intercepts), {i: float(v) for i, v in enumerate(intercepts) if v != 0})
        return Vectors.dense(list(intercepts))

    def _device_params(self, np_dtype: np.dtype):
        dev = _device.resolve()
        W = torch.as_tensor(self.coef_.astype(np_dtype), device=dev)
        b = torch.as_tensor(self.intercept_.astype(np_dtype), device=dev)
        return W, b

    def _scores(self, value: np.ndarray) -> torch.Tensor:
        np_dtype = self._transform_dtype(self.dtype)
        W, b = self._device_params(np_dtype)
        x = torch.as_tensor(np.asarray(value, np_dtype)[None, :], device=W.device)
        return logistic_decision_kernel(x, W, b)

    def predict(self, value: np.ndarray) -> float:
        idx = int(scores_to_labels(self._scores(value), self._num_classes)[0])
        return float(self.classes_[idx])

    def predictProbability(self, value: np.ndarray) -> np.ndarray:
        return scores_to_probs(self._scores(value), self._num_classes)[0].cpu().numpy()

    def cpu(self):
        raise NotImplementedError("LogisticRegressionModel.cpu() " + _NOT_PORTED.format("A14c"))

    def _serving_entry(self, mesh: Any = None):
        raise NotImplementedError("LogisticRegressionModel._serving_entry " + _NOT_PORTED.format("A13"))

    def _lane_entry(self, mesh: Any = None):
        raise NotImplementedError("LogisticRegressionModel._lane_entry " + _NOT_PORTED.format("A13"))

    @classmethod
    def _combine(cls, models: List["LogisticRegressionModel"]):
        raise NotImplementedError("LogisticRegressionModel._combine " + _NOT_PORTED.format("A7"))

    def _transformEvaluate(self, dataset: Any, evaluator: Any, params: Any = None):
        raise NotImplementedError("LogisticRegressionModel._transformEvaluate " + _NOT_PORTED.format("A7"))

    def _out_columns(self) -> List[str]:
        return [
            self.getOrDefault("predictionCol"),
            self.getOrDefault("probabilityCol"),
            self.getOrDefault("rawPredictionCol"),
        ]

    def _get_tpu_transform_func(self, dataset: DataFrame):
        np_dtype = self._transform_dtype(self.dtype)
        W, b = self._device_params(np_dtype)
        classes = self.classes_
        num_classes = self._num_classes
        pred_col = self.getOrDefault("predictionCol")
        prob_col = self.getOrDefault("probabilityCol")
        raw_col = self.getOrDefault("rawPredictionCol")

        def _transform(features: Any) -> Dict[str, Any]:
            if hasattr(features, "tocsr"):  # a CSR partition: ELL on the device
                X = ell_device_from_scipy(features, np_dtype, W.device, transpose=False)
            else:
                X = torch.from_numpy(np.ascontiguousarray(features, dtype=np_dtype)).to(W.device)
            scores = logistic_decision_kernel(X, W, b)
            probs = scores_to_probs(scores, num_classes).cpu().numpy().astype(np.float64)
            idx = scores_to_labels(scores, num_classes).cpu().numpy().astype(np.int64)
            raw = scores.cpu().numpy().astype(np.float64)
            if num_classes == 2 and raw.shape[1] == 1:
                raw = np.concatenate([-raw, raw], axis=1)
            return {pred_col: classes[idx].astype(np.float64), prob_col: probs, raw_col: raw}

        return _transform
