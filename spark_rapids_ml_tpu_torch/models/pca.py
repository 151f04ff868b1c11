#
# PCA estimator/model.
#
# Counterpart of spark_rapids_ml_tpu/models/pca.py: the same Spark param
# surface ({k: n_components}, inputCol(s), outputCol), the same model
# attributes (mean_, components_, explained_variance_,
# explained_variance_ratio_, singular_values_, n_cols, dtype; float64) and
# Spark's transform semantics (no mean removal at transform time; whiten
# scales each component by 1 / sqrt(its variance)).  The fit is
# ops/linalg.pca_fit on one device: chunked moments, covariance in the
# compute dtype, a float64 eigh on the card.
#
# Not carried over yet: streaming() (ROADMAP A12), the serving hooks
# _serving_entry / _lane_entry (A13) and cpu() (A14c); each raises
# NotImplementedError.
#

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as _device
from ..core import FitInputs, _TpuEstimator, _TpuModel
from ..dataframe import DataFrame
from ..ops.linalg import pca_fit, pca_transform_kernel
from ..params import (
    HasInputCol,
    HasInputCols,
    HasOutputCol,
    HasVerbose,
    Param,
    TypeConverters,
    _dummy,
    _TpuParams,
)

_NOT_PORTED = "is not in this port yet (ROADMAP {})"


class PCAClass(_TpuParams):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        return {"k": "n_components"}

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_components": None,
            "svd_solver": "auto",
            "verbose": False,
            "whiten": False,
        }


class _PCAParams(PCAClass, HasInputCol, HasInputCols, HasOutputCol, HasVerbose):
    k = Param(_dummy(), "k", "the number of principal components (> 0)", TypeConverters.toInt)

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(inputCol="features", outputCol="pca_features")

    def getK(self) -> int:
        return self.getOrDefault("k")

    def setK(self, value: int):
        return self._set_params(k=value)

    def setInputCol(self, value: Union[str, List[str]]):
        if isinstance(value, str):
            return self._set_params(inputCol=value)
        return self._set_params(inputCols=value)

    def setInputCols(self, value: List[str]):
        return self._set_params(inputCols=value)

    def setOutputCol(self, value: str):
        return self._set_params(outputCol=value)


class PCA(_PCAParams, _TpuEstimator):
    """PCA on one device: weighted moments over row chunks, a float64 eigh
    of the covariance, deterministic component signs."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._initialize_tpu_params()
        self._set_params(**kwargs)

    def _get_tpu_fit_func(self, dataset: DataFrame):
        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            k = params.get("n_components") or min(inputs.n_rows, inputs.n_cols)
            k = min(int(k), inputs.n_cols)
            with record_function("pca.fit"):
                mean, components, var, ratio, sv = pca_fit(inputs.X, inputs.weight, k)
            # whiten is honoured at transform time
            return {
                "mean_": mean.cpu().numpy(),
                "components_": components.cpu().numpy(),
                "explained_variance_": var.cpu().numpy(),
                "explained_variance_ratio_": ratio.cpu().numpy(),
                "singular_values_": sv.cpu().numpy(),
                "n_cols": inputs.n_cols,
                "dtype": str(inputs.dtype),
            }

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "PCAModel":
        return PCAModel(**result)

    def streaming(self):
        raise NotImplementedError("PCA.streaming() " + _NOT_PORTED.format("A12"))


class PCAModel(_PCAParams, _TpuModel):
    def __init__(
        self,
        mean_: np.ndarray,
        components_: np.ndarray,
        explained_variance_: np.ndarray,
        explained_variance_ratio_: np.ndarray,
        singular_values_: np.ndarray,
        n_cols: int,
        dtype: str,
    ) -> None:
        super().__init__(
            mean_=np.asarray(mean_),
            components_=np.asarray(components_),
            explained_variance_=np.asarray(explained_variance_),
            explained_variance_ratio_=np.asarray(explained_variance_ratio_),
            singular_values_=np.asarray(singular_values_),
            n_cols=int(n_cols),
            dtype=str(dtype),
        )
        self.mean_ = np.asarray(mean_)
        self.components_ = np.asarray(components_)
        self.explained_variance_ = np.asarray(explained_variance_)
        self.explained_variance_ratio_ = np.asarray(explained_variance_ratio_)
        self.singular_values_ = np.asarray(singular_values_)
        self.n_cols = int(n_cols)
        self.dtype = str(dtype)
        self._set_params(k=len(self.components_))

    @property
    def mean(self) -> List[float]:
        return self.mean_.tolist()

    @property
    def pc(self) -> np.ndarray:
        """Principal components, one per column (Spark's DenseMatrix layout)."""
        return self.components_.T

    @property
    def explainedVariance(self) -> np.ndarray:
        return self.explained_variance_ratio_

    def cpu(self):
        raise NotImplementedError("PCAModel.cpu() " + _NOT_PORTED.format("A14c"))

    def _serving_entry(self, mesh: Any = None):
        raise NotImplementedError("PCAModel._serving_entry " + _NOT_PORTED.format("A13"))

    def _lane_entry(self, mesh: Any = None):
        raise NotImplementedError("PCAModel._lane_entry " + _NOT_PORTED.format("A13"))

    def _out_columns(self) -> List[str]:
        return [self.getOrDefault("outputCol")]

    def _projection(self, np_dtype: np.dtype) -> np.ndarray:
        """The (k, D) matrix transform multiplies by: the components, scaled
        to unit variance when whiten (uncentred: Spark never centres)."""
        comps = np.asarray(self.components_, dtype=np_dtype)
        if self._tpu_params.get("whiten"):
            scale = 1.0 / np.sqrt(np.maximum(self.explained_variance_, 1e-12)).astype(np_dtype)
            comps = comps * scale[:, None]
        return comps

    def _get_tpu_transform_func(self, dataset: DataFrame):
        np_dtype = self._transform_dtype(self.dtype)
        components = torch.as_tensor(self._projection(np_dtype), device=_device.resolve())
        out_col = self.getOrDefault("outputCol")

        def _transform(features: np.ndarray) -> Dict[str, Any]:
            X = torch.from_numpy(np.ascontiguousarray(features, dtype=np_dtype)).to(components.device)
            return {out_col: pca_transform_kernel(X, components).cpu().numpy()}

        return _transform
