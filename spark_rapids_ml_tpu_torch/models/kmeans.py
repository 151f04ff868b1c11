#
# KMeans estimator/model.
#
# Counterpart of spark_rapids_ml_tpu/models/kmeans.py: the same Spark param
# mapping and solver defaults, the same model attributes (cluster_centers_,
# n_cols, dtype, n_iter_, inertia_) and an int32 prediction column.  The
# solver is ops/kmeans.py on one device; transform/predict run the
# hand-written CUDA nearest-center kernel on the card.
#
# Not carried over yet: cpu() (pyspark.ml conversion), streaming(), and the
# serving hooks _serving_entry / _lane_entry.
#

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import device as _device
from ..core import FitInputs, _TpuEstimator, _TpuModelWithPredictionCol
from ..dataframe import DataFrame
from ..ops.kmeans import (
    kmeans_predict_kernel,
    lloyd_iterations,
    random_init,
    scalable_kmeans_pp_init,
)
from ..params import (
    HasFeaturesCol,
    HasFeaturesCols,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
    HasTol,
    HasVerbose,
    HasWeightCol,
    Param,
    TypeConverters,
    _dummy,
    _TpuParams,
)
from ..utils import get_logger


class KMeansClass(_TpuParams):
    @classmethod
    def _param_mapping(cls) -> Dict[str, Optional[str]]:
        # distanceMeasure/weightCol unsupported, initSteps/solver/
        # maxBlockSizeInMB silently ignored
        return {
            "distanceMeasure": None,
            "initMode": "init",
            "k": "n_clusters",
            "initSteps": "",
            "maxIter": "max_iter",
            "seed": "random_state",
            "tol": "tol",
            "weightCol": None,
            "solver": "",
            "maxBlockSizeInMB": "",
        }

    @classmethod
    def _param_value_mapping(cls):
        return {
            "init": lambda v: {
                "k-means||": "scalable-k-means++",
                "random": "random",
                "scalable-k-means++": "scalable-k-means++",
            }.get(v)
        }

    @classmethod
    def _get_tpu_params_default(cls) -> Dict[str, Any]:
        return {
            "n_clusters": 8,
            "max_iter": 300,
            "tol": 0.0001,
            "verbose": False,
            "random_state": 1,
            "init": "scalable-k-means++",
            "n_init": 1,
            "oversampling_factor": 2.0,
            "max_samples_per_batch": 32768,
        }


class _KMeansParams(
    KMeansClass,
    HasFeaturesCol,
    HasFeaturesCols,
    HasPredictionCol,
    HasMaxIter,
    HasTol,
    HasSeed,
    HasWeightCol,
    HasVerbose,
):
    k = Param(_dummy(), "k", "The number of clusters to create. Must be > 1.", TypeConverters.toInt)
    initMode = Param(
        _dummy(),
        "initMode",
        'The initialization algorithm. Supported options: "random" and "k-means||".',
        TypeConverters.toString,
    )
    initSteps = Param(
        _dummy(), "initSteps", "The number of steps for k-means|| initialization mode. Must be > 0.", TypeConverters.toInt
    )
    distanceMeasure = Param(
        _dummy(), "distanceMeasure", "the distance measure", TypeConverters.toString
    )

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._setDefault(
            k=2, initMode="k-means||", initSteps=2, maxIter=20, tol=0.0001
        )

    def getK(self) -> int:
        return self.getOrDefault("k")

    def setK(self, value: int):
        return self._set_params(k=value)

    def setInitMode(self, value: str):
        return self._set_params(initMode=value)

    def setMaxIter(self, value: int):
        return self._set_params(maxIter=value)

    def setTol(self, value: float):
        return self._set_params(tol=value)

    def setSeed(self, value: int):
        return self._set_params(seed=value)

    def setWeightCol(self, value: str):
        raise ValueError("'weightCol' is not supported.")


class KMeans(_KMeansParams, _TpuEstimator):
    """KMeans on one device (Lloyd + k-means|| init), with the Spark ML
    KMeans API."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._initialize_tpu_params()
        self._set_params(**kwargs)

    def _get_tpu_fit_func(self, dataset: DataFrame):
        logger = get_logger(type(self))

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            k = int(params["n_clusters"])
            generator = torch.Generator().manual_seed(int(params["random_state"]) & 0x7FFFFFFF)
            chunk = min(int(params["max_samples_per_batch"]), inputs.X.shape[0])
            if params["init"] == "random":
                centers0 = random_init(inputs.X, inputs.weight, k, generator)
            else:
                oversample = float(params["oversampling_factor"])
                round_size = max(1, min(int(oversample * k), inputs.n_rows))
                centers0 = scalable_kmeans_pp_init(
                    inputs.X,
                    inputs.weight,
                    k,
                    generator,
                    rounds=4,
                    round_size=round_size,
                    chunk=chunk,
                )
            centers, n_iter, inertia = lloyd_iterations(
                inputs.X,
                inputs.weight,
                centers0,
                int(params["max_iter"]),
                float(params["tol"]),
                chunk,
            )
            logger.info("iterations: %d, inertia: %f", n_iter, inertia)
            return {
                "cluster_centers_": centers.cpu().numpy().astype(np.float64),
                "n_cols": inputs.n_cols,
                "dtype": str(inputs.dtype),
                "n_iter_": n_iter,
                "inertia_": inertia,
            }

        return _fit

    def _create_model(self, result: Dict[str, Any]) -> "KMeansModel":
        return KMeansModel(**result)


class KMeansModel(_KMeansParams, _TpuModelWithPredictionCol):
    def __init__(
        self,
        cluster_centers_: np.ndarray,
        n_cols: int,
        dtype: str,
        n_iter_: int = 0,
        inertia_: float = 0.0,
    ) -> None:
        super().__init__(
            cluster_centers_=np.asarray(cluster_centers_),
            n_cols=int(n_cols),
            dtype=str(dtype),
            n_iter_=int(n_iter_),
            inertia_=float(inertia_),
        )
        self.cluster_centers_ = np.asarray(cluster_centers_)
        self.n_cols = int(n_cols)
        self.dtype = str(dtype)
        self.n_iter_ = int(n_iter_)
        self.inertia_ = float(inertia_)

    def clusterCenters(self) -> List[np.ndarray]:
        """Spark KMeansModel.clusterCenters."""
        return list(self.cluster_centers_)

    @property
    def hasSummary(self) -> bool:
        return False

    def _device_centers(self, np_dtype: np.dtype) -> torch.Tensor:
        return torch.as_tensor(
            np.ascontiguousarray(self.cluster_centers_, dtype=np_dtype),
            device=_device.resolve(),
        )

    def predict(self, value: np.ndarray) -> int:
        """Single-vector prediction; the same dtype policy as transform() so
        the two paths agree on borderline points."""
        np_dtype = self._transform_dtype(self.dtype)
        centers = self._device_centers(np_dtype)
        x = torch.as_tensor(np.asarray(value, dtype=np_dtype)[None, :], device=centers.device)
        return int(kmeans_predict_kernel(x, centers)[0])

    def _get_tpu_transform_func(self, dataset: DataFrame):
        np_dtype = self._transform_dtype(self.dtype)
        centers = self._device_centers(np_dtype)  # uploaded once per call
        pred_col = self.getOrDefault("predictionCol")

        def _transform(features: np.ndarray) -> Dict[str, np.ndarray]:
            X = torch.from_numpy(features).to(centers.device)
            return {pred_col: kmeans_predict_kernel(X, centers).cpu().numpy()}

        return _transform
