#
# KMeans estimator/model.
#
# Counterpart of spark_rapids_ml_tpu/models/kmeans.py: the same Spark param
# mapping and solver defaults, the same model attributes (cluster_centers_,
# n_cols, dtype, n_iter_, inertia_) and an int32 prediction column.  The
# solver is ops/kmeans.py over the fit's row shards (core.FitInputs: one
# shard on a one-device mesh); transform/predict run the hand-written CUDA
# nearest-center kernel (B1) partition by partition on the card.
#
# streaming() returns the partial_fit / merge / finalize engine
# (stream/engines.StreamingKMeans: the first chunk's init and Lloyd, then
# mini-batch updates of the running centers).
#
# _serving_entry serves nearest-center assignment: each padded batch is one
# launch of the CUDA nearest-center kernel (serving/entry.kernel_entry).
# _lane_entry is the multiplexed hook (serving/multiplex.py): the centers as
# one lane of ops/kmeans.lane_kmeans_predict_kernel, which launches the same
# kernel once per distinct lane of a batch.
#
# cpu() converts to a pyspark.ml KMeansModel (spark/interop.py; it needs
# pyspark and an active SparkSession).  The executor transform declares the
# prediction column int (_OUT_COLUMN_DDL).
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
    lane_kmeans_predict_kernel,
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
    """KMeans over the fit's row shards (Lloyd + k-means|| init), with the
    Spark ML KMeans API."""

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._initialize_tpu_params()
        self._set_params(**kwargs)

    def _get_tpu_fit_func(self, dataset: DataFrame):
        logger = get_logger(type(self))

        def _fit(inputs: FitInputs, params: Dict[str, Any]) -> Dict[str, Any]:
            k = int(params["n_clusters"])
            generator = torch.Generator().manual_seed(int(params["random_state"]) & 0x7FFFFFFF)
            chunk = min(int(params["max_samples_per_batch"]), inputs.n_pad)
            if params["init"] == "random":
                centers0 = random_init(inputs.X, inputs.weight, k, generator, n_rows=inputs.n_rows)
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
                    n_rows=inputs.n_rows,
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

    def streaming(self, **kwargs: Any):
        """The streaming engine over this estimator (partial_fit / merge /
        finalize; stream/engines.StreamingKMeans)."""
        from ..stream.engines import StreamingKMeans

        return StreamingKMeans(self, **kwargs)


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

    _OUT_COLUMN_DDL = {**_TpuModelWithPredictionCol._OUT_COLUMN_DDL, "predictionCol": "int"}

    def clusterCenters(self) -> List[np.ndarray]:
        """Spark KMeansModel.clusterCenters."""
        return list(self.cluster_centers_)

    def cpu(self):
        """This model as a pyspark.ml.clustering.KMeansModel (needs pyspark
        and an active SparkSession)."""
        from ..spark.interop import to_spark_kmeans_model

        return to_spark_kmeans_model(self)

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

    def _serving_entry(self, mesh: Any = None):
        """Online inference hook (serving/): nearest-center assignment of a
        padded batch, one kernel launch, on the mesh's first device (the
        entry points' device without a mesh)."""
        from ..serving.entry import kernel_entry

        np_dtype = self._transform_dtype(self.dtype)
        dev = mesh.devices[0] if mesh is not None else _device.resolve()
        centers = torch.as_tensor(np.ascontiguousarray(self.cluster_centers_, dtype=np_dtype), device=dev)
        pred_col = self.getOrDefault("predictionCol")
        return kernel_entry(
            "serve.kmeans",
            kmeans_predict_kernel,
            (centers,),
            lambda out: {pred_col: out[0]},
            device=dev,
            dtype=np_dtype,
            n_cols=self.n_cols,
            out_cols=[pred_col],
            info={"k": len(self.cluster_centers_)},
        )

    def _lane_entry(self, mesh: Any = None):
        """Multiplexed serving hook (serving/multiplex): this model's
        centers as ONE lane of the lane-stacked nearest-center kernel —
        variants must share k (the leaf-shape check in lane_signature
        enforces it)."""
        from ..serving.multiplex import LaneEntry

        np_dtype = self._transform_dtype(self.dtype)
        centers = np.ascontiguousarray(np.asarray(self.cluster_centers_, dtype=np_dtype))
        pred_col = self.getOrDefault("predictionCol")
        return LaneEntry(
            name="lanes.kmeans",
            n_cols=self.n_cols,
            dtype=np_dtype,
            out_cols=[pred_col],
            leaves=(centers,),
            kernel=lane_kmeans_predict_kernel,
            statics={},
            postprocess=lambda out: {pred_col: out[0]},
            info={"k": len(self.cluster_centers_)},
            device=mesh.devices[0] if mesh is not None else _device.resolve(),
        )

    def _get_tpu_transform_func(self, dataset: DataFrame):
        np_dtype = self._transform_dtype(self.dtype)
        centers = self._device_centers(np_dtype)  # uploaded once per call
        pred_col = self.getOrDefault("predictionCol")

        def _transform(features: np.ndarray) -> Dict[str, np.ndarray]:
            X = torch.from_numpy(features).to(centers.device)
            return {pred_col: kmeans_predict_kernel(X, centers).cpu().numpy()}

        return _transform
