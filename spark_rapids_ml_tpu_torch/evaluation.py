#
# Evaluators: pyspark.ml.evaluation-compatible stand-ins that score the
# DataFrame facade's partitions.
#
# Counterpart of spark_rapids_ml_tpu/evaluation.py: the same param surface
# and metric names, and an evaluate(dataset) that merges each partition's
# partial statistics (metrics/).  The columns are read from the port's
# Partition arrays, not from pandas: a probability or rawPrediction column
# is a 2-D (rows, classes) block, a features column a 2-D block (or CSR).
# A live pyspark prediction frame is evaluated on the executors
# (spark/adapter.executor_evaluate: each task's merged partials, and the
# two-pass silhouette), never collected; SRML_SPARK_COLLECT=1 collects it.
#

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from .dataframe import DataFrame, Partition, as_dataframe
from .metrics.binary import BinaryClassificationMetrics
from .metrics.clustering import silhouette_score
from .metrics.multiclass import MulticlassMetrics
from .metrics.regression import RegressionMetrics
from .params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasProbabilityCol,
    HasRawPredictionCol,
    HasWeightCol,
    Param,
    Params,
    TypeConverters,
    _dummy,
)


class Evaluator(Params):
    def evaluate(self, dataset: Any) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True

    def _evaluate_executor_side(self, dataset: Any) -> Optional[float]:
        """The score of a live pyspark prediction frame, computed on the
        executors (spark/adapter.executor_evaluate); None for any other
        frame (the caller takes the local route)."""
        from .core import _use_executor_path

        if not _use_executor_path(dataset):
            return None
        from .spark.adapter import executor_evaluate

        return executor_evaluate(dataset, self)

    def _evaluate_merged(self, dataset: Any) -> float:
        """The executor route's score, or the merge of the partitions'
        partial statistics, scored."""
        spark_score = self._evaluate_executor_side(dataset)
        if spark_score is not None:
            return spark_score
        return self._merged(dataset).evaluate(self)

    def _merged(self, dataset: Any) -> Any:
        """The merge of the partitions' partial statistics."""
        metrics = None
        for part in as_dataframe(dataset).partitions:
            if len(part) == 0:
                continue
            m = self._partial_metrics_frame(part)
            metrics = m if metrics is None else metrics.merge(m)
        assert metrics is not None, "empty dataset"
        return metrics

    def _partial_metrics_frame(self, part: Partition) -> Any:
        raise NotImplementedError


def _set_kwargs(instance: Params, kwargs: dict) -> None:
    for k, v in kwargs.items():
        instance.set(instance.getParam(k), v)


class RegressionEvaluator(Evaluator, HasLabelCol, HasPredictionCol, HasWeightCol):
    """pyspark RegressionEvaluator's metrics: rmse (default), mse, r2, mae,
    var."""

    metricName = Param(_dummy(), "metricName", "metric name in evaluation (mse|rmse|r2|mae|var)", TypeConverters.toString)
    throughOrigin = Param(_dummy(), "throughOrigin", "whether the regression is through the origin", TypeConverters.toBoolean)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(metricName="rmse", throughOrigin=False)
        _set_kwargs(self, kwargs)

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def setMetricName(self, value: str) -> "RegressionEvaluator":
        self.set(self.getParam("metricName"), value)
        return self

    def getThroughOrigin(self) -> bool:
        return self.getOrDefault("throughOrigin")

    def setLabelCol(self, value: str) -> "RegressionEvaluator":
        self.set(self.getParam("labelCol"), value)
        return self

    def setPredictionCol(self, value: str) -> "RegressionEvaluator":
        self.set(self.getParam("predictionCol"), value)
        return self

    def isLargerBetter(self) -> bool:
        return self.getMetricName() in ("r2", "var")

    def _partial_metrics_frame(self, part: Partition) -> RegressionMetrics:
        return RegressionMetrics.from_arrays(
            np.asarray(part[self.getOrDefault("labelCol")]),
            np.asarray(part[self.getOrDefault("predictionCol")]),
        )

    def evaluate(self, dataset: Any) -> float:
        return self._evaluate_merged(dataset)


class MulticlassClassificationEvaluator(Evaluator, HasLabelCol, HasPredictionCol, HasProbabilityCol, HasWeightCol):
    """pyspark MulticlassClassificationEvaluator's metrics (f1 by default,
    accuracy, the weighted and by-label rates, hammingLoss, logLoss with
    eps 1e-15)."""

    metricName = Param(_dummy(), "metricName", "metric name in evaluation", TypeConverters.toString)
    metricLabel = Param(
        _dummy(), "metricLabel", "the class whose metric will be computed in by-label metrics", TypeConverters.toFloat
    )
    beta = Param(_dummy(), "beta", "beta value in weightedFMeasure|fMeasureByLabel", TypeConverters.toFloat)
    eps = Param(_dummy(), "eps", "log-loss epsilon", TypeConverters.toFloat)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(metricName="f1", metricLabel=0.0, beta=1.0, eps=1.0e-15)
        _set_kwargs(self, kwargs)

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def setMetricName(self, value: str) -> "MulticlassClassificationEvaluator":
        self.set(self.getParam("metricName"), value)
        return self

    def getMetricLabel(self) -> float:
        return self.getOrDefault("metricLabel")

    def getBeta(self) -> float:
        return self.getOrDefault("beta")

    def getEps(self) -> float:
        return self.getOrDefault("eps")

    def setLabelCol(self, value: str) -> "MulticlassClassificationEvaluator":
        self.set(self.getParam("labelCol"), value)
        return self

    def setPredictionCol(self, value: str) -> "MulticlassClassificationEvaluator":
        self.set(self.getParam("predictionCol"), value)
        return self

    def isLargerBetter(self) -> bool:
        return self.getMetricName() not in (
            "weightedFalsePositiveRate",
            "falsePositiveRateByLabel",
            "hammingLoss",
            "logLoss",
        )

    def _partial_metrics_frame(self, part: Partition) -> MulticlassMetrics:
        probs = (
            np.asarray(part[self.getOrDefault("probabilityCol")])
            if self.getMetricName() == "logLoss"
            else None
        )
        return MulticlassMetrics.from_arrays(
            np.asarray(part[self.getOrDefault("labelCol")]),
            np.asarray(part[self.getOrDefault("predictionCol")]),
            probs=probs,
            eps=self.getEps(),
        )

    def evaluate(self, dataset: Any) -> float:
        return self._evaluate_merged(dataset)


class ClusteringEvaluator(Evaluator, HasFeaturesCol, HasPredictionCol):
    """pyspark ClusteringEvaluator: the silhouette with squared euclidean
    distance (Spark's default), in Spark's mergeable two-pass form
    (metrics/clustering.py), equal to
    sklearn.metrics.silhouette_score(metric="sqeuclidean")."""

    metricName = Param(_dummy(), "metricName", "metric name in evaluation (silhouette)", TypeConverters.toString)
    distanceMeasure = Param(_dummy(), "distanceMeasure", "distance measure (squaredEuclidean)", TypeConverters.toString)

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(metricName="silhouette", distanceMeasure="squaredEuclidean")
        _set_kwargs(self, kwargs)

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def getDistanceMeasure(self) -> str:
        return self.getOrDefault("distanceMeasure")

    def setPredictionCol(self, value: str) -> "ClusteringEvaluator":
        self.set(self.getParam("predictionCol"), value)
        return self

    def isLargerBetter(self) -> bool:
        return True

    def _check_config(self) -> None:
        if self.getMetricName() != "silhouette":
            raise ValueError(f"Unsupported metric name, found {self.getMetricName()}")
        if self.getDistanceMeasure() != "squaredEuclidean":
            raise NotImplementedError(
                "only distanceMeasure='squaredEuclidean' is implemented (pyspark's default)"
            )

    def evaluate(self, dataset: Any) -> float:
        self._check_config()
        spark_score = self._evaluate_executor_side(dataset)
        if spark_score is not None:
            return spark_score
        df: DataFrame = as_dataframe(dataset)
        feat_col = self.getOrDefault("featuresCol")
        pred_col = self.getOrDefault("predictionCol")
        feats: List[np.ndarray] = []
        preds: List[np.ndarray] = []
        for part in df.partitions:
            if len(part) == 0:
                continue
            block = part[feat_col]
            feats.append(np.asarray(block.toarray() if hasattr(block, "tocsr") else block, np.float64))
            preds.append(np.asarray(part[pred_col]))
        assert feats, "empty dataset"
        k = int(max(p.max() for p in preds)) + 1
        return silhouette_score(feats, preds, k)


class BinaryClassificationEvaluator(Evaluator, HasLabelCol, HasRawPredictionCol, HasWeightCol):
    """areaUnderROC / areaUnderPR over the rawPrediction column (the last
    column of a 2-D block: the positive class's score), from mergeable
    per-partition partials (metrics/binary.py)."""

    metricName = Param(
        _dummy(), "metricName", "metric name in evaluation (areaUnderROC|areaUnderPR)", TypeConverters.toString
    )

    def __init__(self, **kwargs: Any) -> None:
        super().__init__()
        self._setDefault(metricName="areaUnderROC")
        _set_kwargs(self, kwargs)

    def getMetricName(self) -> str:
        return self.getOrDefault("metricName")

    def setMetricName(self, value: str) -> "BinaryClassificationEvaluator":
        self.set(self.getParam("metricName"), value)
        return self

    def setLabelCol(self, value: str) -> "BinaryClassificationEvaluator":
        self.set(self.getParam("labelCol"), value)
        return self

    def setRawPredictionCol(self, value: str) -> "BinaryClassificationEvaluator":
        self.set(self.getParam("rawPredictionCol"), value)
        return self

    def _partial_metrics_frame(self, part: Partition) -> BinaryClassificationMetrics:
        raw = np.asarray(part[self.getOrDefault("rawPredictionCol")])
        if raw.ndim == 2:
            raw = raw[:, -1]  # the positive class's score
        weight_col: Optional[str] = (
            self.getOrDefault("weightCol") if self.hasParam("weightCol") and self.isSet("weightCol") else None
        )
        weights = np.asarray(part[weight_col]) if weight_col is not None else None
        return BinaryClassificationMetrics.from_arrays(np.asarray(part[self.getOrDefault("labelCol")]), raw, weights)

    def evaluate(self, dataset: Any) -> float:
        return self._evaluate_merged(dataset)
