#
# Regression metrics from mergeable moment statistics.
#
# Counterpart of spark_rapids_ml_tpu/metrics/regression.py, this package's
# own copy (numpy only; the port never imports the JAX package).  Spark's
# SummarizerBuffer / RegressionMetrics over the three series [label,
# label - prediction, prediction]; partition partials merge by the Chan et
# al. update, so a merge of partials equals the whole.
#

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


class _SummarizerBuffer:
    """Mergeable per-column statistics: mean, m2n (= variance * N),
    m2 (= sum x^2), l1 (= sum |x|), total count."""

    def __init__(
        self,
        mean: Sequence[float],
        m2n: Sequence[float],
        m2: Sequence[float],
        l1: Sequence[float],
        total_cnt: int,
    ):
        self.mean_ = np.asarray(mean, dtype=np.float64)
        self.m2n_ = np.asarray(m2n, dtype=np.float64)
        self.m2_ = np.asarray(m2, dtype=np.float64)
        self.l1_ = np.asarray(l1, dtype=np.float64)
        self.count = int(total_cnt)

    @classmethod
    def from_arrays(cls, labels: np.ndarray, preds: np.ndarray) -> "_SummarizerBuffer":
        """Compute one partition's partial statistics from raw columns."""
        cols = np.stack(
            [
                np.asarray(labels, np.float64),
                np.asarray(labels, np.float64) - np.asarray(preds, np.float64),
                np.asarray(preds, np.float64),
            ],
            axis=1,
        )
        n = cols.shape[0]
        mean = cols.mean(axis=0) if n else np.zeros(3)
        return cls(
            mean=mean,
            m2n=((cols - mean) ** 2).sum(axis=0) if n else np.zeros(3),
            m2=(cols**2).sum(axis=0),
            l1=np.abs(cols).sum(axis=0),
            total_cnt=n,
        )

    def merge(self, other: "_SummarizerBuffer") -> "_SummarizerBuffer":
        n1, n2 = self.count, other.count
        n = n1 + n2
        if n == 0:
            return _SummarizerBuffer(self.mean_, self.m2n_, self.m2_, self.l1_, 0)
        delta = other.mean_ - self.mean_
        mean = self.mean_ + delta * (n2 / n)
        m2n = self.m2n_ + other.m2n_ + delta * delta * (n1 * n2 / n)
        return _SummarizerBuffer(mean, m2n, self.m2_ + other.m2_, self.l1_ + other.l1_, n)

    # -- accessors (Spark SummarizerBuffer surface) ------------------------
    @property
    def total_count(self) -> int:
        return self.count

    @property
    def weight_sum(self) -> float:
        # weightCol not supported: weight == 1 per sample (reference
        # RegressionMetrics.py:60-62)
        return float(self.count)

    @property
    def m2(self) -> List[float]:
        return self.m2_.tolist()

    @property
    def norm_l1(self) -> List[float]:
        return self.l1_.tolist()

    @property
    def mean(self) -> List[float]:
        return self.mean_.tolist()

    @property
    def variance(self) -> List[float]:
        denom = self.weight_sum - 1.0
        if denom > 0:
            return np.maximum(self.m2n_ / denom, 0.0).tolist()
        return [0.0] * 3


class RegressionMetrics:
    """Spark-aligned regression metrics over a merged _SummarizerBuffer."""

    def __init__(self, summary: _SummarizerBuffer):
        self._summary = summary

    @staticmethod
    def create(mean, m2n, m2, l1, total_cnt) -> "RegressionMetrics":
        return RegressionMetrics(_SummarizerBuffer(mean, m2n, m2, l1, total_cnt))

    @classmethod
    def from_arrays(cls, labels: np.ndarray, preds: np.ndarray) -> "RegressionMetrics":
        return cls(_SummarizerBuffer.from_arrays(labels, preds))

    def to_row(self, model_index: int) -> dict:
        """JSON-safe partial tagged with its model index; inverse of
        _from_rows (the executor-side evaluate ships partials this way,
        reference RegressionMetrics.py:175-195)."""
        s = self._summary
        return {
            "model_index": model_index,
            "mean": s.mean_.tolist(),
            "m2n": s.m2n_.tolist(),
            "m2": s.m2_.tolist(),
            "l1": s.l1_.tolist(),
            "total_count": s.count,
        }

    @classmethod
    def _from_rows(cls, num_models: int, rows: List[dict]) -> List["RegressionMetrics"]:
        """Merge per-partition metric rows tagged with model_index (reference
        RegressionMetrics.py:175-195)."""
        out: List[RegressionMetrics] = [None] * num_models  # type: ignore[list-item]
        for row in rows:
            metric = cls.create(
                row["mean"], row["m2n"], row["m2"], row["l1"], row["total_count"]
            )
            i = row["model_index"]
            out[i] = metric if out[i] is None else out[i].merge(metric)
        return out

    def merge(self, other: "RegressionMetrics") -> "RegressionMetrics":
        return RegressionMetrics(self._summary.merge(other._summary))

    @property
    def _ss_y(self) -> float:
        return self._summary.m2[0]

    @property
    def _ss_err(self) -> float:
        return self._summary.m2[1]

    @property
    def _ss_tot(self) -> float:
        return self._summary.variance[0] * (self._summary.weight_sum - 1)

    @property
    def _ss_reg(self) -> float:
        m = self._summary
        return (
            m.m2[2]
            + m.mean[0] ** 2 * m.weight_sum
            - 2 * m.mean[0] * m.mean[2] * m.weight_sum
        )

    @property
    def mean_squared_error(self) -> float:
        return self._ss_err / self._summary.weight_sum

    @property
    def root_mean_squared_error(self) -> float:
        return math.sqrt(self.mean_squared_error)

    def r2(self, through_origin: bool) -> float:
        if through_origin:
            return 1 - self._ss_err / self._ss_y
        return 1 - self._ss_err / self._ss_tot

    @property
    def mean_absolute_error(self) -> float:
        return self._summary.norm_l1[1] / self._summary.weight_sum

    @property
    def explained_variance(self) -> float:
        return self._ss_reg / self._summary.weight_sum

    def evaluate(self, evaluator) -> float:
        name = evaluator.getMetricName()
        if name == "rmse":
            return self.root_mean_squared_error
        if name == "mse":
            return self.mean_squared_error
        if name == "r2":
            through_origin = (
                evaluator.getThroughOrigin()
                if hasattr(evaluator, "getThroughOrigin")
                else False
            )
            return self.r2(through_origin)
        if name == "mae":
            return self.mean_absolute_error
        if name == "var":
            return self.explained_variance
        raise ValueError(f"Unsupported metric name, found {name}")
