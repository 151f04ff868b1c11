#
# Binary-classification ranking metrics (areaUnderROC / areaUnderPR) in
# mergeable partial form.
#
# Counterpart of spark_rapids_ml_tpu/metrics/binary.py, this package's own
# copy (numpy only).  A partial is the sufficient statistic of both curves:
# the distinct scores ascending, with the weighted positive and negative
# mass at each.  Merging two partials is a unique-union with summed masses,
# associative and exact.  A cap (`max_bins`, the role of Spark's numBins)
# bounds a partial on high-cardinality scores by grouping adjacent
# thresholds; below the cap the curves are exact (sklearn's roc_auc_score /
# average_precision_score on the same inputs).
#

from __future__ import annotations

from typing import List, Optional

import numpy as np

# far above Spark's numBins=1000 default: tests and typical CV folds stay
# exact; only genuinely high-cardinality score columns compress
DEFAULT_MAX_BINS = 10000


class BinaryClassificationMetrics:
    """Mergeable (scores, pos_w, neg_w) threshold histogram."""

    __slots__ = ("scores", "pos_w", "neg_w", "max_bins")

    def __init__(
        self,
        scores: np.ndarray,
        pos_w: np.ndarray,
        neg_w: np.ndarray,
        max_bins: int = DEFAULT_MAX_BINS,
    ):
        self.scores = np.asarray(scores, np.float64)    # ascending, distinct
        self.pos_w = np.asarray(pos_w, np.float64)
        self.neg_w = np.asarray(neg_w, np.float64)
        self.max_bins = int(max_bins)

    @classmethod
    def from_arrays(
        cls,
        labels: np.ndarray,
        raw: np.ndarray,
        weights: Optional[np.ndarray] = None,
        max_bins: int = DEFAULT_MAX_BINS,
    ) -> "BinaryClassificationMetrics":
        """One partition's partial.  `raw` is the positive-class score
        column (callers unwrap [neg, pos] rawPrediction arrays first);
        labels > 0.5 count as positive (Spark's binary threshold)."""
        labels = np.asarray(labels, np.float64)
        raw = np.asarray(raw, np.float64)
        w = (
            np.ones_like(raw)
            if weights is None
            else np.asarray(weights, np.float64)
        )
        pos = labels > 0.5
        u, inv = np.unique(raw, return_inverse=True)
        pos_w = np.bincount(inv, weights=w * pos, minlength=u.size)
        neg_w = np.bincount(inv, weights=w * (~pos), minlength=u.size)
        return cls(u, pos_w, neg_w, max_bins)._compressed()

    def merge(
        self, other: "BinaryClassificationMetrics"
    ) -> "BinaryClassificationMetrics":
        s = np.concatenate([self.scores, other.scores])
        p = np.concatenate([self.pos_w, other.pos_w])
        n = np.concatenate([self.neg_w, other.neg_w])
        u, inv = np.unique(s, return_inverse=True)
        return BinaryClassificationMetrics(
            u,
            np.bincount(inv, weights=p, minlength=u.size),
            np.bincount(inv, weights=n, minlength=u.size),
            max(self.max_bins, other.max_bins),
        )._compressed()

    def _compressed(self) -> "BinaryClassificationMetrics":
        m = self.scores.size
        if m <= self.max_bins:
            return self
        # equal-count adjacent grouping; each group collapses to ONE tie at
        # its highest score (conservative: candidates inside a group become
        # indistinguishable, the documented numBins-style approximation)
        grp = (np.arange(m, dtype=np.int64) * self.max_bins) // m
        scores = np.zeros(self.max_bins)
        scores[grp] = self.scores  # last write per group wins = group max
        return BinaryClassificationMetrics(
            scores,
            np.bincount(grp, weights=self.pos_w, minlength=self.max_bins),
            np.bincount(grp, weights=self.neg_w, minlength=self.max_bins),
            self.max_bins,
        )

    def _curves(self):
        """Cumulative (tp, fp) walking thresholds from the HIGHEST score
        down — the orientation both curves integrate over."""
        tp = np.cumsum(self.pos_w[::-1])
        fp = np.cumsum(self.neg_w[::-1])
        if tp[-1] <= 0 or fp[-1] <= 0:
            raise ValueError(
                "areaUnder* is undefined with only one class present in "
                "the labels"
            )
        return tp, fp

    def area_under_roc(self) -> float:
        tp, fp = self._curves()
        tpr = np.concatenate([[0.0], tp / tp[-1]])
        fpr = np.concatenate([[0.0], fp / fp[-1]])
        # explicit trapezoid (np.trapz is deprecated in numpy 2.x and
        # np.trapezoid absent in 1.x — the sum below is both and exact)
        return float(
            (np.diff(fpr) * (tpr[1:] + tpr[:-1]) * 0.5).sum()
        )

    def area_under_pr(self) -> float:
        # step-interpolated AP = sum dRecall * precision-at-threshold —
        # sklearn average_precision_score's definition (NOT the trapezoid,
        # which optimistically over-interpolates sawtooth PR curves)
        tp, fp = self._curves()
        recall = tp / tp[-1]
        precision = tp / np.maximum(tp + fp, 1e-300)
        d_recall = np.diff(np.concatenate([[0.0], recall]))
        return float((d_recall * precision).sum())

    def to_row(self, model_index: int) -> dict:
        """JSON-safe partial tagged with its model index; inverse of
        _from_rows (the executor-side evaluate ships partials this way,
        like MulticlassMetrics/RegressionMetrics)."""
        return {
            "model_index": model_index,
            "scores": self.scores.tolist(),
            "pos_w": self.pos_w.tolist(),
            "neg_w": self.neg_w.tolist(),
            "max_bins": self.max_bins,
        }

    @classmethod
    def _from_rows(
        cls, num_models: int, rows: List[dict]
    ) -> List["BinaryClassificationMetrics"]:
        out: List[BinaryClassificationMetrics] = [None] * num_models  # type: ignore[list-item]
        for row in rows:
            metric = cls(
                np.asarray(row["scores"], np.float64),
                np.asarray(row["pos_w"], np.float64),
                np.asarray(row["neg_w"], np.float64),
                row.get("max_bins", DEFAULT_MAX_BINS),
            )
            i = row["model_index"]
            out[i] = metric if out[i] is None else out[i].merge(metric)
        return out

    def evaluate(self, evaluator) -> float:
        name = evaluator.getMetricName()
        if name == "areaUnderROC":
            return self.area_under_roc()
        if name == "areaUnderPR":
            return self.area_under_pr()
        raise ValueError(f"Unsupported metric name, found {name}")
