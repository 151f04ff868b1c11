#
# Clustering metrics: the squared-euclidean silhouette in Spark's mergeable
# two-pass form (pyspark ClusteringEvaluator's default; Spark implements it
# as SquaredEuclideanSilhouette in mllib evaluation — per-cluster
# sufficient statistics first, then a per-point closed form, so the score
# distributes without any pairwise distance matrix).
#
# Pass 1 per cluster k over its points x_j:
#   N_k = count, S_k = sum x_j (vector), Om_k = sum ||x_j||^2
# Pass 2 per point x in cluster c:
#   mean sq dist to cluster k's points:
#     D(x, k) = Om_k/N_k + ||x||^2 - 2 (x . S_k)/N_k
#   a(i) = self-excluded own-cluster mean:
#     (Om_c + N_c ||x||^2 - 2 x . S_c) / (N_c - 1)      (0 if N_c == 1)
#   b(i) = min over k != c of D(x, k)
#   s(i) = (b - a) / max(a, b); silhouette = mean_i s(i)
# Both passes produce mergeable partials (ClusterStats sums; (sum_s, n)),
# so executor-side evaluation ships only O(K x D) stats + two floats per
# partition.  Matches sklearn.metrics.silhouette_score(metric="sqeuclidean").
#
# Counterpart of spark_rapids_ml_tpu/metrics/clustering.py, this package's
# own copy (numpy only).
#

from __future__ import annotations

from typing import Dict, List

import numpy as np


class ClusterStats:
    """Per-cluster sufficient statistics (N, S, Om), mergeable."""

    __slots__ = ("n", "s", "om")

    def __init__(self, n: np.ndarray, s: np.ndarray, om: np.ndarray):
        self.n = n      # (K,) counts
        self.s = s      # (K, D) feature sums
        self.om = om    # (K,) squared-norm sums

    @classmethod
    def from_arrays(
        cls, features: np.ndarray, preds: np.ndarray, n_clusters: int
    ) -> "ClusterStats":
        X = np.asarray(features, np.float64)
        p = np.asarray(preds).astype(np.int64)
        K, D = n_clusters, X.shape[1]
        onehot = p[:, None] == np.arange(K)[None, :]
        n = onehot.sum(axis=0).astype(np.float64)
        s = onehot.T.astype(np.float64) @ X
        om = onehot.T.astype(np.float64) @ (X * X).sum(axis=1)
        return cls(n, s, om)

    def _pad(self, k: int) -> "ClusterStats":
        cur = len(self.n)
        if cur >= k:
            return self
        return ClusterStats(
            np.pad(self.n, (0, k - cur)),
            np.pad(self.s, ((0, k - cur), (0, 0))),
            np.pad(self.om, (0, k - cur)),
        )

    def merge(self, other: "ClusterStats") -> "ClusterStats":
        # partials may have been built with LOCAL cluster counts (a
        # partition only knows the ids it saw); pad to the wider one
        k = max(len(self.n), len(other.n))
        a, b = self._pad(k), other._pad(k)
        return ClusterStats(a.n + b.n, a.s + b.s, a.om + b.om)

    def to_row(self) -> Dict:
        return {"n": self.n.tolist(), "s": self.s.tolist(), "om": self.om.tolist()}

    @classmethod
    def from_row(cls, row: Dict) -> "ClusterStats":
        return cls(
            np.asarray(row["n"], np.float64),
            np.asarray(row["s"], np.float64),
            np.asarray(row["om"], np.float64),
        )

    @classmethod
    def merge_rows(cls, rows: List[Dict]) -> "ClusterStats":
        out = None
        for r in rows:
            st = cls.from_row(r)
            out = st if out is None else out.merge(st)
        assert out is not None, "empty dataset"
        return out


def silhouette_partial(
    features: np.ndarray, preds: np.ndarray, stats: ClusterStats
):
    """One partition's (sum of s(i), count) given the GLOBAL cluster stats
    (pass 2 of the Spark formulation above)."""
    X = np.asarray(features, np.float64)
    p = np.asarray(preds).astype(np.int64)
    live = stats.n > 0
    n = np.where(live, stats.n, 1.0)
    xs = X @ stats.s.T                                # (n, K)
    x2 = (X * X).sum(axis=1)                          # (n,)
    D = stats.om[None, :] / n[None, :] + x2[:, None] - 2.0 * xs / n[None, :]
    # the closed form cancels catastrophically on (near-)duplicate points
    # at large coordinate scale and can come out tiny-NEGATIVE; mean
    # squared distances are nonnegative by definition, and an unclamped
    # -2e-16 against the 1e-300 denominator floor below would explode
    # s(i) instead of keeping it in [-1, 1]
    D = np.maximum(D, 0.0)
    D = np.where(live[None, :], D, np.inf)
    rows = np.arange(len(X))
    own_n = stats.n[p]
    a = (stats.om[p] + own_n * x2 - 2.0 * xs[rows, p]) / np.maximum(
        own_n - 1.0, 1.0
    )
    a = np.maximum(a, 0.0)
    Db = D.copy()
    Db[rows, p] = np.inf
    b = Db.min(axis=1)
    denom = np.maximum(np.maximum(a, b), 1e-300)
    s = np.where(own_n <= 1.0, 0.0, (b - a) / denom)
    return float(s.sum()), int(len(X))


def silhouette_score(
    parts_features: List[np.ndarray],
    parts_preds: List[np.ndarray],
    n_clusters: int,
) -> float:
    """Two-pass silhouette over partition arrays (the facade's evaluate
    path)."""
    stats = None
    for X, p in zip(parts_features, parts_preds):
        if len(X) == 0:
            continue
        st = ClusterStats.from_arrays(X, p, n_clusters)
        stats = st if stats is None else stats.merge(st)
    assert stats is not None, "empty dataset"
    if int((stats.n > 0).sum()) < 2:
        # same contract as pyspark ClusteringEvaluator
        raise AssertionError("Number of clusters must be greater than one.")
    tot, cnt = 0.0, 0
    for X, p in zip(parts_features, parts_preds):
        if len(X) == 0:
            continue
        t, c = silhouette_partial(X, p, stats)
        tot += t
        cnt += c
    return tot / max(cnt, 1)
