#
# Random-forest binning and prediction.
#
# Counterpart of the single-device subset of spark_rapids_ml_tpu/ops/forest.py:
#   - compute_bin_edges: per-feature quantile edges on the host, the same
#     float64 sort + linear-interpolation formula;
#   - bin_features_feature_major: (N, D) -> (D, n_pad) int8 bins, through the
#     hand-written binning kernel (ops/binning.py) on the card;
#   - forest_predict: the mean of the trees' leaf values, a batched gather
#     traversal of the dense tree arrays (max_depth gather/compare steps).
# The dense layout: node i has children 2i+1 (x <= threshold) and 2i+2;
# feature -1 marks a leaf.
#
# Not carried over: compute_bin_edges_device and the AOT-cached
# forest_predict_cached (TPU host-link and compile workarounds), and the
# mesh-parallel scatter engine grow_forest (multi-device meshes; ROADMAP A14).
#

from __future__ import annotations

import numpy as np
import torch

from .binning import bin_features_fm


def compute_bin_edges(X: np.ndarray, n_bins: int, max_sample: int = 100_000, seed: int = 0) -> np.ndarray:
    """Per-feature quantile bin edges, (D, n_bins-1) float32, from a row
    subsample of at most max_sample rows, on the host."""
    n = X.shape[0]
    if n > max_sample:
        idx = np.random.default_rng(seed).choice(n, max_sample, replace=False)
        sample = X[idx]
    else:
        sample = X
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    s = np.sort(np.asarray(sample, dtype=np.float64), axis=0)
    pos = qs * (s.shape[0] - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    frac = (pos - lo)[:, None]
    return np.ascontiguousarray((s[lo] * (1.0 - frac) + s[hi] * frac).T, dtype=np.float32)


def bin_features_feature_major(X: torch.Tensor, edges: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(N, D) float32 -> (D, n_pad) int8 bins (bin = the number of edges
    strictly below x); columns N..n_pad-1 are zero bins (callers mask padded
    rows through weights).  At most 127 edges."""
    return bin_features_fm(X, edges.to(X.device, torch.float32).contiguous(), n_pad)


def forest_predict(
    X: torch.Tensor,          # (N, D)
    feature: torch.Tensor,    # (T, M) int32
    threshold: torch.Tensor,  # (T, M) in X's dtype
    leaf_value: torch.Tensor, # (T, M, V) float32
    max_depth: int,
) -> torch.Tensor:
    """Mean of the per-tree leaf values, (N, V) float32.  The trees are
    summed one after the other, in tree order."""
    T = feature.shape[0]
    n = X.shape[0]
    feature = feature.long()
    node = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        f = feature.gather(1, node)
        x = X.gather(1, f.clamp(min=0).T).T  # (T, N): x[t, r] = X[r, f[t, r]]
        child = 2 * node + 1 + (x > threshold.gather(1, node)).long()
        node = torch.where(f < 0, node, child)
    acc = leaf_value[0][node[0]]
    for t in range(1, T):
        acc = acc + leaf_value[t][node[t]]
    return acc / T
