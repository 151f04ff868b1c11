#
# KMeans solver on one device: Lloyd iterations, random and k-means|| init,
# and the nearest-center assignment behind transform/predict.
#
# Counterpart of spark_rapids_ml_tpu/ops/kmeans.py.  What changes on the way:
#   - lax.while_loop / scan become Python loops over row chunks of
#     max_samples_per_batch; the ragged last chunk is simply shorter, so X is
#     never padded;
#   - shard_map / psum disappear: the port fits on one device;
#   - the assignment keeps the expanded-form torch.matmul, and the per-cluster
#     statistics keep the one-hot product onehot.T @ xb, which is
#     deterministic (index_add_ on CUDA sums with float atomics in an order
#     that changes from run to run);
#   - the inits draw their Gumbel noise from a torch.Generator seeded from
#     `seed`, on the CPU so a seed gives the same draws on every device.  They
#     do not reproduce the JAX package's threefry draws.
# transform/predict go through ops/nearest_center.min_dist_argmin, the CUDA
# kernel on the card.
#

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..utils import chunk_iter
from .nearest_center import min_dist_argmin, squared_norms


def _gumbel(m: int, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """m standard Gumbel draws (-log of Exp(1) draws), made on the CPU from
    `generator` and moved to `like`'s device and dtype."""
    e = torch.empty(m, dtype=torch.float64).exponential_(generator=generator)
    return (-torch.log(e)).to(device=like.device, dtype=like.dtype)


def _log_or_neg_inf(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, torch.log(values.clamp_min(1e-30)), -math.inf)


def _chunked_assign_stats(
    X: torch.Tensor,
    w: torch.Tensor,
    centers: torch.Tensor,
    chunk: int,
    x_norm: torch.Tensor,
    exact_inertia: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cluster weighted sums (k, D), counts (k,) and inertia over X in
    `chunk`-row blocks.  Distances use the expanded form
    ||x||^2 - 2 x.c + ||c||^2 so the hot op is a (chunk, D) @ (D, k) matmul;
    ||x||^2 is invariant across iterations and passed in.

    exact_inertia=True recomputes each row's cost as ||x - c_assign||^2: the
    expanded form cancels when distances are small next to the norms."""
    k, d = centers.shape
    c_norm = (centers * centers).sum(dim=1)
    sums = torch.zeros((k, d), dtype=X.dtype, device=X.device)
    counts = torch.zeros(k, dtype=X.dtype, device=X.device)
    inertia = torch.zeros((), dtype=X.dtype, device=X.device)
    ct = centers.T
    for sl in chunk_iter(X.shape[0], chunk):
        xb, wb = X[sl], w[sl]
        d2 = x_norm[sl, None] - 2.0 * (xb @ ct) + c_norm[None, :]
        assign = torch.argmin(d2, dim=1)
        # one_hot(assign) * w, built in place of the (chunk, k) int64 one_hot
        onehot = torch.zeros_like(d2).scatter_(1, assign[:, None], wb[:, None])
        sums += onehot.T @ xb
        counts += onehot.sum(dim=0)
        if exact_inertia:
            diff = xb - centers[assign]
            inertia += ((diff * diff).sum(dim=1) * wb).sum()
    return sums, counts, inertia


def lloyd_iterations(
    X: torch.Tensor,
    w: torch.Tensor,
    centers0: torch.Tensor,
    max_iter: int,
    tol: float,
    chunk: int,
) -> Tuple[torch.Tensor, int, float]:
    """Lloyd iterations until the squared center shift is <= tol or max_iter
    iterations ran.  Returns (centers, n_iter, inertia), the inertia in the
    exact difference form against the returned centers."""
    x_norm = squared_norms(X)  # hoisted out of the loop
    centers = centers0
    n_iter = 0
    shift = torch.tensor(math.inf, dtype=X.dtype)
    while n_iter < max_iter and bool(shift > tol):
        sums, counts, _ = _chunked_assign_stats(X, w, centers, chunk, x_norm)
        nonempty = counts > 0
        new_centers = torch.where(
            nonempty[:, None], sums / counts.clamp_min(1.0)[:, None], centers
        )
        shift = ((new_centers - centers) ** 2).sum()
        centers = new_centers
        n_iter += 1
    # one final pass so inertia reflects the returned centers
    _, _, inertia = _chunked_assign_stats(
        X, w, centers, chunk, x_norm, exact_inertia=True
    )
    return centers, n_iter, float(inertia)


def _nearest_valid(
    X: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor, chunk: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min d2, argmin) of every row of X over the *valid* centers.  Invalid
    slots are zeroed before the matmul (an inf would turn into nan there)
    and masked to +inf after it."""
    c = torch.where(valid[:, None], centers, 0.0)
    c_norm = (c * c).sum(dim=1)
    ct = c.T
    min_d2 = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    assign = torch.empty(X.shape[0], dtype=torch.int64, device=X.device)
    for sl in chunk_iter(X.shape[0], chunk):
        xb = X[sl]
        d2 = (xb * xb).sum(dim=1)[:, None] - 2.0 * (xb @ ct) + c_norm[None, :]
        d2 = torch.where(valid[None, :], d2, math.inf)
        min_d2[sl], assign[sl] = torch.min(d2, dim=1)
    return min_d2, assign


def _masked_min_dist2(
    X: torch.Tensor, w: torch.Tensor, centers: torch.Tensor, valid: torch.Tensor, chunk: int
) -> torch.Tensor:
    """Weighted squared distance of every row to its nearest *valid* center."""
    min_d2, _ = _nearest_valid(X, centers, valid, chunk)
    return min_d2.clamp_min(0.0) * w


def scalable_kmeans_pp_init(
    X: torch.Tensor,
    w: torch.Tensor,
    k: int,
    generator: torch.Generator,
    rounds: int = 4,
    round_size: int = 0,
    chunk: int = 32768,
) -> torch.Tensor:
    """k-means|| with a fixed candidate pool of 1 + rounds*round_size rows:
    each round draws exactly `round_size` rows without replacement with
    probability proportional to the current cost (Gumbel top-k), then
    weighted k-means++ reduces the pool to k centers.  The caller sets
    round_size from the oversampling factor."""
    n, d = X.shape
    first = torch.argmax(_log_or_neg_inf(w, w > 0) + _gumbel(n, generator, X))
    m = 1 + rounds * round_size
    pool = torch.zeros((m, d), dtype=X.dtype, device=X.device)
    pool[0] = X[first]
    pool_valid = torch.zeros(m, dtype=torch.bool, device=X.device)
    pool_valid[0] = True
    for i in range(rounds):
        cost = _masked_min_dist2(X, w, pool, pool_valid, chunk)
        logp = _log_or_neg_inf(cost, (w > 0) & (cost > 0))
        idx = torch.topk(logp + _gumbel(n, generator, X), round_size).indices
        start = 1 + i * round_size
        pool[start : start + round_size] = X[idx]
        pool_valid[start : start + round_size] = True

    # weight candidates by the mass of the points they attract (summed on
    # the host in float64: deterministic, unlike float atomics on the card)
    _, assign = _nearest_valid(X, pool, pool_valid, chunk)
    cand_w = np.bincount(
        assign.cpu().numpy(), weights=w.double().cpu().numpy(), minlength=m
    )
    cand_w = torch.as_tensor(cand_w, device=X.device).to(X.dtype) * pool_valid

    # weighted k-means++ on the small candidate pool.  The JAX package
    # recomputes every candidate's distance to all chosen centers each step;
    # keeping the running minimum and folding in only the newest center gives
    # the same minima in O(m*D) per step instead of O(m*k*D).
    pool_norm = (pool * pool).sum(dim=1)
    fallback = torch.where(pool_valid, 0.0, -math.inf).to(X.dtype)
    centers = torch.zeros((k, d), dtype=X.dtype, device=X.device)
    centers[0] = pool[0]
    min_d2 = pool_norm - 2.0 * (pool @ pool[0]) + pool_norm[0]
    for j in range(1, k):
        cost = min_d2.clamp_min(0.0) * cand_w
        logp = _log_or_neg_inf(cost, cost > 0)
        # degenerate case (fewer distinct candidates than k): any valid one
        logp = torch.where(torch.isfinite(logp).any(), logp, fallback)
        pick = torch.argmax(logp + _gumbel(m, generator, X))
        centers[j] = pool[pick]
        d2 = pool_norm - 2.0 * (pool @ pool[pick]) + pool_norm[pick]
        min_d2 = torch.minimum(min_d2, d2)
    return centers


def random_init(
    X: torch.Tensor, w: torch.Tensor, k: int, generator: torch.Generator
) -> torch.Tensor:
    """init="random": k distinct weighted-random data rows."""
    keys = _log_or_neg_inf(w, w > 0) + _gumbel(X.shape[0], generator, X)
    return X[torch.topk(keys, k).indices]


def kmeans_predict_kernel(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center label (int32) of every row: the CUDA kernel on the
    card, its plain version on the CPU."""
    _, assign = min_dist_argmin(X, centers)
    return assign
