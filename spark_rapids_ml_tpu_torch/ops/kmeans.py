#
# KMeans solver on one device: Lloyd iterations, random and k-means|| init,
# and the nearest-center assignment behind transform/predict.
#
# Counterpart of spark_rapids_ml_tpu/ops/kmeans.py.  What changes on the way:
#   - lax.while_loop / scan become Python loops over row chunks of
#     max_samples_per_batch; the ragged last chunk is simply shorter, so X is
#     never padded;
#   - shard_map / psum become a loop over the shards of a row-sharded X (a
#     list of per-shard tensors, one tensor being the one-shard case;
#     parallel/mesh.py): each shard's statistics, then one psum_fields
#     (parallel/exchange.py) of sums, counts and inertia per Lloyd
#     iteration, in shard order; the new centers are computed on shard 0's
#     device and replicated to the others;
#   - the assignment keeps the expanded-form torch.matmul, and the per-cluster
#     statistics keep the one-hot product onehot.T @ xb, which is
#     deterministic (index_add_ on CUDA sums with float atomics in an order
#     that changes from run to run);
#   - the inits draw their Gumbel noise from a torch.Generator seeded from
#     `seed`, on the CPU so a seed gives the same draws on every device.  They
#     do not reproduce the JAX package's threefry draws.  A draw indexes the
#     global rows below n_rows (the padding sits past them, mesh.shard_rows),
#     each shard takes its slice, and the Gumbel top-k of the global keys is
#     the top-k of the shards' top-k candidates: one seed gives one init on
#     any shard count.
# transform/predict go through ops/nearest_center.min_dist_argmin, the CUDA
# kernel on the card.  stream_kmeans_chunk_kernel is the streaming engine's
# chunk update (stream/engines.py), in plain torch ops as the JAX package's
# is plain XLA.
# lane_kmeans_predict_kernel is the multiplexed serving kernel
# (serving/multiplex.py).  The JAX kernel gathers centers[lanes] into an
# (N, k, D) tensor (3.07 GB at 256 rows x k 1,000 x D 3,000 float32); here
# the batch's rows are grouped by lane and min_dist_argmin (B1 on the card)
# runs once per distinct lane, that lane's rows against its (k, D) centers,
# the labels scattered back in row order (ops/lanes.by_lane).  No (N, k, D)
# tensor is formed, and a lane's rows go through the dedicated server's own
# kmeans_predict_kernel, so its labels equal the dedicated labels of those
# rows (bit for bit on integer-exact rows, where the JAX lane kernel's equal
# them too).  A batch spanning L lanes costs L launches.
#

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..parallel.exchange import psum_fields, replicate
from ..parallel.mesh import as_shards
from ..utils import chunk_iter
from .lanes import by_lane
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
    X,
    w,
    centers0: torch.Tensor,
    max_iter: int,
    tol: float,
    chunk: int,
) -> Tuple[torch.Tensor, int, float]:
    """Lloyd iterations over the row-sharded (X, w) until the squared center
    shift is <= tol or max_iter iterations ran.  Returns (centers, n_iter,
    inertia), the centers on shard 0's device and the inertia in the exact
    difference form against them."""
    Xs, ws = as_shards(X), as_shards(w)
    devices = [x.device for x in Xs]
    x_norms = [squared_norms(x) for x in Xs]  # hoisted out of the loop
    centers = centers0.to(devices[0])
    n_iter = 0
    shift = torch.tensor(math.inf, dtype=Xs[0].dtype)
    while n_iter < max_iter and bool(shift > tol):
        cs = replicate(centers, devices)
        parts = [_chunked_assign_stats(x, wl, c, chunk, xn)[:2] for x, wl, c, xn in zip(Xs, ws, cs, x_norms)]
        sums, counts = psum_fields(parts, "kmeans.lloyd")
        nonempty = counts > 0
        new_centers = torch.where(
            nonempty[:, None], sums / counts.clamp_min(1.0)[:, None], centers
        )
        shift = ((new_centers - centers) ** 2).sum()
        centers = new_centers
        n_iter += 1
    # one final pass so inertia reflects the returned centers
    cs = replicate(centers, devices)
    parts = [
        _chunked_assign_stats(x, wl, c, chunk, xn, exact_inertia=True)[2:]
        for x, wl, c, xn in zip(Xs, ws, cs, x_norms)
    ]
    (inertia,) = psum_fields(parts, "kmeans.inertia")
    return centers, n_iter, float(inertia)


def _global_gumbel(n_rows: int, generator: torch.Generator, Xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """n_rows Gumbel draws indexing global rows, sliced to the shards (each
    on its shard's device and dtype); a shard's rows past n_rows, the
    padding, get -inf."""
    g = _gumbel(n_rows, generator, torch.empty(0, dtype=Xs[0].dtype))
    if len(Xs) == 1 and int(Xs[0].shape[0]) == n_rows:
        return [g.to(Xs[0].device)]
    out, start = [], 0
    for x in Xs:
        n_loc = int(x.shape[0])
        part = torch.full((n_loc,), -math.inf, dtype=x.dtype)
        take = max(0, min(n_loc, n_rows - start))
        part[:take] = g[start : start + take]
        out.append(part.to(x.device))
        start += n_loc
    return out


def _sharded_topk(keys: List[torch.Tensor], k: int) -> torch.Tensor:
    """Global row indices (k,) of the k largest keys over all shards, in
    descending key order, on shard 0's device: the top-k of each shard's
    top-k, with no host round trip (one shard: its own top-k)."""
    dev = keys[0].device
    vals, idxs, start = [], [], 0
    for kv in keys:
        v, i = torch.topk(kv, min(k, int(kv.shape[0])))
        vals.append(v.to(dev))
        idxs.append(i.to(dev) + start)
        start += int(kv.shape[0])
    if len(keys) == 1:
        return idxs[0]
    return torch.cat(idxs)[torch.topk(torch.cat(vals), k).indices]


def _rows_at(Xs: List[torch.Tensor], rows: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Global rows `rows` of the sharded X (equal shards), in order, on
    `device`: a gather a shard, with no host round trip."""
    if len(Xs) == 1:
        return Xs[0][rows.to(Xs[0].device)].to(device)
    per = int(Xs[0].shape[0])
    owner = (rows // per).to(device)[:, None]
    out = torch.zeros((rows.shape[0], Xs[0].shape[1]), dtype=Xs[0].dtype, device=device)
    for i, x in enumerate(Xs):
        local = (rows - i * per).clamp(0, per - 1).to(x.device)
        out = torch.where(owner == i, x[local].to(device), out)
    return out


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
    X,
    w,
    k: int,
    generator: torch.Generator,
    rounds: int = 4,
    round_size: int = 0,
    chunk: int = 32768,
    n_rows: Optional[int] = None,
) -> torch.Tensor:
    """k-means|| with a fixed candidate pool of 1 + rounds*round_size rows:
    each round draws exactly `round_size` rows without replacement with
    probability proportional to the current cost (Gumbel top-k over the
    global cost vector), then weighted k-means++ reduces the pool to k
    centers on shard 0's device.  The caller sets round_size from the
    oversampling factor.  X and w are row-sharded (module header); the
    draws index the global rows below n_rows (default: all)."""
    Xs, ws = as_shards(X), as_shards(w)
    dev = Xs[0].device
    n = sum(int(x.shape[0]) for x in Xs) if n_rows is None else int(n_rows)
    d = Xs[0].shape[1]
    g0 = _global_gumbel(n, generator, Xs)
    first = _sharded_topk([_log_or_neg_inf(wl, wl > 0) + g for wl, g in zip(ws, g0)], 1)
    m = 1 + rounds * round_size
    pool = torch.zeros((m, d), dtype=Xs[0].dtype, device=dev)
    pool[0] = _rows_at(Xs, first, dev)[0]
    pool_valid = torch.zeros(m, dtype=torch.bool, device=dev)
    pool_valid[0] = True
    for i in range(rounds):
        pools, valids = replicate(pool, [x.device for x in Xs]), replicate(pool_valid, [x.device for x in Xs])
        costs = [_masked_min_dist2(x, wl, p, v, chunk) for x, wl, p, v in zip(Xs, ws, pools, valids)]
        gs = _global_gumbel(n, generator, Xs)
        keys = [_log_or_neg_inf(c, (wl > 0) & (c > 0)) + g for c, wl, g in zip(costs, ws, gs)]
        start = 1 + i * round_size
        pool[start : start + round_size] = _rows_at(Xs, _sharded_topk(keys, round_size), dev)
        pool_valid[start : start + round_size] = True

    # weight candidates by the mass of the points they attract (summed on
    # the host in float64: deterministic, unlike float atomics on the card)
    cand_w = np.zeros(m, dtype=np.float64)
    pools, valids = replicate(pool, [x.device for x in Xs]), replicate(pool_valid, [x.device for x in Xs])
    for x, wl, p, v in zip(Xs, ws, pools, valids):
        _, assign = _nearest_valid(x, p, v, chunk)
        cand_w += np.bincount(assign.cpu().numpy(), weights=wl.double().cpu().numpy(), minlength=m)
    cand_w = torch.as_tensor(cand_w, device=dev).to(Xs[0].dtype) * pool_valid

    # weighted k-means++ on the small candidate pool.  The JAX package
    # recomputes every candidate's distance to all chosen centers each step;
    # keeping the running minimum and folding in only the newest center gives
    # the same minima in O(m*D) per step instead of O(m*k*D).
    pool_norm = (pool * pool).sum(dim=1)
    fallback = torch.where(pool_valid, 0.0, -math.inf).to(pool.dtype)
    centers = torch.zeros((k, d), dtype=pool.dtype, device=dev)
    centers[0] = pool[0]
    min_d2 = pool_norm - 2.0 * (pool @ pool[0]) + pool_norm[0]
    for j in range(1, k):
        cost = min_d2.clamp_min(0.0) * cand_w
        logp = _log_or_neg_inf(cost, cost > 0)
        # degenerate case (fewer distinct candidates than k): any valid one
        logp = torch.where(torch.isfinite(logp).any(), logp, fallback)
        pick = torch.argmax(logp + _gumbel(m, generator, pool))
        centers[j] = pool[pick]
        d2 = pool_norm - 2.0 * (pool @ pool[pick]) + pool_norm[pick]
        min_d2 = torch.minimum(min_d2, d2)
    return centers


def random_init(X, w, k: int, generator: torch.Generator, n_rows: Optional[int] = None) -> torch.Tensor:
    """init="random": k distinct weighted-random data rows of the
    row-sharded X, on shard 0's device; the draws index the global rows
    below n_rows (default: all)."""
    Xs, ws = as_shards(X), as_shards(w)
    n = sum(int(x.shape[0]) for x in Xs) if n_rows is None else int(n_rows)
    keys = [_log_or_neg_inf(wl, wl > 0) + g for wl, g in zip(ws, _global_gumbel(n, generator, Xs))]
    return _rows_at(Xs, _sharded_topk(keys, k), Xs[0].device)


def stream_kmeans_chunk_kernel(
    X: torch.Tensor, w: torch.Tensor, centers: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streamed chunk's mini-batch Lloyd statistics against the running
    centers: (per-center weighted sums (k, D), counts (k,), the chunk's
    cost in the exact difference form).  The JAX package's XLA formula:
    expanded-form distances, first-index argmin, the one-hot product for
    the sums (never index_add_, whose float atomics on the card add in no
    fixed order).  Pad rows carry weight 0."""
    x_norm = (X * X).sum(dim=1)
    c_norm = (centers * centers).sum(dim=1)
    d2 = x_norm[:, None] - 2.0 * (X @ centers.T) + c_norm[None, :]
    assign = torch.argmin(d2, dim=1)
    onehot = torch.zeros_like(d2).scatter_(1, assign[:, None], w[:, None].to(d2.dtype))
    diff = X - centers[assign]
    return onehot.T @ X, onehot.sum(dim=0), ((diff * diff).sum(dim=1) * w).sum()


def kmeans_predict_kernel(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center label (int32) of every row: the CUDA kernel on the
    card, its plain version on the CPU."""
    _, assign = min_dist_argmin(X, centers)
    return assign


def lane_kmeans_predict_kernel(X: torch.Tensor, lanes: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Multiplexed nearest-center label (int32) of every row: row r against
    lane lanes[r] of the lane-stacked (L, k, D) centers, one
    kmeans_predict_kernel call (B1 on the card) per distinct lane (module
    header).  `lanes` may lie on any device; the grouping reads it on the
    host."""
    return by_lane(X, lanes, lambda rows, lane: kmeans_predict_kernel(rows, centers[lane]))
