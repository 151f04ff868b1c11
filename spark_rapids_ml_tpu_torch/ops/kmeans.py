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
#   - the inits draw their Gumbel noise as the JAX package does, bit for bit
#     (ops/prng.gumbel_at: threefry on PRNGKey(seed), XLA's float32 log): the
#     same key chain (`key, k0 = split(key)` for the first center, one split
#     a k-means|| round, one a k-means++ pick), hashed once on the host, each
#     draw made on the rows' device.  A draw's counter is the global valid
#     row's index, as in the JAX package, whose ingest pads at the global
#     end (mesh.shard_rows), so each shard draws its own valid rows; the
#     Gumbel top-k of the global keys is the top-k of the shards' top-k
#     candidates: one seed gives one init on any shard count, the JAX
#     package's.  The first center's and the rounds' draws are made in one
#     call where they hold at most _GUMBEL_ROWS elements, else one a round
#     in chunks of that many rows, the k-means++ picks' Gumbel rows in
#     batches of picks and only at the pool positions that can win a pick
#     (positive candidate weight; the whole pool again if a pick falls
#     back to the degenerate rule); on the card a loop of 64 or more
#     picks replays one CUDA graph a pick, and an eager pick scores with
#     torch's log and takes XLA's only within a margin of the best (the
#     same pick from a few ops).  On a
#     mesh of more than one shard the shards' top-k candidates, the
#     candidate rows and the k-means|| candidate weights meet
#     in device_collective sections (kmeans.topk, kmeans.rows,
#     kmeans.cand_weights) in global shard order; across processes (a mesh
#     over ranks, parallel/mesh.py) each rank takes its local shards' slices
#     of the same draws (mesh.valid_spans), so the init is the one-process
#     mesh's of the same global shard count.
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
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import profiling
from ..parallel.exchange import device_collective, psum_fields, replicate
from ..parallel.mesh import as_shards, global_row_base, process_mesh, valid_spans
from ..utils import chunk_iter
from . import prng
from .lanes import by_lane
from .nearest_center import min_dist_argmin, squared_norms
from .xla_math import log_f32

# k-means++ picks whose Gumbel rows one batched draw makes: a batch's draw
# holds at most this many elements
_PICK_DRAW_ELEMS = 1 << 22
# elements of one Gumbel draw (or rows of one step of the keys) of the
# inits: the hash's int64 words and the logs' float64 temporaries take
# ~100 bytes an element
_GUMBEL_ROWS = 1 << 22
# the fewest picks the card runs as a CUDA graph: a capture costs ~17 ms of
# its memory pool's cudaMalloc / cudaFree and the instantiation, an eager
# pick ~50 launches (~0.4 ms) (an H100 trace of the 4-bit OPQ build: 161
# captures of 15-pick loops, 2.8 s)
_PICK_GRAPH_MIN = 64
# torch's float32 log and XLA's are each within an ulp of the true log (an
# ulp is under 8e-6 below 128, and a pick's scores lie within +-110), so an
# eager pick takes XLA's log only at the positions whose torch-log score is
# within twice this of the best one: the first exact best is among them
_PICK_MARGIN = 1e-3


def _draw_dtype(dtype: torch.dtype) -> torch.dtype:
    """The Gumbel draws' dtype: the JAX package's default float, float64
    in its x64 (float64) fits, float32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _log(values: torch.Tensor) -> torch.Tensor:
    """XLA's log: its float32 polynomial for float32, torch's log else."""
    return log_f32(values) if values.dtype == torch.float32 else torch.log(values)


def _log_or_neg_inf(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, _log(values.clamp_min(1e-30)), -math.inf)


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


def _gumbel_noise(keys: torch.Tensor, n_rows: int, Xs: List[torch.Tensor], draw: torch.dtype) -> List[torch.Tensor]:
    """gumbel(key, (n_pad,), draw) for each key of `keys` (r, 2) at the
    global valid rows below n_rows (counter = global valid row), sliced to
    the shards and drawn on each shard's device, _GUMBEL_ROWS elements at a
    time: (r, n_loc) a shard, its padding rows -inf.  Across processes each
    rank draws its local shards' rows (mesh.valid_spans)."""
    step = max(1, _GUMBEL_ROWS // int(keys.shape[0]))
    out = []
    for x, (start, take) in zip(Xs, valid_spans([int(x.shape[0]) for x in Xs], n_rows)):
        part = torch.full((int(keys.shape[0]), int(x.shape[0])), -math.inf, dtype=draw, device=x.device)
        k = keys.to(x.device)
        for sl in chunk_iter(take, step):
            rows = torch.arange(start + sl.start, start + sl.stop, dtype=torch.int64, device=x.device)
            part[:, sl] = prng.gumbel_at(k, rows, draw)
        out.append(part)
    return out


def _gumbel_keys(values: List[torch.Tensor], keeps: List[torch.Tensor], noise: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per shard, the Gumbel-max keys log(max(v, 1e-30)) (-inf where not
    `keep`) plus the shard's noise (-inf on its padding rows), made
    _GUMBEL_ROWS rows at a time (the log's float64 temporaries)."""
    out = []
    for v, keep, g in zip(values, keeps, noise):
        part = torch.empty(int(v.shape[0]), dtype=torch.promote_types(v.dtype, g.dtype), device=v.device)
        for sl in chunk_iter(int(v.shape[0]), _GUMBEL_ROWS):
            part[sl] = _log_or_neg_inf(v[sl], keep[sl]) + g[sl]
        out.append(part)
    return out


def _one_shard(Xs: List[torch.Tensor]) -> bool:
    """True when the mesh has one shard in all: no collective runs."""
    return len(Xs) == 1 and process_mesh() is None


def _topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values and their indices, equal values in index order
    as XLA's TopK gives them (torch.topk leaves ties in no fixed order, and
    a round of fewer finite keys than its size takes -inf ones)."""
    v, i = torch.sort(values, descending=True, stable=True)
    return v[:k], i[:k]


def _sharded_topk(keys: List[torch.Tensor], k: int) -> torch.Tensor:
    """Global row indices (k,) of the k largest keys over all shards, in
    descending key order (ties: the lower global row first), on shard 0's
    device: the top-k of each shard's top-k, gathered in global shard order
    with no host round trip (one shard: its own top-k)."""
    vals, idxs = [], []
    for kv, base in zip(keys, global_row_base([int(kv.shape[0]) for kv in keys])):
        v, i = _topk(kv, k)
        vals.append(v)
        idxs.append(i + base)
    if _one_shard(keys):
        return idxs[0]
    vals = device_collective("kmeans.topk").gather_to_first(vals).reshape(-1)
    idxs = device_collective("kmeans.topk").gather_to_first(idxs).reshape(-1)
    return idxs[_topk(vals, k)[1]]


def _rows_at(Xs: List[torch.Tensor], rows: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Global rows `rows` of the sharded X (equal shards), in order, on
    `device`, with no host round trip: each shard gives its (clamped) rows,
    one kmeans.rows gather stacks them and each row is picked from its
    owning shard."""
    if _one_shard(Xs):
        return Xs[0][rows.to(Xs[0].device)].to(device)
    per = int(Xs[0].shape[0])
    picked = [x[(rows - base).clamp(0, per - 1).to(x.device)]
              for x, base in zip(Xs, global_row_base([per] * len(Xs)))]
    slab = device_collective("kmeans.rows").gather_to_first(picked).to(device)
    return slab[(rows // per).to(device), torch.arange(rows.shape[0], device=device)]


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
    seed: int,
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
    draws index the global rows below n_rows (default: all), on the JAX
    package's key chain from PRNGKey(seed)."""
    Xs, ws = as_shards(X), as_shards(w)
    dev = Xs[0].device
    n = sum(int(x.shape[0]) for x in Xs) if n_rows is None else int(n_rows)
    d = Xs[0].shape[1]
    (k0,), key = prng.split_chain(prng.prng_key(seed), 1)
    round_keys, key = prng.split_chain(key, rounds)
    pick_keys, _ = prng.split_chain(key, k - 1)
    draw = _draw_dtype(Xs[0].dtype)
    # every draw at once where it is small (a draw is ~250 launches), else
    # one a round
    upfront = (1 + rounds) * n <= _GUMBEL_ROWS
    noise = _gumbel_noise(torch.cat([k0[None], round_keys]) if upfront else k0[None], n, Xs, draw)
    first = _sharded_topk(_gumbel_keys(ws, [wl > 0 for wl in ws], [z[0] for z in noise]), 1)
    m = 1 + rounds * round_size
    pool = torch.zeros((m, d), dtype=Xs[0].dtype, device=dev)
    pool[0] = _rows_at(Xs, first, dev)[0]
    pool_valid = torch.zeros(m, dtype=torch.bool, device=dev)
    pool_valid[0] = True
    for i in range(rounds):
        pools, valids = replicate(pool, [x.device for x in Xs]), replicate(pool_valid, [x.device for x in Xs])
        costs = [_masked_min_dist2(x, wl, p, v, chunk) for x, wl, p, v in zip(Xs, ws, pools, valids)]
        gs = ([z[1 + i] for z in noise] if upfront
              else [z[0] for z in _gumbel_noise(round_keys[i : i + 1], n, Xs, draw)])
        keys = _gumbel_keys(costs, [(wl > 0) & (c > 0) for c, wl in zip(costs, ws)], gs)
        start = 1 + i * round_size
        pool[start : start + round_size] = _rows_at(Xs, _sharded_topk(keys, round_size), dev)
        pool_valid[start : start + round_size] = True

    # weight candidates by the mass of the points they attract (summed on
    # the host in float64: deterministic, unlike float atomics on the card)
    cand_w = np.zeros(m, dtype=np.float64)
    pools, valids = replicate(pool, [x.device for x in Xs]), replicate(pool_valid, [x.device for x in Xs])
    parts = []
    for x, wl, p, v in zip(Xs, ws, pools, valids):
        _, assign = _nearest_valid(x, p, v, chunk)
        parts.append(np.bincount(assign.cpu().numpy(), weights=wl.double().cpu().numpy(), minlength=m))
    if not _one_shard(Xs):
        # every global shard's counts, in global shard order
        parts = device_collective("kmeans.cand_weights").gather_to_first(
            [torch.from_numpy(c) for c in parts]).numpy()
    for c in parts:
        cand_w += c
    cand_w = torch.as_tensor(cand_w, device=dev).to(Xs[0].dtype) * pool_valid

    # weighted k-means++ on the small candidate pool.  A position of no
    # weight never wins a pick unless every cost is 0, so the picks run
    # over the positions of positive weight, and over the whole pool again
    # only if one of them fell back (fewer distinct candidates than k)
    pool_norm = (pool * pool).sum(dim=1)
    pick_keys = pick_keys.to(dev)
    live = torch.nonzero(cand_w > 0).squeeze(1)
    if live.numel():
        centers, fell_back = _pp_picks(pool, pool_norm, pool_valid, cand_w, pick_keys, k, live)
        if not fell_back:
            return centers
    return _pp_picks(pool, pool_norm, pool_valid, cand_w, pick_keys, k, torch.arange(m, device=dev))[0]


def _pp_picks(
    pool: torch.Tensor,
    pool_norm: torch.Tensor,
    pool_valid: torch.Tensor,
    cand_w: torch.Tensor,
    pick_keys: torch.Tensor,
    k: int,
    at: torch.Tensor,
) -> Tuple[torch.Tensor, bool]:
    """The k centers of weighted k-means++ over the pool positions `at`
    (ascending), the first being pool row 0, and whether a pick fell back
    to the degenerate rule (no cost left above 0: any valid position).
    Pick j's noise is gumbel(pick_keys[j - 1], (m,)) at `at`: the JAX
    package's picks whenever `at` holds every position that can win.  The
    JAX package recomputes every candidate's distance to all chosen
    centers each step; keeping the running minimum and folding in only the
    newest center gives the same minima in O(m*D) per step instead of
    O(m*k*D)."""
    dev = pool.device
    sub = pool.index_select(0, at)
    sub_norm = pool_norm.index_select(0, at)
    sub_w = cand_w.index_select(0, at)
    fallback = torch.where(pool_valid.index_select(0, at), 0.0, -math.inf).to(pool.dtype)
    centers = torch.zeros((k, pool.shape[1]), dtype=pool.dtype, device=dev)
    centers[0] = pool[0]
    min_d2 = sub_norm - 2.0 * (sub @ pool[0]) + pool_norm[0]
    batch = max(1, _PICK_DRAW_ELEMS // int(at.numel()))
    # one pick's inputs, read in place by the step
    noise_row = torch.empty(int(at.numel()), dtype=_draw_dtype(pool.dtype), device=dev)
    j_idx = torch.zeros(1, dtype=torch.int64, device=dev)
    fell_back = torch.zeros((), dtype=torch.bool, device=dev)

    def fold(pick: torch.Tensor) -> None:
        row = sub.index_select(0, pick)
        centers.index_copy_(0, j_idx, row)
        d2 = sub_norm - 2.0 * (sub @ row[0]) + sub_norm.index_select(0, pick)
        torch.minimum(min_d2, d2, out=min_d2)

    def step() -> None:
        """One pick with no host read (a CUDA graph replays it): XLA's log
        of every cost."""
        cost = min_d2.clamp_min(0.0) * sub_w
        logp = _log_or_neg_inf(cost, cost > 0)
        any_cost = torch.isfinite(logp).any()
        fell_back.logical_or_(~any_cost)
        logp = torch.where(any_cost, logp, fallback)
        fold(torch.argmax(logp + noise_row).view(1))

    def eager_step() -> None:
        """step's pick from a few small ops: torch's log scores every
        position, XLA's log rescores those within 2 * _PICK_MARGIN of the
        best."""
        cost = min_d2.clamp_min(0.0) * sub_w
        approx = torch.where(cost > 0, torch.log(cost.clamp_min(1e-30)), -math.inf) + noise_row
        best = float(approx.max())
        if best == -math.inf:
            fell_back.fill_(True)
            fold(torch.argmax(fallback + noise_row).view(1))
            return
        near = (approx >= best - 2 * _PICK_MARGIN).nonzero().squeeze(1)
        if near.numel() > 1:
            exact = _log(cost.index_select(0, near).clamp_min(1e-30)) + noise_row.index_select(0, near)
            near = near[torch.argmax(exact)]
        fold(near.view(1))

    capture = dev.type == "cuda" and k - 1 >= _PICK_GRAPH_MIN
    run = None
    for j in range(1, k):
        if (j - 1) % batch == 0:
            noise = prng.gumbel_at(pick_keys[j - 1 : j - 1 + batch], at, noise_row.dtype)
        noise_row.copy_(noise[(j - 1) % batch])
        j_idx.fill_(j)
        if run is None:
            run = _pick_runner(step if capture else eager_step, dev, capture)
        else:
            run()
    return centers, bool(fell_back)


def _pick_runner(step: Callable[[], None], device: torch.device, capture: bool) -> Callable[[], None]:
    """Run the first k-means++ pick and return what runs the next ones:
    `step` itself, or with `capture` (on the card) a CUDA graph of one pick,
    captured after the first pick ran eagerly on a side stream as graph
    capture asks (counted in kmeans.pick_graph_captures).  A captured pick
    is ~50 small launches, most of them XLA's log, and a PQ build makes
    thousands of picks: a replay is one launch."""
    if not capture:
        step()
        return step
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        step()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    profiling.incr_counter("kmeans.pick_graph_captures")
    return graph.replay


def random_init(X, w, k: int, seed: int, n_rows: Optional[int] = None) -> torch.Tensor:
    """init="random": k distinct weighted-random data rows of the
    row-sharded X, on shard 0's device: the top k of log w plus one Gumbel
    draw from PRNGKey(seed) at the global rows below n_rows (default: all)."""
    Xs, ws = as_shards(X), as_shards(w)
    n = sum(int(x.shape[0]) for x in Xs) if n_rows is None else int(n_rows)
    noise = _gumbel_noise(prng.prng_key(seed)[None], n, Xs, _draw_dtype(Xs[0].dtype))
    keys = _gumbel_keys(ws, [wl > 0 for wl in ws], [z[0] for z in noise])
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
