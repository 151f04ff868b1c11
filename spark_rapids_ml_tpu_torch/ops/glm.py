#
# Linear-model solvers: OLS / ridge in closed form, elastic net by
# covariance-update coordinate descent, on sufficient statistics.
#
# Counterpart of spark_rapids_ml_tpu/ops/glm.py.  One pass over the rows
# forms (X'WX, X'Wy, the means) in row chunks (ops/linalg._local_moments),
# on each shard of a row-sharded X (a list of per-shard tensors; one tensor
# is the one-shard case), the shards' sums combined by one psum_fields
# (parallel/exchange.py) on shard 0's device, and every solve runs on the
# small (D, D) system there: on the card the solve, the CD sweeps and the
# intercept's inputs never leave it.
#
# Spark numerics kept:
#   - ridge: Spark normalises the sample term by n, so alpha is scaled by the
#     total weight: (Xc'WXc + alpha * wsum * I) b = Xc'Wy;
#   - elastic net: obj = (1/2n)||y - Xb||^2 + alpha (l1r |b|_1 + (1 - l1r)/2
#     |b|_2^2), alpha as it is;
#   - standardization scales the features inside the solver and unscales
#     the coefficients.
# Coordinate descent keeps the JAX package's coordinate order and update
# formula.  On the card one sweep (D coordinates, ~12 small launches each) is
# captured once as a CUDA graph and replayed, with max_delta read once a
# sweep (at D = 3000 on an NVIDIA H100 80GB HBM3 at 700 W a replay took
# 59-74 ms against 587-589 ms for the eager sweep, chip_smoke.py
# path_linreg); on the CPU the same sweep runs eagerly.  The graph reads
# its system (G, c, the diagonal, the denominators, the weight sum and the
# L1 threshold) from static buffers, one set per (D, dtype, device), into
# which each solve copies its own system before its replays: one capture
# serves every fit, fold and candidate lane of that shape (counter
# glm.cd_graph_captures), and a lane's alpha and l1 ratio are data, not
# values baked into the graph.
#
# The batched sweep (CrossValidator over one staged dataset, the JAX
# package's sweep_* functions): sweep_linreg_fold_stats forms every fold's
# TRAIN statistics in one pass over X, folds as weight masks; then
# sweep_solve_linear and sweep_solve_elasticnet_cd run the sequential fit's
# own solve for each (fold, lane), in order, with no batched factorisation
# (a batched LU's low bits drift from the single solve's).  On
# integer-valued data every sum is exact, so a lane's coefficients equal
# the sequential fit's on its fold bit for bit.
# stream_linreg_chunk_kernel is one streamed chunk's unreduced statistics
# (stream/engines.py folds them in float64 and solves them here at
# finalize).  multi_linear_predict_kernel predicts for M combined models in
# one product; lane_linear_predict_kernel is the multiplexed predict of
# serving/multiplex.py (ops/linalg's header states its contract).
#

from __future__ import annotations

import threading
from functools import partial
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling
from ..parallel.exchange import psum_fields
from ..parallel.mesh import as_shards
from ..utils import chunk_iter
from .lanes import by_lane
from .linalg import MOMENT_CHUNK, _local_moments, _sharded_moments, exact_matmul


class LinregStats(NamedTuple):
    wsum: torch.Tensor    # scalar: total weight (the row count without weightCol)
    x_mean: torch.Tensor  # (D,)
    y_mean: torch.Tensor  # scalar
    G: torch.Tensor       # (D, D) = X'WX (uncentred)
    c: torch.Tensor       # (D,)   = X'Wy (uncentred)
    y2: torch.Tensor      # scalar = sum w y^2


def linreg_sufficient_stats(X, y, w, chunk: int = MOMENT_CHUNK) -> LinregStats:
    """One pass over the row-sharded (X, y, w) in `chunk`-row blocks, the
    shards' sums combined by one psum."""
    wsum, xwsum, G, ywsum, c, y2 = _sharded_moments(X, w, chunk, y=y, section="glm.stats")
    return LinregStats(wsum, xwsum / wsum, ywsum / wsum, G, c, y2)


def stream_linreg_chunk_kernel(
    X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, chunk: int = MOMENT_CHUNK
) -> Tuple[torch.Tensor, ...]:
    """One streamed chunk's unreduced sufficient statistics (wsum, xwsum,
    X'Wx, sum w y, X'Wy, sum w y^2): raw sums, not means, so chunk partials
    fold by addition and the means are derived once at finalize.  Pad rows
    carry weight 0."""
    return _local_moments(X, w, chunk, y=y)


def _centered_system(stats: LinregStats, fit_intercept: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """G and c centred around the weighted means when fitting an intercept."""
    if fit_intercept:
        Gc = stats.G - stats.wsum * torch.outer(stats.x_mean, stats.x_mean)
        cc = stats.c - stats.wsum * stats.x_mean * stats.y_mean
        return Gc, cc
    return stats.G, stats.c


def _feature_scales(Gc: torch.Tensor, wsum: torch.Tensor, normalize: bool) -> torch.Tensor:
    if not normalize:
        return torch.ones(Gc.shape[0], dtype=Gc.dtype, device=Gc.device)
    var = torch.clamp(torch.diagonal(Gc) / wsum, min=0.0)
    return torch.where(var > 0, torch.sqrt(var), torch.ones_like(var))


def _intercept(stats: LinregStats, b: torch.Tensor, fit_intercept: bool) -> torch.Tensor:
    if fit_intercept:
        return stats.y_mean - stats.x_mean @ b
    return torch.zeros((), dtype=b.dtype, device=b.device)


def solve_linear(
    stats: LinregStats, alpha: float, fit_intercept: bool = True, normalize: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form OLS (alpha == 0) / Spark ridge (alpha > 0):
    (Xc'WXc + alpha * wsum * I) b = Xc'Wy, intercept = ym - xm.b."""
    Gc, cc = _centered_system(stats, fit_intercept)
    s = _feature_scales(Gc, stats.wsum, normalize)
    Gs = Gc / torch.outer(s, s)
    cs = cc / s
    d = Gs.shape[0]
    eye = torch.eye(d, dtype=Gs.dtype, device=Gs.device)
    A = Gs + (alpha * stats.wsum) * eye
    # a tiny jitter keeps rank-deficient OLS solvable
    jitter = torch.finfo(Gs.dtype).eps * torch.trace(Gs) / d
    b = torch.linalg.solve(A + jitter * eye, cs) / s
    return b, _intercept(stats, b, fit_intercept)


def _cd_sweep(
    G: torch.Tensor,
    c: torch.Tensor,
    Gd: torch.Tensor,
    denom: torch.Tensor,
    n: torch.Tensor,
    thresh: torch.Tensor,
    b: torch.Tensor,
    max_delta: torch.Tensor,
    coords: Optional[range] = None,
) -> None:
    """One cyclic sweep over the coordinates (all of them, or `coords`),
    updating b and max_delta (the largest |change| of the sweep) in place:
        rho_j = (c_j - G_j.b + G_jj b_j) / n
        b_j   = soft(rho_j, thresh) / denom_j
    with soft(rho, t) = rho - clamp(rho, -t, t), softshrink bit for bit,
    and thresh a tensor, so a captured sweep reads it from its buffer."""
    max_delta.zero_()
    neg = -thresh
    for j in range(G.shape[0]) if coords is None else coords:
        bj_old = b[j]
        rho = (c[j] - torch.dot(G[j], b) + Gd[j] * bj_old) / n
        bj = (rho - torch.clamp(rho, neg, thresh)) / denom[j]
        torch.maximum(max_delta, (bj - bj_old).abs(), out=max_delta)
        b[j] = bj


def _sweep_runner(sweep: Callable[..., None], device: torch.device) -> Callable[[], None]:
    """`sweep` itself on the CPU; on the card a CUDA graph of one sweep,
    captured once (counted in glm.cd_graph_captures), whose replay runs the
    same launches on the same tensors.  Graph capture asks for a warm-up on
    a side stream: one coordinate's update (a whole eager sweep costs ~9x a
    replay at D = 3000 on an H100)."""
    if device.type != "cuda":
        return sweep
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        sweep(range(1))
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sweep()
    profiling.incr_counter("glm.cd_graph_captures")
    return graph.replay


def _cd_system(
    stats: LinregStats, alpha: float, l1_ratio: float, fit_intercept: bool, normalize: bool
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """((G, c, Gd, denom, n, thresh), s): _cd_sweep's arguments before b,
    in the scaled space, and the feature scales s."""
    Gc, cc = _centered_system(stats, fit_intercept)
    s = _feature_scales(Gc, stats.wsum, normalize)
    G = (Gc / torch.outer(s, s)).contiguous()
    Gd = torch.diagonal(G).contiguous()
    denom = Gd / stats.wsum + alpha * (1.0 - l1_ratio)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    thresh = torch.tensor(alpha * l1_ratio, dtype=G.dtype, device=G.device)
    return (G, cc / s, Gd, denom, stats.wsum, thresh), s


class _CdRunner:
    """The static buffers of one CD system shape, (G, c, Gd, denom, n,
    thresh, b, max_delta), and the sweep over them: a captured graph on the
    card, the eager sweep on the CPU.  `lock` serialises the solves that
    share them."""

    def __init__(self, d: int, dtype: torch.dtype, device: torch.device) -> None:
        def z(*shape: int) -> torch.Tensor:
            return torch.zeros(shape, dtype=dtype, device=device)

        self.system = (z(d, d), z(d), z(d), z(d), z(), z())
        self.b, self.max_delta = z(d), z()
        self.lock = threading.Lock()
        self.run = _sweep_runner(partial(_cd_sweep, *self.system, self.b, self.max_delta), device)


_CD_RUNNERS: Dict[Tuple[int, torch.dtype, str], _CdRunner] = {}
_CD_RUNNERS_LOCK = threading.Lock()


def _cd_runner(d: int, dtype: torch.dtype, device: torch.device) -> _CdRunner:
    """The runner of (d, dtype, device), built (and on the card captured)
    on first use."""
    key = (d, dtype, str(device))
    with _CD_RUNNERS_LOCK:
        runner = _CD_RUNNERS.get(key)
        if runner is None:
            runner = _CD_RUNNERS[key] = _CdRunner(d, dtype, device)
        return runner


def solve_elasticnet_cd(
    stats: LinregStats,
    alpha: float,
    l1_ratio: float,
    fit_intercept: bool = True,
    normalize: bool = False,
    max_iter: int = 1000,
    tol: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Covariance-update cyclic coordinate descent on the (D, D) system:

        obj = (1/2n)||y - Xb||^2 + alpha (l1r |b|_1 + (1 - l1r)/2 |b|_2^2)

    Sweeps until the largest coefficient change of a sweep is <= tol or
    max_iter sweeps ran.  Returns (coef, intercept, n_sweeps)."""
    system, s = _cd_system(stats, alpha, l1_ratio, fit_intercept, normalize)
    G = system[0]
    n_iter = 0
    if max_iter <= 0:
        b = torch.zeros(G.shape[0], dtype=G.dtype, device=G.device)
    else:
        runner = _cd_runner(G.shape[0], G.dtype, G.device)
        with runner.lock:
            for buf, value in zip(runner.system, system):
                buf.copy_(value)
            runner.b.zero_()
            while n_iter < max_iter:
                runner.run()
                n_iter += 1
                if not float(runner.max_delta) > tol:
                    break
            b = runner.b.clone()
    b = b / s
    return b, _intercept(stats, b, fit_intercept), n_iter


# -- the batched sweep ------------------------------------------------------


def fold_stats(stats: LinregStats, f: int) -> LinregStats:
    """Fold f's statistics out of stats with a leading (k,) axis."""
    return LinregStats(*(t[f] for t in stats))


def _local_fold_stats(
    X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, fold_id: torch.Tensor, k: int, chunk: int
) -> Tuple[torch.Tensor, ...]:
    """One shard's unreduced fold statistics (wsum, xwsum, G, ywsum, c, y2),
    each with a leading (k,) axis."""
    n, d = X.shape

    def z(*shape: int) -> torch.Tensor:
        return torch.zeros((k, *shape), dtype=X.dtype, device=X.device)

    wsum, xwsum, G, ywsum, c, y2 = z(), z(d), z(d, d), z(), z(d), z()
    folds = torch.arange(k, dtype=fold_id.dtype, device=X.device)
    for sl in chunk_iter(n, max(1, chunk)):
        xb, yb = X[sl], y[sl].to(X.dtype)
        wk = w[sl].to(X.dtype)[None, :] * (fold_id[sl][None, :] != folds[:, None]).to(X.dtype)
        for f in range(k):
            wf = wk[f]
            xw = xb * wf[:, None]
            wsum[f] += wf.sum()
            xwsum[f] += xw.sum(dim=0)
            G[f].addmm_(xw.T, xb)
            ywsum[f] += (yb * wf).sum()
            c[f].addmv_(xw.T, yb)
            y2[f] += (yb * yb * wf).sum()
    return wsum, xwsum, G, ywsum, c, y2


def sweep_linreg_fold_stats(X, y, w, fold_id, k: int, chunk: int = MOMENT_CHUNK) -> LinregStats:
    """Every fold's TRAIN sufficient statistics, a leading (k,) axis on each
    field, from one pass over the row-sharded (X, y, w, fold_id) in
    `chunk`-row blocks, the shards' sums combined by one psum.  Fold f's
    train weights are w * (fold_id != f) (padded rows carry fold -1 and
    weight 0).  A chunk's k masked Grams X_c^T diag(w_f) X_c each take one
    (chunk, D) weighted block: X * w_f is never formed for the whole X, and
    no train Gram is the total less the held-out fold's (that cancels in
    float32)."""
    shards = zip(as_shards(X), as_shards(y), as_shards(w), as_shards(fold_id))
    parts = [_local_fold_stats(x, yl, wl, fl, k, chunk) for x, yl, wl, fl in shards]
    wsum, xwsum, G, ywsum, c, y2 = psum_fields(parts, "glm.fold_stats")
    return LinregStats(wsum, xwsum / wsum[:, None], ywsum / wsum, G, c, y2)


def sweep_solve_linear(
    stats: LinregStats, alphas: Sequence[float], fit_intercept: bool = True, normalize: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (fold, lane) closed-form OLS / ridge solve, one solve_linear
    each, in order: coef (k, m, D), intercept (k, m)."""
    out = [
        [solve_linear(fold_stats(stats, f), float(a), fit_intercept=fit_intercept, normalize=normalize) for a in alphas]
        for f in range(stats.G.shape[0])
    ]
    return (
        torch.stack([torch.stack([b for b, _ in lanes]) for lanes in out]),
        torch.stack([torch.stack([b0 for _, b0 in lanes]) for lanes in out]),
    )


def sweep_solve_elasticnet_cd(
    stats: LinregStats,
    alphas: Sequence[float],
    l1_ratios: Sequence[float],
    tol: float,
    fit_intercept: bool = True,
    normalize: bool = False,
    max_iter: int = 1000,
) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Every (fold, lane) coordinate-descent solve, each lane its own
    solve_elasticnet_cd run to its own convergence, so its sweep count is
    the sequential fit's; on the card every lane replays the one captured
    sweep of the system's shape.  Returns (coef (k, m, D), intercept
    (k, m), sweeps (k, m) int64)."""
    k = stats.G.shape[0]
    coefs: List[List[torch.Tensor]] = []
    intercepts: List[List[torch.Tensor]] = []
    sweeps = np.zeros((k, len(alphas)), dtype=np.int64)
    for f in range(k):
        st = fold_stats(stats, f)
        coefs.append([])
        intercepts.append([])
        for j, (a, l1) in enumerate(zip(alphas, l1_ratios)):
            b, b0, n_iter = solve_elasticnet_cd(
                st, float(a), float(l1), fit_intercept=fit_intercept, normalize=normalize,
                max_iter=max_iter, tol=float(tol),
            )
            coefs[f].append(b)
            intercepts[f].append(b0)
            sweeps[f, j] = n_iter
    return (
        torch.stack([torch.stack(row) for row in coefs]),
        torch.stack([torch.stack(row) for row in intercepts]),
        sweeps,
    )


def linear_predict_kernel(X, coef: torch.Tensor, intercept: torch.Tensor) -> torch.Tensor:
    """X @ coef + intercept for a dense (N, D) tensor or an EllMatrix."""
    from .sparse import EllMatrix, ell_matvec

    if isinstance(X, EllMatrix):
        return ell_matvec(X, coef) + intercept
    return exact_matmul(X, coef) + intercept


def multi_linear_predict_kernel(X: torch.Tensor, coefs: torch.Tensor, intercepts: torch.Tensor) -> torch.Tensor:
    """(N, D) rows x (M, D) coefficients -> (M, N): one product predicting
    for M combined models."""
    return exact_matmul(coefs, X.T) + intercepts[:, None]


def lane_linear_predict_kernel(
    X: torch.Tensor, lanes: torch.Tensor, coefs: torch.Tensor, intercepts: torch.Tensor
) -> torch.Tensor:
    """Multiplexed linear_predict_kernel: coefs (L, D) and intercepts (L,)
    are lane-stacked variant parameters, and row r predicts with lane
    lanes[r] — each lane's rows through linear_predict_kernel itself
    (ops/linalg's header states the contract)."""
    return by_lane(X, lanes, lambda rows, lane: linear_predict_kernel(rows, coefs[lane], intercepts[lane]))
