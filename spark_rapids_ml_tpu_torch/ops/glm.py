#
# Linear-model solvers: OLS / ridge in closed form, elastic net by
# covariance-update coordinate descent, on sufficient statistics.
#
# Counterpart of spark_rapids_ml_tpu/ops/glm.py on one device.  One pass
# over the rows forms (X'WX, X'Wy, the means) in row chunks
# (ops/linalg._local_moments), and every solve runs on the small (D, D)
# system on the statistics' device: on the card the solve, the CD sweeps and
# the intercept's inputs never leave it.
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
# path_linreg); on the CPU the same sweep runs eagerly.
# Not carried over yet: the sweep_* lanes (ROADMAP A7), the stream_* kernels
# (A12) and the multi_ / lane_ predict kernels (A13).
#

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .linalg import MOMENT_CHUNK, _local_moments, exact_matmul


class LinregStats(NamedTuple):
    wsum: torch.Tensor    # scalar: total weight (the row count without weightCol)
    x_mean: torch.Tensor  # (D,)
    y_mean: torch.Tensor  # scalar
    G: torch.Tensor       # (D, D) = X'WX (uncentred)
    c: torch.Tensor       # (D,)   = X'Wy (uncentred)
    y2: torch.Tensor      # scalar = sum w y^2


def linreg_sufficient_stats(
    X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, chunk: int = MOMENT_CHUNK
) -> LinregStats:
    """One pass over (X, y, w) in `chunk`-row blocks."""
    wsum, xwsum, G, ywsum, c, y2 = _local_moments(X, w, chunk, y=y)
    return LinregStats(wsum, xwsum / wsum, ywsum / wsum, G, c, y2)


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
    thresh: float,
    b: torch.Tensor,
    max_delta: torch.Tensor,
    coords: Optional[range] = None,
) -> None:
    """One cyclic sweep over the coordinates (all of them, or `coords`),
    updating b and max_delta (the largest |change| of the sweep) in place:
        rho_j = (c_j - G_j.b + G_jj b_j) / n
        b_j   = soft(rho_j, thresh) / denom_j
    softshrink(rho, thresh) is sign(rho) max(|rho| - thresh, 0) bit for
    bit."""
    max_delta.zero_()
    for j in range(G.shape[0]) if coords is None else coords:
        bj_old = b[j]
        rho = (c[j] - torch.dot(G[j], b) + Gd[j] * bj_old) / n
        bj = torch.nn.functional.softshrink(rho, thresh) / denom[j]
        torch.maximum(max_delta, (bj - bj_old).abs(), out=max_delta)
        b[j] = bj


def _sweep_runner(sweep: Callable[..., None], device: torch.device) -> Callable[[], None]:
    """`sweep` itself on the CPU; on the card a CUDA graph of one sweep,
    captured once, whose replay runs the same launches.  Graph capture asks
    for a warm-up on a side stream: one coordinate's update (a whole eager
    sweep costs ~9x a replay at D = 3000 on an H100)."""
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
    return graph.replay


def _cd_system(
    stats: LinregStats, alpha: float, l1_ratio: float, fit_intercept: bool, normalize: bool
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, float], torch.Tensor]:
    """((G, c, Gd, denom, n, thresh), s): _cd_sweep's arguments before b,
    in the scaled space, and the feature scales s."""
    Gc, cc = _centered_system(stats, fit_intercept)
    s = _feature_scales(Gc, stats.wsum, normalize)
    G = (Gc / torch.outer(s, s)).contiguous()
    Gd = torch.diagonal(G).contiguous()
    denom = Gd / stats.wsum + alpha * (1.0 - l1_ratio)
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return (G, cc / s, Gd, denom, stats.wsum, float(alpha * l1_ratio)), s


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
    b = torch.zeros(G.shape[0], dtype=G.dtype, device=G.device)
    max_delta = torch.zeros((), dtype=G.dtype, device=G.device)
    n_iter = 0
    if max_iter > 0:
        run = _sweep_runner(partial(_cd_sweep, *system, b, max_delta), G.device)
        # the graph's warm-up updated b: start over
        b.zero_()
        while n_iter < max_iter:
            run()
            n_iter += 1
            if not float(max_delta) > tol:
                break
    b = b / s
    return b, _intercept(stats, b, fit_intercept), n_iter


def linear_predict_kernel(X, coef: torch.Tensor, intercept: torch.Tensor) -> torch.Tensor:
    """X @ coef + intercept for a dense (N, D) tensor or an EllMatrix."""
    from .sparse import EllMatrix, ell_matvec

    if isinstance(X, EllMatrix):
        return ell_matvec(X, coef) + intercept
    return exact_matmul(X, coef) + intercept
