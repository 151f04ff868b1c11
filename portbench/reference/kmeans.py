#
# Plain reference of a KMeans fit (init "random", Lloyd), in PyTorch.
#
# It takes the run's host rows and an estimator seed, nothing the port has
# made.  The init: Spark's "random" init as the port and the JAX package
# draw it, k distinct rows by the Gumbel-max trick over
# jax.random.PRNGKey(seed): the k rows of the largest Gumbel keys, in
# descending order, ties to the lower row.  A Gumbel key is -log(-log u) of
# u from the top 23 bits of the row's threefry word, so it orders the rows
# as those bits do (the bits' order breaks no tie among the largest keys:
# consecutive 23-bit values there lie ~1e-4 apart in the key); the words
# come from threefry.py.  Lloyd: squared distances in the expanded form
# ||x||^2 - 2 x.c + ||c||^2 over blocks of rows, the first nearest center,
# the new center the mean of its rows (kept where it has none), until the
# summed squared shift of the centers is at most tol or max_iter iterations
# ran; the inertia is the difference form against the returned centers,
# summed in float64.  float32 with TF32 off, the precision the
# configuration states; tf32=True computes the products in TF32, the
# control (a lower precision) that the check must refuse.
#

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from ..data import estimator_seed
from . import threefry

BLOCK_ROWS = 32768


@contextlib.contextmanager
def matmul_precision(tf32: bool) -> Iterator[None]:
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def init_rows(n_rows: int, k: int, seed: int, device) -> torch.Tensor:
    """Rows (k,) of the "random" init, in the order the centers take."""
    bits = threefry.words(threefry.key(seed), torch.arange(n_rows, dtype=torch.int64, device=device))
    mantissa = bits >> 9
    # descending mantissa, ties to the lower row: sort on (-mantissa, row)
    order = torch.sort(-mantissa, stable=True).indices
    return order[:k]


def upload(X: np.ndarray, device) -> torch.Tensor:
    out = torch.empty(X.shape, dtype=torch.float32, device=device)
    for lo in range(0, X.shape[0], 1 << 18):
        out[lo : lo + (1 << 18)].copy_(torch.from_numpy(X[lo : lo + (1 << 18)]))
    return out


def lloyd(X: torch.Tensor, centers: torch.Tensor, max_iter: int, tol: float, block_rows: int = BLOCK_ROWS):
    """(centers, iterations, inertia) of Lloyd from `centers`, over blocks of
    `block_rows` rows."""
    BLOCK_ROWS = block_rows  # noqa: N806
    n, d = X.shape
    k = centers.shape[0]
    x_norm = torch.empty(n, dtype=X.dtype, device=X.device)
    for lo in range(0, n, BLOCK_ROWS):
        xb = X[lo : lo + BLOCK_ROWS]
        x_norm[lo : lo + BLOCK_ROWS] = (xb * xb).sum(dim=1)
    n_iter, shift = 0, math.inf
    while n_iter < max_iter and shift > tol:
        c_norm = (centers * centers).sum(dim=1)
        sums = torch.zeros((k, d), dtype=X.dtype, device=X.device)
        counts = torch.zeros(k, dtype=X.dtype, device=X.device)
        for lo in range(0, n, BLOCK_ROWS):
            xb = X[lo : lo + BLOCK_ROWS]
            d2 = x_norm[lo : lo + BLOCK_ROWS, None] - 2.0 * (xb @ centers.T) + c_norm[None, :]
            assign = torch.argmin(d2, dim=1)
            onehot = torch.zeros_like(d2).scatter_(1, assign[:, None], 1.0)
            sums += onehot.T @ xb
            counts += onehot.sum(dim=0)
        new = torch.where((counts > 0)[:, None], sums / counts.clamp_min(1.0)[:, None], centers)
        shift = float(((new - centers) ** 2).sum())
        centers = new
        n_iter += 1
    c_norm = (centers * centers).sum(dim=1)
    inertia = 0.0
    for lo in range(0, n, BLOCK_ROWS):
        xb = X[lo : lo + BLOCK_ROWS]
        d2 = x_norm[lo : lo + BLOCK_ROWS, None] - 2.0 * (xb @ centers.T) + c_norm[None, :]
        diff = (xb - centers[torch.argmin(d2, dim=1)]).double()
        inertia += float((diff * diff).sum())
    return centers, n_iter, inertia


def fit(X: torch.Tensor, params: Dict[str, Any], seed: int, tf32: bool = False,
        block_rows: int = BLOCK_ROWS) -> Dict[str, Any]:
    """The reference's fit of the device rows X with the estimator seed."""
    k = int(params["k"])
    with matmul_precision(tf32):
        centers0 = X[init_rows(X.shape[0], k, seed, X.device)]
        centers, n_iter, inertia = lloyd(X, centers0, int(params["maxIter"]), float(params.get("tol", 1e-4)),
                                         block_rows)
    return {"centers": centers.double().cpu().numpy(), "n_iter": n_iter, "inertia": inertia}


def compare(answer: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The worst center's distance from the reference's over the median
    reference center's norm, the inertia's relative gap, and the gap in
    iterations (the check compares those the configuration's limits
    name; control.py reports all three)."""
    c, r = np.asarray(answer["centers"], np.float64), ref["centers"]
    scale = float(np.median(np.linalg.norm(r, axis=1)))
    return {
        "centers_rel_err": float(np.linalg.norm(c - r, axis=1).max() / scale),
        "inertia_rel_err": abs(float(answer["inertia"]) - ref["inertia"]) / ref["inertia"],
        "n_iter_gap": float(abs(int(answer["n_iter"]) - ref["n_iter"])),
    }


def _answer(model) -> Dict[str, Any]:
    return {"centers": model.cluster_centers_, "n_iter": model.n_iter_, "inertia": model.inertia_}


def check(cfg: Dict[str, Any], mix: Dict[str, Any], inputs: Dict[str, Any], answers: List[Dict[str, Any]],
          seed: int, device) -> Dict[str, tuple]:
    """Every kept fit against the reference's fit of the same rows,
    parameters and estimator seed (drawn from the run's seed as the entry
    draws it): each number's worst reading with its limit."""
    if not answers:
        return {"answers_missing": (1, 0)}
    X = upload(inputs["X"], device)
    ref = fit(X, cfg["params"], estimator_seed(seed))
    del X
    worst: Dict[str, float] = {}
    for a in answers:
        for name, value in compare(_answer(a["model"]), ref).items():
            worst[name] = max(worst.get(name, 0.0), value)
    limits = cfg["limits"]
    return {name: (worst[name], limit) for name, limit in limits.items()}
