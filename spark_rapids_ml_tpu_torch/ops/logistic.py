#
# Logistic-regression objective and its fit / predict functions (binary
# sigmoid and multinomial softmax).
#
# Counterpart of spark_rapids_ml_tpu/ops/logistic.py.  The objective is the
# JAX package's (Spark's, with a non-normalised penalty):
#
#   f(W, b) = (1/sum w) sum_i w_i logloss_i
#           + reg (l1r |W|_1 + (1 - l1r)/2 |W|_2^2)
#
# intercepts never regularised, L1 through OWL-QN (ops/lbfgs.py).  The JAX
# package's two data losses (_binary_data_loss, _softmax_data_loss) and
# jax.grad become one function returning the value and the closed-form
# gradient, so a dense evaluation reads X twice, once for the scores
# X W^T + b and once for R^T X, and an ELL evaluation's X^T R is
# ops/sparse.ell_rmatmat, whose bits do not change from run to run.
# On a mesh (X, labels and weights row-sharded: lists of per-shard tensors
# or EllMatrix; one tensor is the one-shard case) every evaluation runs the
# data term on each shard against the replicated coefficients and sums the
# shards' partial values and gradients with one psum_fields
# (parallel/exchange.py) on shard 0's device, where L-BFGS runs: the JAX
# package gets the same sums from GSPMD on its sharded arrays.  The
# line search still reads one value a step, not one a shard.
#
# sweep_logistic_fit_kernel fits a whole regularisation sweep, candidates x
# folds, as the lanes of one minimize_lbfgs_batched run over the one staged
# X: fold f trains on w * (fold_id != f), and an evaluation of every lane is
# two plain products, X (N, D) times the lanes' (D, k m kcls) block and the
# residual block's transpose times X, read once each (torch.matmul with
# TF32 off: the JAX package leaves them to XLA).
# logistic_warm_fit_kernel is the streaming engine's chunk update: the same
# objective from the running coefficients instead of zeros.
# lane_logistic_predict_kernel is the multiplexed serving kernel
# (serving/multiplex.py; ops/linalg's header states its contract): scores,
# probabilities and label indices in one call.
#

from __future__ import annotations

from typing import Tuple, Union

import torch

from ..parallel.exchange import psum_fields, replicate
from ..parallel.mesh import as_shards
from .lbfgs import minimize_lbfgs, minimize_lbfgs_batched
from .lanes import by_lane
from .linalg import exact_matmul
from .sparse import EllMatrix, ell_matmat, ell_rmatmat

Features = Union[torch.Tensor, EllMatrix]


def _unpack(theta: torch.Tensor, k: int, d: int, fit_intercept: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    W = theta[: k * d].reshape(k, d)
    b = theta[k * d :] if fit_intercept else torch.zeros(k, dtype=theta.dtype, device=theta.device)
    return W, b


def _model_scores(X: Features, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X @ W.T + b, (N, k), for a dense (N, D) tensor or an EllMatrix."""
    if isinstance(X, EllMatrix):
        return ell_matmat(X, W.T) + b
    return exact_matmul(X, W.T) + b


def _scores_transpose(X: Features, R: torch.Tensor) -> torch.Tensor:
    """R^T @ X, (k, D), for R (N, k)."""
    if isinstance(X, EllMatrix):
        return ell_rmatmat(X, R).T
    return exact_matmul(R.T, X)


def _data_value_and_grad(theta, X, y_enc, w, wsum, k, d, fit_intercept) -> Tuple[torch.Tensor, torch.Tensor]:
    """The data term's value and closed-form gradient: the scores' gradient
    r (N, k) weighted by w / wsum, then R^T X and the column sums of r."""
    W, b = _unpack(theta, k, d, fit_intercept)
    z = _model_scores(X, W, b)
    if k == 1:
        z1 = z[:, 0]
        ll = torch.logaddexp(torch.zeros_like(z1), z1) - y_enc * z1
        r = (torch.sigmoid(z1) - y_enc)[:, None]
    else:
        lse = torch.logsumexp(z, dim=1, keepdim=True)
        ll = -(z - lse).gather(1, y_enc[:, None])[:, 0]
        r = torch.exp(z - lse)
        r.scatter_add_(1, y_enc[:, None], torch.full_like(z[:, :1], -1.0))
    value = (ll * w).sum() / wsum
    r = r * (w / wsum)[:, None]
    parts = [_scores_transpose(X, r).reshape(-1)]
    if fit_intercept:
        parts.append(r.sum(dim=0))
    return value, torch.cat(parts)


def _sharded_value_and_grad(theta, Xs, ys, ws, wsum, k, d, fit_intercept) -> Tuple[torch.Tensor, torch.Tensor]:
    """_data_value_and_grad of every shard against the replicated theta,
    summed over the shards by one psum: (value, grad) on shard 0's
    device."""
    devices = [w.device for w in ws]
    parts = [
        _data_value_and_grad(t, x, y, w, s, k, d, fit_intercept)
        for t, s, x, y, w in zip(replicate(theta, devices), replicate(wsum, devices), Xs, ys, ws)
    ]
    return psum_fields(parts, "logistic.objective")


def _solve_from(X, y_enc, w, theta0, k, reg, l1_ratio, fit_intercept, max_iter, tol, use_owlqn):
    """L-BFGS / OWL-QN over the row-sharded (X, y_enc, w) from an explicit
    start on shard 0's device: (W (k, D), b (k,), n_iter, converged,
    n_evals)."""
    Xs, ys, ws = as_shards(X), as_shards(y_enc), as_shards(w)
    d = Xs[0].shape[1]
    n_params = k * d + (k if fit_intercept else 0)
    dtype, dev = theta0.dtype, theta0.device
    l2 = reg * (1.0 - l1_ratio)
    l1 = reg * l1_ratio
    reg_mask = torch.cat(
        [torch.ones(k * d, dtype=dtype, device=dev), torch.zeros(n_params - k * d, dtype=dtype, device=dev)]
    )
    ys = [y.to(dtype) if k == 1 else y.long() for y in ys]
    ws = [wl.to(dtype) for wl in ws]
    (wsum,) = psum_fields([(wl.sum(),) for wl in ws], "logistic.wsum")

    def value_and_grad(theta):
        value, grad = _sharded_value_and_grad(theta, Xs, ys, ws, wsum, k, d, fit_intercept)
        masked = theta * reg_mask
        return value + 0.5 * l2 * (masked * masked).sum(), grad + l2 * masked

    result = minimize_lbfgs(
        value_and_grad, theta0, l1_weight=l1 * reg_mask, max_iter=max_iter, tol=tol, history=10,
        use_owlqn=use_owlqn,
    )
    W, b = _unpack(result.x, k, d, fit_intercept)
    return W, b, result.n_iter, result.converged, result.n_evals


def logistic_fit_kernel(
    X: Features,
    y_enc: torch.Tensor,
    w: torch.Tensor,
    k: int,
    reg: float,
    l1_ratio: float,
    fit_intercept: bool,
    max_iter: int,
    tol: float,
    use_owlqn: bool,
):
    """Fit one logistic model from zero over the row-sharded (X, y_enc, w):
    k == 1 is the binary sigmoid (y_enc in {0, 1}), k >= 2 the multinomial
    softmax (y_enc = class index).  Returns (W (k, D), b (k,), n_iter,
    converged, n_evals), on shard 0's device."""
    x0 = as_shards(X)[0]
    d = x0.shape[1]
    n_params = k * d + (k if fit_intercept else 0)
    theta0 = torch.zeros(n_params, dtype=x0.dtype, device=x0.device)
    return _solve_from(X, y_enc, w, theta0, k, reg, l1_ratio, fit_intercept, max_iter, tol, use_owlqn)


def logistic_warm_fit_kernel(
    X: Features,
    y_enc: torch.Tensor,
    w: torch.Tensor,
    W0: torch.Tensor,
    b0: torch.Tensor,
    reg: float,
    l1_ratio: float,
    tol: float,
    k: int,
    fit_intercept: bool,
    max_iter: int,
    use_owlqn: bool,
):
    """logistic_fit_kernel warm-started from (W0 (k, D), b0 (k,)): the
    streaming partial_fit update, each chunk resuming the solve from the
    running coefficients.  Same objective and fixed point as the batch
    kernel.  Returns (W, b, n_iter, converged, n_evals)."""
    x0 = as_shards(X)[0]
    theta0 = W0.reshape(-1).to(device=x0.device, dtype=x0.dtype)
    if fit_intercept:
        theta0 = torch.cat([theta0, b0.to(device=x0.device, dtype=x0.dtype)])
    return _solve_from(X, y_enc, w, theta0, k, reg, l1_ratio, fit_intercept, max_iter, tol, use_owlqn)


def sweep_logistic_fit_kernel(
    X,
    y_enc,
    w,
    fold_id,
    regs: torch.Tensor,
    l1_ratios: torch.Tensor,
    tol: float,
    k_folds: int,
    kcls: int,
    fit_intercept: bool,
    max_iter: int,
    use_owlqn: bool,
):
    """Fit m candidates (regs, l1_ratios: (m,) lane values) x k_folds folds
    as one lane-batched L-BFGS / OWL-QN run over the dense, row-sharded
    (X, y_enc, w, fold_id); lane f * m + j is fold f's fit of candidate j.
    Each evaluation sums the shards' partial values and gradients with one
    psum.  Returns (W (k, m, kcls, D), b (k, m, kcls), n_iter (k, m),
    converged (k, m), n_evals), on shard 0's device."""
    Xs, ys, ws, fids = as_shards(X), as_shards(y_enc), as_shards(w), as_shards(fold_id)
    d = Xs[0].shape[1]
    m = regs.shape[0]
    lanes = k_folds * m
    kd = kcls * d
    n_params = kd + (kcls if fit_intercept else 0)
    dtype, dev = Xs[0].dtype, Xs[0].device
    devices = [x.device for x in Xs]

    def fold_weights(wl, fl):
        folds = torch.arange(k_folds, dtype=fl.dtype, device=fl.device)
        return wl.to(dtype)[None, :] * (fl[None, :] != folds[:, None]).to(dtype)  # (k, n_loc)

    w_folds = [fold_weights(wl, fl) for wl, fl in zip(ws, fids)]
    (wsum,) = psum_fields([(wf.sum(dim=1),) for wf in w_folds], "logistic.wsum")
    shards = []
    for x, yl, wf, wsum_l in zip(Xs, ys, w_folds, replicate(wsum, devices)):
        shards.append((
            x,
            yl.to(dtype) if kcls == 1 else yl.long(),
            wf.T[:, :, None],  # (n_loc, k, 1)
            (wf / wsum_l[:, None]).T[:, :, None],  # (n_loc, k, 1)
            wsum_l,
        ))
    regs = regs.to(device=dev, dtype=torch.float64)
    l1_ratios = l1_ratios.to(device=dev, dtype=torch.float64)
    l2 = (regs * (1.0 - l1_ratios)).to(dtype).repeat(k_folds)  # (lanes,)
    l1 = (regs * l1_ratios).to(dtype).repeat(k_folds)
    reg_mask = torch.cat([torch.ones(kd, dtype=dtype, device=dev), torch.zeros(n_params - kd, dtype=dtype, device=dev)])

    def shard_value_and_grad(theta, x, y, w_rows, scale, wsum_l):  # one shard's partials
        n = x.shape[0]
        W = theta[:, :kd].reshape(lanes * kcls, d)
        z = exact_matmul(x, W.T).reshape(n, k_folds, m, kcls)
        if fit_intercept:
            z = z + theta[:, kd:].reshape(k_folds, m, kcls)[None]
        if kcls == 1:
            z1 = z[..., 0]  # (N, k, m)
            yb = y[:, None, None]
            ll = torch.logaddexp(torch.zeros_like(z1), z1) - yb * z1
            r = (torch.sigmoid(z1) - yb)[..., None]
        else:
            lse = torch.logsumexp(z, dim=-1, keepdim=True)
            idx = y[:, None, None, None].expand(n, k_folds, m, 1)
            ll = -(z - lse).gather(-1, idx)[..., 0]
            r = torch.exp(z - lse)
            r.scatter_add_(-1, idx, torch.full_like(r[..., :1], -1.0))
        value = (ll * w_rows).sum(dim=0) / wsum_l[:, None]  # (k, m)
        R = (r * scale[..., None]).reshape(n, lanes * kcls)
        parts = [exact_matmul(R.T, x).reshape(lanes, kd)]
        if fit_intercept:
            parts.append(R.sum(dim=0).reshape(lanes, kcls))
        return value.reshape(lanes), torch.cat(parts, dim=1)

    def value_and_grad(theta):  # (lanes, P) -> ((lanes,), (lanes, P))
        parts = [shard_value_and_grad(t, *sh) for t, sh in zip(replicate(theta, devices), shards)]
        value, grad = psum_fields(parts, "logistic.objective")
        masked = theta * reg_mask
        return value + 0.5 * l2 * (masked * masked).sum(dim=-1), grad + l2[:, None] * masked

    result = minimize_lbfgs_batched(
        value_and_grad,
        torch.zeros((lanes, n_params), dtype=dtype, device=dev),
        l1_weight=l1[:, None] * reg_mask[None, :],
        max_iter=max_iter,
        tol=tol,
        history=10,
        use_owlqn=use_owlqn,
    )
    W = result.x[:, :kd].reshape(k_folds, m, kcls, d)
    if fit_intercept:
        b = result.x[:, kd:].reshape(k_folds, m, kcls)
    else:
        b = torch.zeros((k_folds, m, kcls), dtype=dtype, device=dev)
    return (
        W,
        b,
        result.n_iter.reshape(k_folds, m),
        result.converged.reshape(k_folds, m),
        result.n_evals,
    )


def logistic_decision_kernel(X: Features, W: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Raw decision scores (N, k): one column for binary, k for
    multinomial."""
    return _model_scores(X, W, b)


def scores_to_probs(scores: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Sigmoid for binary single-column scores, stable softmax otherwise."""
    if num_classes == 2 and scores.shape[1] == 1:
        p1 = torch.sigmoid(scores[:, 0])
        return torch.stack([1.0 - p1, p1], dim=1)
    return torch.softmax(scores, dim=1)


def scores_to_labels(scores: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Class index of each row, as float32."""
    if num_classes == 2 and scores.shape[1] == 1:
        return (scores[:, 0] > 0).to(torch.float32)
    return torch.argmax(scores, dim=1).to(torch.float32)


def lane_logistic_predict_kernel(
    X: torch.Tensor, lanes: torch.Tensor, Ws: torch.Tensor, bs: torch.Tensor, *, num_classes: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multiplexed serve kernel: Ws (L, k, D) and bs (L, k) are lane-stacked
    variant parameters and row r scores against lane lanes[r] (each lane's
    rows through logistic_decision_kernel itself); decision scores,
    probabilities and label indices come out of one call."""
    scores = by_lane(X, lanes, lambda rows, lane: logistic_decision_kernel(rows, Ws[lane], bs[lane]))
    return scores, scores_to_probs(scores, num_classes), scores_to_labels(scores, num_classes)
