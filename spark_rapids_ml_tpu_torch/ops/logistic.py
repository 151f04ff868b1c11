#
# Logistic-regression objective and its fit / predict functions (binary
# sigmoid and multinomial softmax) on one device.
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
# Not carried over yet: the sweep and streaming kernels (ROADMAP A7, A12)
# and lane_logistic_predict_kernel (A13).
#

from __future__ import annotations

from typing import Tuple, Union

import torch

from .lbfgs import minimize_lbfgs
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


def _solve_from(X, y_enc, w, theta0, k, reg, l1_ratio, fit_intercept, max_iter, tol, use_owlqn):
    """L-BFGS / OWL-QN from an explicit start: (W (k, D), b (k,), n_iter,
    converged, n_evals)."""
    d = X.shape[1]
    n_params = k * d + (k if fit_intercept else 0)
    dtype, dev = theta0.dtype, theta0.device
    l2 = reg * (1.0 - l1_ratio)
    l1 = reg * l1_ratio
    reg_mask = torch.cat(
        [torch.ones(k * d, dtype=dtype, device=dev), torch.zeros(n_params - k * d, dtype=dtype, device=dev)]
    )
    y = y_enc.to(dtype) if k == 1 else y_enc.long()
    w = w.to(dtype)
    wsum = w.sum()

    def value_and_grad(theta):
        value, grad = _data_value_and_grad(theta, X, y, w, wsum, k, d, fit_intercept)
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
    """Fit one logistic model from zero: k == 1 is the binary sigmoid
    (y_enc in {0, 1}), k >= 2 the multinomial softmax (y_enc = class
    index).  Returns (W (k, D), b (k,), n_iter, converged, n_evals)."""
    d = X.shape[1]
    n_params = k * d + (k if fit_intercept else 0)
    theta0 = torch.zeros(n_params, dtype=X.dtype, device=X.device)
    return _solve_from(X, y_enc, w, theta0, k, reg, l1_ratio, fit_intercept, max_iter, tol, use_owlqn)


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
