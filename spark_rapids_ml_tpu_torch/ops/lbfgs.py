#
# L-BFGS and OWL-QN on one device.
#
# Counterpart of spark_rapids_ml_tpu/ops/lbfgs.py's minimize_lbfgs.  The JAX
# package runs the whole minimisation as one jitted while_loop; here it is a
# Python loop over tensors on the parameters' device, and the host reads a
# device scalar at each Armijo test and at each iteration's stop tests (one
# synchronisation a line-search step).  The algorithm is kept exactly:
# history 10 in circular (history, P) buffers; up to 20 backtracking steps
# from t0 = 1 / max(||pg||, 1) while the history is empty and 1 after, each
# failed step halving t; the Armijo constant 1e-4; a pair stored only when
# s.y > 1e-10; the current iterate kept when the line search is exhausted;
# and the three stop tests (relative improvement, the (pseudo-)gradient's
# inf-norm, an exhausted line search).  OWL-QN handles the L1 term with a
# per-coordinate weight vector, so intercepts stay unregularised.
# minimize_lbfgs_batched (the sweep's lanes) waits for ROADMAP A7.
#

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch


class LbfgsResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    n_iter: int
    converged: bool
    n_evals: int


def _pseudo_gradient(x: torch.Tensor, g: torch.Tensor, l1w: torch.Tensor) -> torch.Tensor:
    """OWL-QN pseudo-gradient: the subgradient of steepest descent."""
    right = g + l1w
    left = g - l1w
    zero = torch.zeros_like(g)
    pg_zero = torch.where(right < 0, right, torch.where(left > 0, left, zero))
    return torch.where(x != 0, g + l1w * torch.sign(x), pg_zero)


def _two_loop(
    g: torch.Tensor, S: torch.Tensor, Y: torch.Tensor, rho: torch.Tensor, count: int, history: int
) -> torch.Tensor:
    """The two-loop recursion over the circular (history, P) buffers,
    newest pair first in the backward loop."""
    used = min(count, history)
    q = g
    alphas = [None] * history
    for i in range(used):
        j = (count - 1 - i) % history
        a = rho[j] * (S[j] @ q)
        q = q - a * Y[j]
        alphas[j] = a
    last = (count - 1) % history
    if count > 0:
        sy = S[last] @ Y[last]
        yy = Y[last] @ Y[last]
        q = q * torch.where(yy > 0, sy / yy, torch.ones_like(yy))
    for i in range(used):
        j = (count - used + i) % history
        b = rho[j] * (Y[j] @ q)
        q = q + (alphas[j] - b) * S[j]
    return q


def minimize_lbfgs(
    value_and_grad: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    l1_weight: torch.Tensor,
    max_iter: int = 100,
    tol: float = 1e-6,
    history: int = 10,
    use_owlqn: bool = False,
    max_ls: int = 20,
) -> LbfgsResult:
    """Minimise f_smooth(x) + sum(l1_weight * |x|).

    value_and_grad returns (f_smooth, grad_smooth) as tensors; the L1 term
    is handled by OWL-QN when use_owlqn.  Stops when |f_k - f_{k-1}| <= tol
    max(|f_k|, 1), when the inf-norm of the (pseudo-)gradient is <= tol, or
    when the line search is exhausted.  n_evals counts value_and_grad
    calls."""
    P = x0.shape[0]
    dtype, dev = x0.dtype, x0.device
    l1w = l1_weight.to(dtype)
    n_evals = 0

    def full_objective(x):
        nonlocal n_evals
        n_evals += 1
        f, g = value_and_grad(x)
        if use_owlqn:
            f = f + (l1w * x.abs()).sum()
        return f, g

    x = x0
    f, g = full_objective(x0)
    S = torch.zeros((history, P), dtype=dtype, device=dev)
    Y = torch.zeros((history, P), dtype=dtype, device=dev)
    rho = torch.zeros(history, dtype=dtype, device=dev)
    count = it = 0
    converged = False
    while it < max_iter and not converged:
        pg = _pseudo_gradient(x, g, l1w) if use_owlqn else g
        d = -_two_loop(pg, S, Y, rho, count, history)
        if use_owlqn:
            # align the direction against the pseudo-gradient's orthant
            d = torch.where(d * -pg > 0, d, torch.zeros_like(d))
        # the reference orthant of the projected line search
        xi = torch.sign(x)
        if use_owlqn:
            xi = torch.where(x == 0, torch.sign(-pg), xi)
        deriv = pg @ d
        # steepest descent when the direction is not a descent one
        bad_dir = deriv >= 0
        d = torch.where(bad_dir, -pg, d)
        deriv = torch.where(bad_dir, -(pg @ pg), deriv)
        if count == 0:
            t = 1.0 / torch.clamp(torch.linalg.vector_norm(pg), min=1.0)
        else:
            t = torch.ones((), dtype=dtype, device=dev)
        ls_ok = False
        for _ in range(max_ls):
            x_new = x + t * d
            if use_owlqn:
                x_new = torch.where(torch.sign(x_new) == xi, x_new, torch.zeros_like(x_new))
            f_new, g_new = full_objective(x_new)
            ls_ok = bool(f_new <= f + 1e-4 * t * deriv)
            t = t * 0.5
            if ls_ok:
                break
        if not ls_ok:
            # keep the current iterate: the last trial point failed Armijo
            x_new, f_new, g_new = x, f, g
        s = x_new - x
        y = g_new - g
        sy = s @ y
        if bool(sy > 1e-10):
            slot = count % history
            S[slot] = s
            Y[slot] = y
            rho[slot] = 1.0 / sy
            count += 1
        pg_new = _pseudo_gradient(x_new, g_new, l1w) if use_owlqn else g_new
        converged = (
            not ls_ok
            or bool((f - f_new).abs() <= tol * torch.clamp(f_new.abs(), min=1.0))
            or bool(pg_new.abs().max() <= tol)
        )
        x, f, g = x_new, f_new, g_new
        it += 1
    return LbfgsResult(x=x, f=f, n_iter=it, converged=converged, n_evals=n_evals)
