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
#
# minimize_lbfgs_batched runs L independent minimisations as lanes of (L, P)
# tensors (the batched sweep's folds x candidates): one objective evaluation
# a step for all lanes, and per lane its own iteration counter, convergence
# tests, history and Armijo halving.  A lane that has stopped takes masked
# no-op updates, so its state freezes where its solo run stops; the host
# reads one device flag a line-search step and one an iteration.
#

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple, Union

import torch


class LbfgsResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    n_iter: Union[int, torch.Tensor]      # (L,) int64 for the lanes
    converged: Union[bool, torch.Tensor]  # (L,) bool for the lanes
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


def _two_loop_lanes(
    g: torch.Tensor, S: torch.Tensor, Y: torch.Tensor, rho: torch.Tensor, count: torch.Tensor, history: int
) -> torch.Tensor:
    """_two_loop for each lane of g (L, P), over the lanes' own (L, history,
    P) pair buffers held newest first (slot 0 the newest pair) and their
    pair counts (L,): the slots a lane has not filled take no part."""
    used = torch.clamp(count, max=history)
    q = g
    alphas = []
    for i in range(history):  # newest first
        a = rho[:, i] * (S[:, i] * q).sum(dim=-1) * (i < used).to(g.dtype)
        q = q - a[:, None] * Y[:, i]
        alphas.append(a)
    sy = (S[:, 0] * Y[:, 0]).sum(dim=-1)
    yy = (Y[:, 0] * Y[:, 0]).sum(dim=-1)
    ones = torch.ones_like(yy)
    q = q * torch.where((count > 0) & (yy > 0), sy / torch.where(yy > 0, yy, ones), ones)[:, None]
    for i in reversed(range(history)):  # oldest first
        b = rho[:, i] * (Y[:, i] * q).sum(dim=-1)
        q = q + ((alphas[i] - b) * (i < used).to(g.dtype))[:, None] * S[:, i]
    return q


def minimize_lbfgs_batched(
    value_and_grad: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    l1_weight: torch.Tensor,
    max_iter: int = 100,
    tol: float = 1e-6,
    history: int = 10,
    use_owlqn: bool = False,
    max_ls: int = 20,
) -> LbfgsResult:
    """minimize_lbfgs for each lane of x0 (L, P), with l1_weight (L, P);
    value_and_grad maps (L, P) -> ((L,), (L, P)) and is evaluated for every
    lane at each step.  A lane runs until its own stop tests or its own
    iteration budget end it, each lane halving its own step until its own
    Armijo test passes; a stopped lane's state, history and n_iter stay as
    its solo run leaves them.  Its numbers may differ from a solo run in
    the last bits (the lanes' dot products reduce in another order).
    n_iter and converged are (L,) tensors; n_evals counts evaluations of
    all lanes."""
    L, P = x0.shape
    dtype, dev = x0.dtype, x0.device
    l1w = l1_weight.to(dtype)
    n_evals = 0

    def full_objective(x):
        nonlocal n_evals
        n_evals += 1
        f, g = value_and_grad(x)
        if use_owlqn:
            f = f + (l1w * x.abs()).sum(dim=-1)
        return f, g

    x = x0
    f, g = full_objective(x0)
    S = torch.zeros((L, history, P), dtype=dtype, device=dev)
    Y = torch.zeros((L, history, P), dtype=dtype, device=dev)
    rho = torch.zeros((L, history), dtype=dtype, device=dev)
    count = torch.zeros(L, dtype=torch.int64, device=dev)
    it = torch.zeros(L, dtype=torch.int64, device=dev)
    converged = torch.zeros(L, dtype=torch.bool, device=dev)
    while True:
        active = (it < max_iter) & ~converged
        if not bool(active.any()):
            break
        pg = _pseudo_gradient(x, g, l1w) if use_owlqn else g
        d = -_two_loop_lanes(pg, S, Y, rho, count, history)
        if use_owlqn:
            d = torch.where(d * -pg > 0, d, torch.zeros_like(d))
        xi = torch.sign(x)
        if use_owlqn:
            xi = torch.where(x == 0, torch.sign(-pg), xi)
        deriv = (pg * d).sum(dim=-1)
        bad_dir = deriv >= 0
        d = torch.where(bad_dir[:, None], -pg, d)
        deriv = torch.where(bad_dir, -(pg * pg).sum(dim=-1), deriv)
        t = torch.where(
            count == 0,
            1.0 / torch.clamp(torch.linalg.vector_norm(pg, dim=-1), min=1.0),
            torch.ones(L, dtype=dtype, device=dev),
        )
        x_new, f_new, g_new = x, f, g
        n_ls = torch.zeros(L, dtype=torch.int64, device=dev)
        ls_ok = torch.zeros(L, dtype=torch.bool, device=dev)
        while True:
            live = active & ~ls_ok & (n_ls < max_ls)
            if not bool(live.any()):
                break
            x_try = x + t[:, None] * d
            if use_owlqn:
                x_try = torch.where(torch.sign(x_try) == xi, x_try, torch.zeros_like(x_try))
            f_try, g_try = full_objective(x_try)
            ok_try = f_try <= f + 1e-4 * t * deriv
            lv = live[:, None]
            t = torch.where(live, t * 0.5, t)
            x_new = torch.where(lv, x_try, x_new)
            f_new = torch.where(live, f_try, f_new)
            g_new = torch.where(lv, g_try, g_new)
            n_ls = n_ls + live.to(torch.int64)
            ls_ok = torch.where(live, ok_try, ls_ok)
        # a lane whose line search is exhausted keeps its current iterate
        keep = ls_ok[:, None]
        x_new = torch.where(keep, x_new, x)
        f_new = torch.where(ls_ok, f_new, f)
        g_new = torch.where(keep, g_new, g)
        s = x_new - x
        y = g_new - g
        sy = (s * y).sum(dim=-1)
        # a stored pair enters at slot 0 and the oldest of a full history
        # drops out
        store = active & (sy > 1e-10)
        S = torch.where(store[:, None, None], torch.cat([s[:, None], S[:, :-1]], dim=1), S)
        Y = torch.where(store[:, None, None], torch.cat([y[:, None], Y[:, :-1]], dim=1), Y)
        r = 1.0 / torch.where(sy != 0, sy, torch.ones_like(sy))
        rho = torch.where(store[:, None], torch.cat([r[:, None], rho[:, :-1]], dim=1), rho)
        count = count + store.to(torch.int64)
        pg_new = _pseudo_gradient(x_new, g_new, l1w) if use_owlqn else g_new
        stop = (
            ~ls_ok
            | ((f - f_new).abs() <= tol * torch.clamp(f_new.abs(), min=1.0))
            | (pg_new.abs().amax(dim=-1) <= tol)
        )
        act = active[:, None]
        x = torch.where(act, x_new, x)
        f = torch.where(active, f_new, f)
        g = torch.where(act, g_new, g)
        it = it + active.to(torch.int64)
        converged = torch.where(active, stop, converged)
    return LbfgsResult(x=x, f=f, n_iter=it, converged=converged, n_evals=n_evals)
