# The batched sweep's solvers (spark_rapids_ml_tpu_torch.ops: glm.sweep_*,
# lbfgs.minimize_lbfgs_batched, logistic.sweep_logistic_fit_kernel,
# sweep.stage_fold_ids, lanes) against the JAX package's on the same numpy
# inputs, on the CPU, and against the port's own solo solvers.
#
# Tolerances: float32 statistics accumulate in other orders here (row
# chunks) and there (one product), so they agree to ~1e-5 relative; linear
# coefficients to 1e-4 absolute on O(1) coefficients; the CD sweep counts
# exactly (the JAX package's CD run on the port's statistics); a batched
# L-BFGS lane's iteration count equals the port's solo run's on the same
# fold and the JAX package's lane's, its iterate to 1e-4 (OWL-QN's to 1e-3:
# float32 rounding moves coordinates across the orthant projection's zero
# at another step); logistic coefficients
# against the JAX package's to 2e-3 absolute (the port's single logistic
# fits' tolerance).
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import glm as ref_glm
from spark_rapids_ml_tpu.ops import lanes as ref_lanes
from spark_rapids_ml_tpu.ops import lbfgs as ref_lbfgs
from spark_rapids_ml_tpu.ops import logistic as ref_logistic

from spark_rapids_ml_tpu_torch.ops import glm, lanes, lbfgs, logistic, sweep

CPU = torch.device("cpu")
# CD's stopping change: above the float32 rounding of these coefficients
# (~1e-6; at 1e-6 a last sweep's change is rounding, and the two packages'
# dot products in other orders then stop a sweep apart)
CD_TOL = 1e-4


def _data(n=400, d=7, k=3, seed=0, pad=5):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, size=d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 1.5 + 0.1 * rng.normal(size=n)).astype(np.float32)
    # padded rows: weight 0, fold -1
    X = np.concatenate([X, np.ones((pad, d), np.float32)])
    y = np.concatenate([y, np.ones(pad, np.float32)])
    w = np.concatenate([rng.uniform(0.5, 1.5, size=n), np.zeros(pad)]).astype(np.float32)
    fid = sweep.stage_fold_ids(n, n + pad, k, seed + 3, CPU)
    return X, y, w, fid


def _stats(k=3, seed=0):
    X, y, w, fid = _data(k=k, seed=seed)
    ours = glm.sweep_linreg_fold_stats(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w), fid, k, chunk=64)
    theirs = ref_glm.sweep_linreg_fold_stats(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.asarray(fid.numpy()), k=k
    )
    return ours, theirs, (X, y, w, fid)


def test_lanes_match_reference():
    for m in (1, 3, 4, 5, 9):
        assert lanes.lane_bucket(m) == ref_lanes.lane_bucket(m)
        np.testing.assert_array_equal(lanes.pad_lanes(list(range(1, m + 1)), lanes.lane_bucket(m)),
                                      ref_lanes.pad_lanes(list(range(1, m + 1)), ref_lanes.lane_bucket(m)))
    cand = [(0.1, 0.5), (0.2, 0.0), (0.3, 0.5)]
    bucket, (a, l1) = lanes.pack_lane_subset(cand, [0, 2], fields=(0, 1))
    assert bucket == 2 and a.dtype == torch.float64
    assert a.tolist() == [0.1, 0.3] and l1.tolist() == [0.5, 0.5]


def test_fold_ids_pad_rows_and_membership():
    fid = sweep.stage_fold_ids(10, 13, 3, 4, CPU)
    assert fid.dtype == torch.int32 and fid[10:].tolist() == [-1, -1, -1]
    assert sorted(set(fid[:10].tolist())) == [0, 1, 2]


def test_fold_stats_match_reference_and_the_train_rows():
    ours, theirs, (X, y, w, fid) = _stats()
    for name in glm.LinregStats._fields:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(theirs, name))
        assert a.shape[0] == 3
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-4 * max(1.0, float(np.abs(b).max())), err_msg=name)
    # fold f's statistics are those of its train rows alone
    f = 1
    keep = fid.numpy() != f
    solo = glm.linreg_sufficient_stats(torch.from_numpy(X[keep]), torch.from_numpy(y[keep]), torch.from_numpy(w[keep]))
    for name in glm.LinregStats._fields:
        a, b = getattr(glm.fold_stats(ours, f), name).numpy(), getattr(solo, name).numpy()
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-4 * max(1.0, float(np.abs(b).max())), err_msg=name)


@pytest.mark.parametrize("fit_intercept,normalize", [(True, False), (True, True), (False, False)])
def test_sweep_solve_linear_matches_reference(fit_intercept, normalize):
    ours, theirs, _ = _stats()
    alphas = [0.0, 0.01, 0.3]
    b, b0 = glm.sweep_solve_linear(ours, alphas, fit_intercept=fit_intercept, normalize=normalize)
    rb, rb0 = ref_glm.sweep_solve_linear(theirs, jnp.asarray(alphas), fit_intercept=fit_intercept, normalize=normalize)
    assert b.shape == (3, 3, 7) and b0.shape == (3, 3)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), atol=1e-4)
    np.testing.assert_allclose(b0.numpy(), np.asarray(rb0), atol=1e-4)
    # each lane is the sequential solve on its fold's statistics, bit for bit
    for f in range(3):
        for j, a in enumerate(alphas):
            sb, _ = glm.solve_linear(glm.fold_stats(ours, f), a, fit_intercept=fit_intercept, normalize=normalize)
            torch.testing.assert_close(b[f, j], sb, rtol=0, atol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_sweep_solve_elasticnet_cd_matches_reference(normalize):
    ours, theirs, _ = _stats(seed=4)
    alphas, l1s = [0.01, 0.1, 0.5, 0.01], [0.5, 0.5, 1.0, 0.9]
    b, b0, sweeps = glm.sweep_solve_elasticnet_cd(ours, alphas, l1s, CD_TOL, normalize=normalize, max_iter=200)
    # the JAX package's CD on the port's statistics: the same system, so
    # the sweep counts are the algorithm's, not the statistics' rounding
    on_ours = ref_glm.LinregStats(*(jnp.asarray(t.numpy()) for t in ours))
    rb, rb0, rsweeps = ref_glm.sweep_solve_elasticnet_cd(
        on_ours, jnp.asarray(alphas), jnp.asarray(l1s), jnp.asarray(CD_TOL), normalize=normalize, max_iter=200
    )
    np.testing.assert_array_equal(sweeps, np.asarray(rsweeps))
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), atol=1e-4)
    np.testing.assert_allclose(b0.numpy(), np.asarray(rb0), atol=1e-4)
    # lanes with other values give other coefficients, and each lane is
    # the sequential CD on its fold
    assert not torch.equal(b[0, 0], b[0, 1])
    for f in range(3):
        for j in range(4):
            sb, _, n_iter = glm.solve_elasticnet_cd(glm.fold_stats(ours, f), alphas[j], l1s[j], normalize=normalize,
                                                    max_iter=200, tol=CD_TOL)
            torch.testing.assert_close(b[f, j], sb, rtol=0, atol=0)
            assert sweeps[f, j] == n_iter


def _quadratics(L=4, P=6, seed=5):
    rng = np.random.default_rng(seed)
    As, bs = [], []
    for i in range(L):
        M = rng.normal(size=(P, P))
        As.append((M @ M.T / P + (0.5 + i) * np.eye(P)).astype(np.float32))
        bs.append(rng.normal(size=P).astype(np.float32))
    return torch.from_numpy(np.stack(As)), torch.from_numpy(np.stack(bs))


@pytest.mark.parametrize("use_owlqn", [False, True], ids=["lbfgs", "owlqn"])
def test_minimize_lbfgs_batched_lanes_equal_solo_runs(use_owlqn):
    A, b = _quadratics()
    L, P = b.shape
    l1 = torch.full((L, P), 0.05 if use_owlqn else 0.0)
    max_iters = [50, 50, 3, 50]  # lane 2 stops at its budget

    def vg(x):  # (L, P) -> ((L,), (L, P)): 0.5 x'Ax - b'x
        Ax = torch.einsum("lij,lj->li", A, x)
        return 0.5 * (x * Ax).sum(-1) - (b * x).sum(-1), Ax - b

    res = lbfgs.minimize_lbfgs_batched(vg, torch.zeros(L, P), l1, max_iter=50, tol=1e-6, use_owlqn=use_owlqn)
    for i in range(L):
        if max_iters[i] != 50:
            continue
        solo = lbfgs.minimize_lbfgs(lambda x: (0.5 * x @ A[i] @ x - b[i] @ x, A[i] @ x - b[i]), torch.zeros(P),
                                    l1[i], max_iter=50, tol=1e-6, use_owlqn=use_owlqn)
        assert int(res.n_iter[i]) == solo.n_iter
        assert bool(res.converged[i]) == solo.converged
        np.testing.assert_allclose(res.x[i].numpy(), solo.x.numpy(), atol=1e-3 if use_owlqn else 1e-4)
    # against the JAX package's batched minimiser
    A_j, b_j = jnp.asarray(A.numpy()), jnp.asarray(b.numpy())

    def ref_vg(x):
        Ax = jnp.einsum("lij,lj->li", A_j, x)
        return 0.5 * (x * Ax).sum(-1) - (b_j * x).sum(-1), Ax - b_j

    ref = ref_lbfgs.minimize_lbfgs_batched(ref_vg, jnp.zeros((L, P)), jnp.asarray(l1.numpy()), max_iter=50,
                                           tol=1e-6, use_owlqn=use_owlqn)
    np.testing.assert_array_equal(res.n_iter.numpy(), np.asarray(ref.n_iter))
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), atol=1e-3 if use_owlqn else 1e-4)


def test_minimize_lbfgs_batched_stopped_lane_freezes():
    A, b = _quadratics(L=2)

    def vg(x):
        Ax = torch.einsum("lij,lj->li", A, x)
        return 0.5 * (x * Ax).sum(-1) - (b * x).sum(-1), Ax - b

    full = lbfgs.minimize_lbfgs_batched(vg, torch.zeros(2, 6), torch.zeros(2, 6), max_iter=3, tol=0.0)
    assert full.n_iter.tolist() == [3, 3] and not bool(full.converged.any())
    solo = lbfgs.minimize_lbfgs(lambda x: (0.5 * x @ A[0] @ x - b[0] @ x, A[0] @ x - b[0]), torch.zeros(6),
                                torch.zeros(6), max_iter=3, tol=0.0)
    np.testing.assert_allclose(full.x[0].numpy(), solo.x.numpy(), atol=1e-6)


def _cls_data(n=300, d=6, kcls=1, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if kcls == 1:
        y = (X[:, 0] + X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    else:
        y = (X[:, :kcls] + 0.3 * rng.normal(size=(n, kcls))).argmax(axis=1).astype(np.float32)
    return X, y


@pytest.mark.parametrize(
    "kcls,use_owlqn,regs,l1s",
    [(1, False, [0.01, 0.1, 1.0], [0.0, 0.0, 0.0]), (1, True, [0.01, 0.1], [0.5, 1.0]), (3, False, [0.05, 0.5], [0.0, 0.0])],
    ids=["binary", "binary_owlqn", "multinomial"],
)
def test_sweep_logistic_fit_matches_reference_and_solo_fits(kcls, use_owlqn, regs, l1s):
    X, y = _cls_data(kcls=kcls)
    k, n = 3, len(X)
    fid = sweep.stage_fold_ids(n, n, k, 7, CPU)
    Xt, yt, w = torch.from_numpy(X), torch.from_numpy(y), torch.ones(n)
    W, b, n_iter, conv, n_evals = logistic.sweep_logistic_fit_kernel(
        Xt, yt, w, fid, torch.tensor(regs, dtype=torch.float64), torch.tensor(l1s, dtype=torch.float64), 1e-6,
        k_folds=k, kcls=kcls, fit_intercept=True, max_iter=100, use_owlqn=use_owlqn,
    )
    m = len(regs)
    assert W.shape == (k, m, kcls, 6) and b.shape == (k, m, kcls) and n_iter.shape == (k, m)
    assert n_evals >= int(n_iter.max())
    rW, rb, r_iter, _ = ref_logistic.sweep_logistic_fit_kernel(
        jnp.asarray(X), jnp.asarray(y), jnp.ones(n), jnp.asarray(fid.numpy()), jnp.asarray(regs), jnp.asarray(l1s),
        jnp.asarray(1e-6), k_folds=k, kcls=kcls, fit_intercept=True, max_iter=100, use_owlqn=use_owlqn,
    )
    np.testing.assert_allclose(W.numpy(), np.asarray(rW), atol=2e-3)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), atol=2e-3)
    for f in range(k):
        keep = fid.numpy() != f
        for j in range(m):
            sW, sb, s_iter, _, _ = logistic.logistic_fit_kernel(
                Xt[keep], yt[keep], w[keep], kcls, regs[j], l1s[j], True, 100, 1e-6, use_owlqn
            )
            assert int(n_iter[f, j]) == s_iter, (f, j)
            np.testing.assert_allclose(W[f, j].numpy(), sW.numpy(), atol=1e-4)
            np.testing.assert_allclose(b[f, j].numpy(), sb.numpy(), atol=1e-4)
