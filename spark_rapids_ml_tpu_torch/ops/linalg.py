#
# Dense linear-algebra building blocks of PCA and the GLMs.
#
# Counterpart of spark_rapids_ml_tpu/ops/linalg.py on one device.  What
# changes on the way:
#   - every product that is returned or solved against runs in full float32
#     (TF32 off: device.resolve() sets it, and nothing here turns it back
#     on), the port's form of the JAX package's Precision.HIGHEST;
#   - the weighted moments always accumulate over row chunks of
#     MOMENT_CHUNK rows.  On the card the chunking bounds memory: X * w of a
#     1,000,000 x 3000 float32 block would be a second 12 GB tensor.  The
#     order of accumulation therefore differs from the JAX package's
#     one-shot form, so the two agree within a tolerance, not bit for bit;
#   - the eigendecomposition takes one route: the covariance in the compute
#     dtype, then a float64 torch.linalg.eigh on the tensor's own device
#     (cuSOLVER on the card), in descending order with the JAX package's
#     host sign rule (the first largest-|.| entry of each component is
#     positive).  The JAX package's f32 device eigh below D = 128 on the
#     CPU and its subspace iteration on the TPU do not come over:
#     pca_fit_subspace_kernel exists only because of the TPU eigh's compile
#     time.
# Not carried over yet: the mesh forms (_sharded_moments, shard_map; ROADMAP
# A14b), stream_moments_chunk_kernel (A12), lane_pca_transform_kernel and
# exact_gather_matmul (A13).
#

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import chunk_iter

# rows of one moment-accumulation chunk (the JAX package's mesh chunk)
MOMENT_CHUNK = 32768


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for every product that is returned or solved against: full
    float32 products on the card, since device.resolve() turns TF32 off and
    nothing in the port turns it back on."""
    return torch.matmul(a, b)


def sign_flip(components: torch.Tensor) -> torch.Tensor:
    """Deterministic eigenvector signs: each row flipped so that its first
    largest-|.| element is positive."""
    idx = torch.argmax(components.abs(), dim=1)
    picked = torch.take_along_dim(components, idx[:, None], dim=1)
    return components * torch.sign(picked)


def _local_moments(
    X: torch.Tensor, w: torch.Tensor, chunk: int = MOMENT_CHUNK, y: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, ...]:
    """Weighted moments of (X, w) accumulated over `chunk`-row blocks:
    (wsum, xwsum, scatter = sum_i w_i x_i x_i^T), plus (ywsum, X^T W y,
    sum w y^2) when `y` is given (the linear-regression sufficient
    statistics).  Only one (chunk, D) weighted block exists at a time."""
    n, d = X.shape
    wsum = torch.zeros((), dtype=X.dtype, device=X.device)
    xwsum = torch.zeros(d, dtype=X.dtype, device=X.device)
    scatter = torch.zeros((d, d), dtype=X.dtype, device=X.device)
    if y is not None:
        ywsum = torch.zeros((), dtype=X.dtype, device=X.device)
        c = torch.zeros(d, dtype=X.dtype, device=X.device)
        y2 = torch.zeros((), dtype=X.dtype, device=X.device)
    for sl in chunk_iter(n, max(1, chunk)):
        xb, wb = X[sl], w[sl].to(X.dtype)
        xw = xb * wb[:, None]
        wsum += wb.sum()
        xwsum += xw.sum(dim=0)
        scatter.addmm_(xw.T, xb)
        if y is not None:
            yb = y[sl].to(X.dtype)
            ywsum += (yb * wb).sum()
            c.addmv_(xw.T, yb)
            y2 += (yb * yb * wb).sum()
    if y is None:
        return wsum, xwsum, scatter
    return wsum, xwsum, scatter, ywsum, c, y2


def weighted_moments(
    X: torch.Tensor, w: torch.Tensor, chunk: int = MOMENT_CHUNK
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(wsum, mean, scatter) where scatter = sum_i w_i x_i x_i^T; w is 0 on
    padded rows."""
    wsum, xwsum, scatter = _local_moments(X, w, chunk)
    return wsum, xwsum / wsum, scatter


def covariance(wsum: torch.Tensor, mean: torch.Tensor, scatter: torch.Tensor) -> torch.Tensor:
    """Symmetrised sample covariance (scatter - n mean mean^T) / (n - 1) in
    the moments' dtype."""
    cov = (scatter - wsum * torch.outer(mean, mean)) / (wsum - 1.0)
    return (cov + cov.T) * 0.5


def eigh_descending(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues descending, components as rows) of the symmetric A, in
    float64 on A's device, each row's sign fixed by sign_flip."""
    evals, evecs = torch.linalg.eigh(A.to(torch.float64))  # ascending
    return evals.flip(0), sign_flip(evecs.flip(1).T.contiguous())


def _pca_from_moments(
    wsum: torch.Tensor, mean: torch.Tensor, scatter: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Covariance in the compute dtype, float64 eigh, top-k in descending
    order: (mean, components (k, D), explained variance, its ratio,
    singular values sqrt(lambda (n - 1))), all float64 on the moments'
    device."""
    evals, comps = eigh_descending(covariance(wsum, mean, scatter))
    n = wsum.to(torch.float64)
    top = evals[:k]
    total = torch.clamp(evals.sum(), min=torch.finfo(torch.float64).tiny)
    return (
        mean.to(torch.float64),
        comps[:k],
        top,
        top / total,
        torch.sqrt(torch.clamp(top, min=0.0) * (n - 1.0)),
    )


def pca_from_moments_kernel(
    wsum: torch.Tensor, xwsum: torch.Tensor, scatter: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCA from accumulated raw moments (wsum, xwsum, scatter): the mean as
    xwsum / wsum, then _pca_from_moments.  Same return tuple as pca_fit."""
    return _pca_from_moments(wsum, xwsum / wsum, scatter, k)


def pca_fit(
    X: torch.Tensor, w: torch.Tensor, k: int, chunk: int = MOMENT_CHUNK
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCA of the rows of X weighted by w (0 on padded rows): chunked
    moments, then _pca_from_moments, all on X's device.  Returns float64
    tensors (mean, components, explained_variance, ratio, singular_values)."""
    wsum, mean, scatter = weighted_moments(X, w, chunk)
    return _pca_from_moments(wsum, mean, scatter, k)


def pca_transform_kernel(X: torch.Tensor, components: torch.Tensor) -> torch.Tensor:
    """Spark's projection X @ PC^T, without mean removal (Spark does not
    centre at transform time)."""
    return exact_matmul(X, components.T)
