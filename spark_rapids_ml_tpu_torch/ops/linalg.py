#
# Dense linear-algebra building blocks of PCA and the GLMs.
#
# Counterpart of spark_rapids_ml_tpu/ops/linalg.py.  What changes on the way:
#   - the mesh form: _sharded_moments runs _local_moments on each shard of
#     a row-sharded X (a list of per-shard tensors; one tensor is the
#     one-shard case) and sums the shards' moments with one psum_fields
#     (parallel/exchange.py), in shard order, on shard 0's device, where the
#     eigendecomposition runs; pca_fit and weighted_moments take it.  The
#     JAX package's shard_map + psum;
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
# Streaming (srml-stream, stream/engines.py): stream_moments_chunk_kernel is
# _local_moments over one staged chunk (pad rows carry weight 0), and
# pca_finalize_moments derives the model from the accumulated moments with
# the batch fit's own _pca_from_moments on the device the entry points
# resolve.  The JAX package's host-eigh branch (HOST_EIGH_MIN_D, its native
# eigh on CPU backends) has no counterpart: the port's one route is the
# float64 eigh above, cuSOLVER on the card.
# Multiplexed serving (serving/multiplex.py): exact_gather_matmul contracts
# each row against its own lane's (K, D) slab of a lane-stacked buffer.  The
# JAX function gathers the (N, K, D) slabs and contracts them in one
# einsum; here the rows are grouped by lane (ops/lanes.by_lane) and each
# lane's rows go through exact_matmul against that lane's slab, so a row's
# result is the dedicated product of its lane, not a batched product's
# with another summation order.  Contract: bit for bit the JAX lane kernel
# and the dedicated kernel on integer-exact rows; on other rows the
# dedicated kernel's product of the lane's rows.  Lane ids may lie on any
# device (the serving entry passes the host's).
#

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..parallel.exchange import psum_fields
from ..parallel.mesh import as_shards
from ..utils import chunk_iter

# rows of one moment-accumulation chunk (the JAX package's mesh chunk)
MOMENT_CHUNK = 32768


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for every product that is returned or solved against: full
    float32 products on the card, since device.resolve() turns TF32 off and
    nothing in the port turns it back on."""
    return torch.matmul(a, b)


def exact_gather_matmul(X: torch.Tensor, stacked: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """out[r] = X[r] @ stacked[lanes[r]].T: (N, D) rows against the
    (L, K, D) lane-stacked buffer, by lane ids (N,) -> (N, K), in full
    float32 (module header)."""
    from .lanes import by_lane

    return by_lane(X, lanes, lambda rows, lane: exact_matmul(rows, stacked[lane].T))


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


def _sharded_moments(X, w, chunk: int = MOMENT_CHUNK, y=None, section: str = "linalg.moments") -> Tuple[torch.Tensor, ...]:
    """_local_moments of each shard of the row-sharded (X, w[, y]), summed
    over the shards by one psum_fields: the same tuple as _local_moments,
    on shard 0's device."""
    Xs, ws = as_shards(X), as_shards(w)
    ys = as_shards(y) if y is not None else [None] * len(Xs)
    return psum_fields([_local_moments(x, wl, chunk, y=yl) for x, wl, yl in zip(Xs, ws, ys)], section)


def weighted_moments(X, w, chunk: int = MOMENT_CHUNK) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(wsum, mean, scatter) of the row-sharded (X, w), where scatter =
    sum_i w_i x_i x_i^T; w is 0 on padded rows."""
    wsum, xwsum, scatter = _sharded_moments(X, w, chunk)
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
    X, w, k: int, chunk: int = MOMENT_CHUNK
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCA of the rows of the row-sharded X weighted by w (0 on padded
    rows): chunked moments a shard and one psum, then _pca_from_moments on
    shard 0's device.  Returns float64 tensors (mean, components,
    explained_variance, ratio, singular_values)."""
    wsum, mean, scatter = weighted_moments(X, w, chunk)
    return _pca_from_moments(wsum, mean, scatter, k)


def pca_transform_kernel(X: torch.Tensor, components: torch.Tensor) -> torch.Tensor:
    """Spark's projection X @ PC^T, without mean removal (Spark does not
    centre at transform time)."""
    return exact_matmul(X, components.T)


def lane_pca_transform_kernel(X: torch.Tensor, lanes: torch.Tensor, components: torch.Tensor) -> torch.Tensor:
    """Multiplexed pca_transform_kernel: row r projects against lane
    lanes[r] of the lane-stacked (L, K, D) components."""
    return exact_gather_matmul(X, components, lanes)


def stream_moments_chunk_kernel(
    X: torch.Tensor, w: torch.Tensor, chunk: int = MOMENT_CHUNK
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streamed chunk's weighted moments (wsum, xwsum, scatter): the
    streaming PCA update.  Pad rows carry weight 0."""
    return _local_moments(X, w, chunk)


def pca_finalize_moments(
    wsum: np.ndarray, xwsum: np.ndarray, scatter: np.ndarray, k: int, device: torch.device
) -> Tuple[np.ndarray, ...]:
    """The streaming PCA finalize: accumulated (wsum, xwsum, scatter), host
    arrays in the fit's compute dtype, through pca_from_moments_kernel on
    `device`.  Returns float64 numpy arrays in pca_fit's order."""
    out = pca_from_moments_kernel(
        *(torch.from_numpy(np.array(a)).to(device) for a in (wsum, xwsum, scatter)), k
    )
    return tuple(t.cpu().numpy() for t in out)
