#
# Sparse features: the ELL layout and its products.
#
# Counterpart of spark_rapids_ml_tpu/ops/sparse.py.  A CSR matrix becomes
# two dense (N, P) tensors, column ids and values, every row padded to the
# largest row count P (padding slots: id 0, value 0, exact no-ops in every
# product).  The GLMs fit on it without a dense (N, D) feature tensor:
#   - X @ B is a gather of B's rows by the id table and a sum over P;
#   - X^T R, the gradient's product, must not add floats in an order that
#     changes from run to run (index_add_ / scatter_add_ on CUDA add with
#     atomics).  ell_device_from_scipy therefore also builds the transpose
#     once, column-major and in the same padded layout (each column's rows
#     in ascending order), and ell_rmatmat reduces each column's slots with
#     a plain sum: two fits of one sparse frame give identical coefficients;
#   - the linear-regression statistics densify one row chunk at a time and
#     multiply it densely, so the card never holds more than one (chunk, D)
#     tile.
# On a mesh (ell_shards_from_scipy) the rows are sharded as dense rows are
# (parallel/mesh.shard_rows: padded to a multiple of the shard count, empty
# pad rows at the end), each shard its own EllMatrix with its own P and its
# own column-major transpose over its local rows; ell_sufficient_stats sums
# the shards' statistics with one psum_fields (parallel/exchange.py), and
# the logistic objective sums its shards' partials the same way
# (ops/logistic.py).
#

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.exchange import psum_fields
from ..parallel.mesh import as_shards, shard_row_count
from ..utils import chunk_iter
from .linalg import exact_matmul

# rows of one densified chunk of ell_sufficient_stats (the JAX package's)
ELL_CHUNK = 8192
# elements of the (columns, slots, K) gather ell_rmatmat makes at a time
RMATMAT_ELEMENTS = 1 << 26


class EllMatrix:
    """ELL sparse matrix on one device: ``idx`` (N, P) int32 column ids and
    ``val`` (N, P) values, padding slots id 0 and value 0; ``t_idx`` /
    ``t_val`` (n_cols, P_t) the same layout of the transpose (row ids per
    column, ascending), or None when only forward products are needed."""

    __slots__ = ("idx", "val", "n_cols", "t_idx", "t_val")

    def __init__(
        self,
        idx: torch.Tensor,
        val: torch.Tensor,
        n_cols: int,
        t_idx: Optional[torch.Tensor] = None,
        t_val: Optional[torch.Tensor] = None,
    ) -> None:
        self.idx = idx
        self.val = val
        self.n_cols = int(n_cols)
        self.t_idx = t_idx
        self.t_val = t_val

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.idx.shape[0], self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    def nbytes(self) -> int:
        parts = (self.idx, self.val, self.t_idx, self.t_val)
        return sum(t.numel() * t.element_size() for t in parts if t is not None)


def ell_from_csr(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, n_cols: int, dtype: Any = np.float32
) -> Tuple[np.ndarray, np.ndarray]:
    """Host CSR -> ELL, vectorised: (idx (N, P) int32, val (N, P) dtype)
    with P = the largest row count (at least 1)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.size - 1
    counts = np.diff(indptr)
    P = int(max(1, counts.max() if n else 1))
    idx = np.zeros((n, P), dtype=np.int32)
    val = np.zeros((n, P), dtype=dtype)
    # position of each stored entry within its row
    pos = np.arange(indptr[-1], dtype=np.int64) - np.repeat(indptr[:-1], counts)
    row = np.repeat(np.arange(n, dtype=np.int64), counts)
    idx[row, pos] = np.asarray(indices, dtype=np.int32)
    val[row, pos] = np.asarray(data, dtype=dtype)
    return idx, val


def ell_device_from_scipy(X: Any, dtype: Any = np.float32, device: Any = "cpu", transpose: bool = True) -> EllMatrix:
    """scipy sparse -> EllMatrix on `device`, with the column-major
    transpose ell_rmatmat reduces (transpose=False leaves it out: a
    transform needs only forward products)."""
    csr = X.tocsr()
    n_rows, n_cols = csr.shape
    idx, val = ell_from_csr(csr.indptr, csr.indices, csr.data, n_cols, dtype)
    t_idx = t_val = None
    if transpose:
        csc = csr.tocsc()
        csc.sort_indices()
        t_idx, t_val = ell_from_csr(csc.indptr, csc.indices, csc.data, n_rows, dtype)
        t_idx, t_val = torch.from_numpy(t_idx).to(device), torch.from_numpy(t_val).to(device)
    return EllMatrix(torch.from_numpy(idx).to(device), torch.from_numpy(val).to(device), n_cols, t_idx, t_val)


def ell_shards_from_scipy(X: Any, dtype: Any, mesh: Any, transpose: bool = True) -> List[EllMatrix]:
    """scipy sparse -> one EllMatrix a shard of `mesh`: shard i holds rows
    [i * per, (i + 1) * per) (mesh.shard_rows' geometry, the padding empty
    rows at the end), on mesh.devices[i], with its own transpose over its
    local rows."""
    import scipy.sparse as sp

    csr = X.tocsr()
    n, d = csr.shape
    per = shard_row_count(n, mesh.size)
    out = []
    for i, dev in enumerate(mesh.devices):
        block = csr[min(n, i * per) : min(n, (i + 1) * per)]
        if block.shape[0] < per:
            block = sp.vstack([block, sp.csr_matrix((per - block.shape[0], d), dtype=csr.dtype)]).tocsr()
        out.append(ell_device_from_scipy(block, dtype, dev, transpose=transpose))
    return out


def ell_matvec(ell: EllMatrix, b: torch.Tensor) -> torch.Tensor:
    """X @ b for b (D,) -> (N,): a gather and a sum over the slots."""
    return (ell.val * b[ell.idx]).sum(dim=1)


def ell_matmat(ell: EllMatrix, B: torch.Tensor) -> torch.Tensor:
    """X @ B for B (D, K) -> (N, K)."""
    return (ell.val[:, :, None] * B[ell.idx]).sum(dim=1)


def ell_rmatmat(ell: EllMatrix, R: torch.Tensor) -> torch.Tensor:
    """X^T @ R for R (N, K) -> (D, K), from the column-major transpose: each
    column's slots gathered and summed in slot order, with no atomics, so
    the result's bits do not change from run to run."""
    if ell.t_idx is None:
        raise ValueError("this EllMatrix was built without its transpose (transpose=False)")
    d, p_t = ell.t_idx.shape
    out = torch.empty((d, R.shape[1]), dtype=R.dtype, device=R.device)
    cols = max(1, RMATMAT_ELEMENTS // max(1, p_t * R.shape[1]))
    for sl in chunk_iter(d, cols):
        out[sl] = (ell.t_val[sl, :, None] * R[ell.t_idx[sl]]).sum(dim=1)
    return out


def ell_densify_chunk(idx: torch.Tensor, val: torch.Tensor, n_cols: int) -> torch.Tensor:
    """(C, P) ELL chunk -> dense (C, n_cols).  The add is exact in any
    order, atomics or not: a row's stored entries have distinct columns,
    and padding slots add 0.0 at column 0."""
    out = torch.zeros((idx.shape[0], n_cols), dtype=val.dtype, device=val.device)
    return out.scatter_add_(1, idx.long(), val)


def _ell_local_moments(
    ell: EllMatrix, w: torch.Tensor, y: torch.Tensor, chunk: int = ELL_CHUNK
) -> Tuple[torch.Tensor, ...]:
    """(wsum, xwsum, X'WX, ywsum, X'Wy, sum w y^2) from ELL rows, one
    densified `chunk`-row tile at a time: the sparse twin of
    linalg._local_moments."""
    d = ell.n_cols
    dt, dev = ell.val.dtype, ell.val.device
    wsum = torch.zeros((), dtype=dt, device=dev)
    xwsum = torch.zeros(d, dtype=dt, device=dev)
    G = torch.zeros((d, d), dtype=dt, device=dev)
    ywsum = torch.zeros((), dtype=dt, device=dev)
    c = torch.zeros(d, dtype=dt, device=dev)
    y2 = torch.zeros((), dtype=dt, device=dev)
    for sl in chunk_iter(ell.idx.shape[0], max(1, chunk)):
        Xc = ell_densify_chunk(ell.idx[sl], ell.val[sl], d)
        wc, yc = w[sl].to(dt), y[sl].to(dt)
        Xw = Xc * wc[:, None]
        wsum += wc.sum()
        xwsum += Xw.sum(dim=0)
        G += exact_matmul(Xw.T, Xc)
        ywsum += (yc * wc).sum()
        c += exact_matmul(Xw.T, yc)
        y2 += (yc * yc * wc).sum()
    return wsum, xwsum, G, ywsum, c, y2


def ell_sufficient_stats(ell, y, w, chunk: int = ELL_CHUNK):
    """Sparse twin of glm.linreg_sufficient_stats: each shard's statistics
    (an EllMatrix, or a list of one a shard), one psum."""
    from .glm import LinregStats

    shards = zip(as_shards(ell), as_shards(w), as_shards(y))
    parts = [_ell_local_moments(e, wl, yl, chunk) for e, wl, yl in shards]
    wsum, xwsum, G, ywsum, c, y2 = psum_fields(parts, "glm.stats")
    return LinregStats(wsum, xwsum / wsum, ywsum / wsum, G, c, y2)
