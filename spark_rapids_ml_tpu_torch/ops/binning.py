#
# Feature-major binning: (N, D) float32 X and (D, B-1) edges -> (D, n_pad)
# int8 bins, bin = the number of edges strictly below x, rows N..n_pad-1 = 0.
#
# Counterpart of spark_rapids_ml_tpu/ops/pallas_tpu.py::bin_features_fm_pallas.
# It replaces the TPU kernel spark_rapids_ml_tpu/ops/pallas_tpu.py::_bin_kernel
# with the CUDA kernel csrc/bin_features_fm.cu, written by hand for Hopper
# (sm_90a).
#
# What bounds it on the card: memory — X is read once and the int8 bins
# written once (12 GB + 3 GB at the 1,000,000 x 3000 RandomForest flagship).
# The kernel counts edges by binary search instead of the TPU kernel's
# compare loop over every edge, which would cost more issue time than the
# memory takes; the count is the same on edges that are non-decreasing with
# NaN edges only at the end, which bin_features_fm checks (and raises
# otherwise).  A NaN x gets bin 0 either way.  X is not padded: the kernel
# masks the ragged row and feature edges itself.
#
# Routing: a CPU tensor takes the plain PyTorch version; a CUDA tensor
# launches the kernel or raises — there is no fallback.
#

from __future__ import annotations

import ctypes

import torch

from ..utils import chunk_iter
from . import _build

_LIBRARY = "bin_features_fm"
MAX_EDGES = 127  # int8 bins: at most 128 bins
# the plain version's (rows, D, B-1) comparison block stays below this
_PLAIN_BLOCK_BYTES = 256 * 1024 * 1024


def bin_features_fm(X: torch.Tensor, edges: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(D, n_pad) int8 feature-major bins of the (N, D) float32 X against
    the (D, B-1) float32 edges (B-1 <= 127): each bin counts the edges
    strictly below x; a NaN x gets 0; columns N..n_pad-1 are 0."""
    if X.device.type == "cpu":
        return bin_features_fm_plain(X, edges, n_pad)
    if X.device.type != "cuda":
        raise ValueError(f"bin_features_fm runs on cpu or cuda tensors, not {X.device}")
    return _bin_features_fm_cuda(X, edges, n_pad)


# launches of the CUDA kernel by bin_features_fm, for runs that must show the
# main path went through it
bin_features_fm.launches = 0


def check_edges(edges: torch.Tensor) -> None:
    """Raise unless every row of edges is non-decreasing with NaN only at
    its end: the condition under which a binary search counts the edges
    below x as the compare loop does."""
    key = torch.nan_to_num(edges, nan=float("inf"), posinf=float("inf"), neginf=float("-inf"))
    if edges.shape[1] > 1 and not bool((key[:, 1:] >= key[:, :-1]).all()):
        raise ValueError("bin edges must be non-decreasing per feature, with NaN edges only at the end")


def _bin_features_fm_cuda(X: torch.Tensor, edges: torch.Tensor, n_pad: int) -> torch.Tensor:
    if X.dtype != torch.float32 or edges.dtype != torch.float32:
        raise TypeError(f"bin_features_fm kernel takes float32 X and edges, not {X.dtype} / {edges.dtype}")
    if edges.device != X.device:
        raise ValueError(f"edges are on {edges.device}, X is on {X.device}")
    if X.dim() != 2 or edges.dim() != 2 or edges.shape[0] != X.shape[1]:
        raise ValueError(f"X {tuple(X.shape)} and edges {tuple(edges.shape)} must be (N, D) and (D, B-1)")
    (n, d), n_edges = X.shape, edges.shape[1]
    if n_edges > MAX_EDGES:
        raise ValueError(f"int8 bins take at most {MAX_EDGES} edges, got {n_edges}")
    if n_pad < n:
        raise ValueError(f"n_pad {n_pad} < {n} rows")
    for name, t in (("X", X), ("edges", edges)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    check_edges(edges)
    out = torch.empty((d, n_pad), dtype=torch.int8, device=X.device)
    if d == 0 or n_pad == 0:
        return out
    fn = _build.load(_LIBRARY).srml_bin_features_fm
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(X.data_ptr(), edges.data_ptr(), out.data_ptr(), n, d, n_pad, n_edges, stream)
    if err != 0:
        raise RuntimeError(f"bin_features_fm kernel launch failed: CUDA error {err}")
    bin_features_fm.launches += 1
    return out


def bin_features_fm_plain(X: torch.Tensor, edges: torch.Tensor, n_pad: int) -> torch.Tensor:
    """The same function in plain PyTorch: the compare-accumulate over all
    edges of ops/forest.bin_features in the JAX package, in row chunks whose
    (rows, D, B-1) comparison block stays under _PLAIN_BLOCK_BYTES.  Runs on
    any device."""
    n, d = X.shape
    out = torch.zeros((d, n_pad), dtype=torch.int8, device=X.device)
    rows = max(1, _PLAIN_BLOCK_BYTES // max(1, d * max(1, edges.shape[1])))
    for sl in chunk_iter(n, rows):
        out[:, sl] = (X[sl].T[:, :, None] > edges[:, None, :]).sum(dim=-1, dtype=torch.int8)
    return out
