#
# Fused nearest-center search: (min_d2 (N,), argmin (N,)) of
#
#     d2 = ||x||^2 - 2 x.c + ||c||^2
#
# Counterpart of spark_rapids_ml_tpu/ops/pallas_tpu.py::min_dist_argmin and
# _min_dist_argmin_pallas.  It replaces the TPU kernel
# spark_rapids_ml_tpu/ops/pallas_tpu.py::_min_dist_kernel with the CUDA
# kernels of csrc/min_dist_argmin.cu, written by hand for Hopper (sm_90a).
#
# What bounds it on the card: 2*N*k*D operations against 4*(N + k)*D bytes of
# input, about k/2 operations per byte — at the KMeans widths (k = 1000,
# D = 3000) far above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20),
# so it is bound by fp32 FMAs on the CUDA cores.  The kernels keep the
# (N, k) distance matrix in registers (the unfused composition writes and
# re-reads it), block dot products in register micro-tiles, and mask the
# ragged edges of N, k and D inside the kernel instead of padding X (a
# padded copy of the 12 GB flagship input is what the card should not pay
# for).  float32 runs the pipelined main loop of csrc/fp32_dist_tile.cuh,
# with 16-byte copies where every row start of X and of the centers is
# 16-byte aligned and 4-byte copies otherwise (the C entry picks); float64
# runs the first, synchronous design.  No TF32: see device.py.
#
# Routing: a CPU tensor takes the plain PyTorch version; a CUDA tensor
# launches the kernel or raises — there is no fallback.  The JAX package's
# v5e-measured routing threshold (d_pad <= 256 and k >= 1024) does not carry
# over: on the card transform always launches the kernel.
#

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils import chunk_iter
from . import _build

_LIBRARY = "min_dist_argmin"
_ENTRY = {torch.float32: "srml_min_dist_argmin_f32", torch.float64: "srml_min_dist_argmin_f64"}
# the pipelined kernel counts features in 32-bit integers
_MAX_D = 2**31 - 9
# the plain version's (rows, k) distance block stays below this many bytes
_PLAIN_BLOCK_BYTES = 256 * 1024 * 1024


def squared_norms(X: torch.Tensor) -> torch.Tensor:
    """Row sums of X * X, in row blocks, so the squares never take a second
    copy of X (12 GB at the KMeans flagship shape)."""
    out = torch.empty(X.shape[0], dtype=X.dtype, device=X.device)
    rows = max(1, _PLAIN_BLOCK_BYTES // max(1, X.shape[1] * X.element_size()))
    for sl in chunk_iter(X.shape[0], rows):
        xb = X[sl]
        out[sl] = (xb * xb).sum(dim=1)
    return out


def _norms(
    X: torch.Tensor,
    centers: torch.Tensor,
    x_norm: Optional[torch.Tensor],
    c_norm: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    if x_norm is None:
        x_norm = squared_norms(X)
    if c_norm is None:
        c_norm = squared_norms(centers)
    return x_norm, c_norm


def min_dist_argmin(
    X: torch.Tensor,
    centers: torch.Tensor,
    x_norm: Optional[torch.Tensor] = None,
    c_norm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest center of every row of X: (min_d2 (N,) in X's dtype, argmin
    (N,) int32, the first index on ties).  Norms default to the squared row
    norms in X's dtype.  min_d2 is not clamped at 0."""
    x_norm, c_norm = _norms(X, centers, x_norm, c_norm)
    if X.device.type == "cpu":
        return min_dist_argmin_plain(X, centers, x_norm, c_norm)
    if X.device.type != "cuda":
        raise ValueError(f"min_dist_argmin runs on cpu or cuda tensors, not {X.device}")
    return _min_dist_argmin_cuda(X, centers, x_norm, c_norm)


# launches of the CUDA kernel by min_dist_argmin, for runs that must show the
# main path went through it
min_dist_argmin.launches = 0


def copy_bytes(X: torch.Tensor, centers: torch.Tensor) -> int:
    """16 where every row start of X and of centers is 16-byte aligned, else
    4: the copy width of the float32 kernel (its C entry applies the same
    rule)."""
    return 16 if (X.data_ptr() | centers.data_ptr() | X.shape[1] * X.element_size()) % 16 == 0 else 4


def _min_dist_argmin_cuda(
    X: torch.Tensor, centers: torch.Tensor, x_norm: torch.Tensor, c_norm: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    if X.dtype not in _ENTRY:
        raise TypeError(f"min_dist_argmin kernel takes float32 or float64, not {X.dtype}")
    for name, t in (("centers", centers), ("x_norm", x_norm), ("c_norm", c_norm)):
        if t.dtype != X.dtype:
            raise TypeError(f"{name} is {t.dtype}, X is {X.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X is on {X.device}")
    if X.dim() != 2 or centers.dim() != 2 or centers.shape[1] != X.shape[1]:
        raise ValueError(f"X {tuple(X.shape)} and centers {tuple(centers.shape)} must be (N, D) and (k, D)")
    (n, d), k = X.shape, centers.shape[0]
    if not 1 <= k < 2**31:
        raise ValueError(f"need 1 <= k < 2**31 centers, got {k}")
    if d > _MAX_D:
        raise ValueError(f"need D <= {_MAX_D} features, got {d}")
    if tuple(x_norm.shape) != (n,) or tuple(c_norm.shape) != (k,):
        raise ValueError(f"x_norm {tuple(x_norm.shape)} / c_norm {tuple(c_norm.shape)} must be ({n},) / ({k},)")
    for name, t in (("X", X), ("centers", centers), ("x_norm", x_norm), ("c_norm", c_norm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out_min = torch.empty(n, dtype=X.dtype, device=X.device)
    out_arg = torch.empty(n, dtype=torch.int32, device=X.device)
    if n == 0:
        return out_min, out_arg
    fn = getattr(_build.load(_LIBRARY), _ENTRY[X.dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(
        X.data_ptr(), centers.data_ptr(), x_norm.data_ptr(), c_norm.data_ptr(),
        out_min.data_ptr(), out_arg.data_ptr(), n, k, d, stream,
    )
    if err != 0:
        raise RuntimeError(f"min_dist_argmin kernel launch failed: CUDA error {err}")
    min_dist_argmin.launches += 1
    return out_min, out_arg


def min_dist_argmin_plain(
    X: torch.Tensor,
    centers: torch.Tensor,
    x_norm: Optional[torch.Tensor] = None,
    c_norm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: the expanded-form matmul and a
    first-index min, in row chunks whose (rows, k) block stays under
    _PLAIN_BLOCK_BYTES.  Runs on any device."""
    x_norm, c_norm = _norms(X, centers, x_norm, c_norm)
    n, k = X.shape[0], centers.shape[0]
    out_min = torch.empty(n, dtype=X.dtype, device=X.device)
    out_arg = torch.empty(n, dtype=torch.int32, device=X.device)
    rows = max(1, _PLAIN_BLOCK_BYTES // (k * X.element_size()))
    ct = centers.T
    for sl in chunk_iter(n, rows):
        d2 = x_norm[sl, None] - 2.0 * (X[sl] @ ct) + c_norm[None, :]
        m, a = torch.min(d2, dim=1)
        out_min[sl] = m
        out_arg[sl] = a.to(torch.int32)
    return out_min, out_arg
