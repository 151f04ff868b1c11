#
# The exact-kNN kernels: candidate pool, fused merge, audit count.
#
# Counterpart of spark_rapids_ml_tpu/ops/pallas_knn.py.  Each wrapper takes
# its plain PyTorch version for CPU tensors and launches its hand-written
# CUDA kernel (sm_90a) for CUDA tensors, or raises; there is no fallback.
#
#   knn_candidates        B5, replaces _knn_topm_kernel_qres
#                         (knn_candidates_pallas / knn_fused_pallas):
#                         csrc/knn_topm.cu, on the pipelined main loop of
#                         csrc/fp32_dist_tile.cuh (128 queries x one
#                         1024-item group a block)
#   knn_candidates_audit  B6, replaces _knn_topm_kernel (legacy=True): the
#                         same kernel, launched by the audit route and
#                         counted apart
#   knn_fused_merge       B7, replaces _knn_fused_merge_kernel:
#                         csrc/knn_merge.cu, a radix select on a
#                         thread-block cluster a row, or the windowed
#                         kernel past its k or width (_merge_route)
#   knn_count             B8, replaces _knn_count_kernel: csrc/knn_topm.cu,
#                         on the same loop (one 128 x 128 tile a block)
#
# B5/B6 and B8 take 16-byte copies where items, queries and D * 4 are
# 16-byte aligned and 4-byte copies otherwise (the C entries pick;
# ops/nearest_center.copy_bytes states the rule).
#
# The pool layout is (Q, ng, m): for every query, the top m of each group of
# GROUP consecutive items by (-d2 descending, position ascending), ng =
# ceil(n / GROUP).  The TPU kernel's (ng, m_pad, q_pad) layout and its tile
# alignment are VMEM concerns that do not carry over.  Invalid items (valid
# False) get a +inf norm, so their -d2 is -inf and they never outrank a
# valid item.  Bounds, design and precision: see the two sources.
#

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils import chunk_iter
from . import _build
from .nearest_center import squared_norms

GROUP = 1024        # items per candidate group (the TPU kernel's tile_i)
MAX_M = 32          # candidates per group the pool kernel keeps at most
_INT32_LIMIT = 2**31 - 1
_MAX_D = 2**31 - 9  # the kernels count features in 32-bit integers
# the plain version's (rows, n) distance block stays below this many bytes
_PLAIN_BLOCK_BYTES = 256 * 1024 * 1024

_TOPM_LIBRARY = "knn_topm"
_MERGE_LIBRARY = "knn_merge"


def _check_search_inputs(items, item_norm, valid, queries) -> None:
    for name, t in (("items", items), ("item_norm", item_norm), ("queries", queries)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries are on {queries.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, not {valid.dtype}")
    if valid.device != queries.device:
        raise ValueError(f"valid is on {valid.device}, queries are on {queries.device}")
    if items.dim() != 2 or queries.dim() != 2 or queries.shape[1] != items.shape[1]:
        raise ValueError(f"items {tuple(items.shape)} and queries {tuple(queries.shape)} must be (n, D) and (Q, D)")
    n = items.shape[0]
    if not 1 <= n < 2**31:
        raise ValueError(f"need 1 <= n < 2**31 items, got {n}")
    if items.shape[1] > _MAX_D:
        raise ValueError(f"the kNN kernels take D <= {_MAX_D} features, got {items.shape[1]}")
    if tuple(item_norm.shape) != (n,) or tuple(valid.shape) != (n,):
        raise ValueError(f"item_norm {tuple(item_norm.shape)} / valid {tuple(valid.shape)} must be ({n},)")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kNN kernels run on cpu or cuda tensors, not {queries.device}")


def _masked_norms(item_norm: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, item_norm, torch.full_like(item_norm, float("inf"))).contiguous()


def sqrt_clamped(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) rounded to the nearest float32, as the kernels' sqrtf
    rounds it: taken in float64, since a vectorised float32 sqrt on the CPU
    need not round correctly."""
    return torch.sqrt(torch.clamp(x, min=0.0).double()).to(torch.float32)


def _neg_d2(items, inorm, queries, qnorm) -> torch.Tensor:
    """-((||q||^2 - 2 q.x) + ||x||^2): the kernels' rounding order."""
    return -((qnorm[:, None] - 2.0 * (queries @ items.T)) + inorm[None, :])


# ---------------------------------------------------------------------------
# B5 / B6: candidate pool
# ---------------------------------------------------------------------------


def knn_candidates(
    items: torch.Tensor, item_norm: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate pool of every query: (values (Q, ng, m) float32 = -d2,
    positions (Q, ng, m) int32 into items), the top m of each group of GROUP
    items by (-d2 descending, position ascending).  A slot that finds only
    -inf left holds -inf and the lowest such position of its group."""
    vals, pos, launched = _pool(items, item_norm, valid, queries, m)
    knn_candidates.launches += launched
    return vals, pos


def knn_candidates_audit(
    items: torch.Tensor, item_norm: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor, m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same pool for the audit route (the JAX package's legacy-grid
    kernel computes the same function): one kernel, its own launch count."""
    vals, pos, launched = _pool(items, item_norm, valid, queries, m)
    knn_candidates_audit.launches += launched
    return vals, pos


# launches of the CUDA kernel by each wrapper, for runs that must show the
# path went through it
knn_candidates.launches = 0
knn_candidates_audit.launches = 0


def _pool(items, item_norm, valid, queries, m):
    """(values, positions, whether the kernel was launched)."""
    _check_search_inputs(items, item_norm, valid, queries)
    if not 1 <= m <= MAX_M:
        raise ValueError(f"need 1 <= m <= {MAX_M} candidates per group, got {m}")
    inorm, qnorm = _masked_norms(item_norm, valid), squared_norms(queries)
    if queries.device.type == "cpu":
        return (*knn_candidates_plain(items, inorm, queries, qnorm, m), False)
    return (*_candidates_cuda(items, inorm, queries, qnorm, m), queries.shape[0] > 0)


def _candidates_cuda(items, inorm, queries, qnorm, m):
    (n, d), q = items.shape, queries.shape[0]
    ng = -(-n // GROUP)
    vals = torch.empty((q, ng, m), dtype=torch.float32, device=queries.device)
    pos = torch.empty((q, ng, m), dtype=torch.int32, device=queries.device)
    if q == 0:
        return vals, pos
    fn = _build.load(_TOPM_LIBRARY).srml_knn_topm_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        items.data_ptr(), inorm.data_ptr(), queries.data_ptr(), qnorm.data_ptr(),
        vals.data_ptr(), pos.data_ptr(), n, q, d, m,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn_candidates kernel launch failed: CUDA error {err}")
    return vals, pos


def knn_candidates_plain(
    items: torch.Tensor, inorm: torch.Tensor, queries: torch.Tensor, qnorm: torch.Tensor, m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pool in plain PyTorch, given the masked item norms and the query
    norms: -d2 in query chunks, then m first-occurrence argmax passes per
    group with the winner masked to -inf.  Runs on any device."""
    n, q = items.shape[0], queries.shape[0]
    ng = -(-n // GROUP)
    vals = torch.empty((q, ng, m), dtype=torch.float32, device=queries.device)
    pos = torch.empty((q, ng, m), dtype=torch.int32, device=queries.device)
    base = (torch.arange(ng, device=queries.device, dtype=torch.int64) * GROUP)[None, :]
    rows = max(1, _PLAIN_BLOCK_BYTES // (4 * ng * GROUP))
    for sl in chunk_iter(q, rows):
        neg = _neg_d2(items, inorm, queries[sl], qnorm[sl])
        v = torch.nn.functional.pad(neg, (0, ng * GROUP - n), value=float("-inf")).view(-1, ng, GROUP)
        for s in range(m):
            am = torch.argmax(v, dim=2, keepdim=True)  # the first maximal column
            vals[sl, :, s] = v.gather(2, am)[:, :, 0]
            pos[sl, :, s] = (am[:, :, 0] + base).to(torch.int32)
            v.scatter_(2, am, float("-inf"))
    return vals, pos


# ---------------------------------------------------------------------------
# B7: fused merge
# ---------------------------------------------------------------------------


def _check_pool(vals: torch.Tensor, pos: torch.Tensor, k: int) -> None:
    if vals.dim() != 3 or tuple(pos.shape) != tuple(vals.shape):
        raise ValueError(f"pool values {tuple(vals.shape)} and positions {tuple(pos.shape)} must be (Q, ng, m)")
    if vals.dtype != torch.float32 or pos.dtype != torch.int32:
        raise TypeError(f"pool must be float32 values and int32 positions, not {vals.dtype} / {pos.dtype}")
    if pos.device != vals.device or not vals.is_contiguous() or not pos.is_contiguous():
        raise ValueError("pool values and positions must be contiguous, on one device")
    if not 1 <= vals.shape[1] * vals.shape[2] <= _INT32_LIMIT or vals.shape[0] > _INT32_LIMIT:
        raise ValueError(f"pool {tuple(vals.shape)} must hold 1 to 2**31 - 1 candidates a row, in < 2**31 rows")
    if not 1 <= k <= _INT32_LIMIT:
        raise ValueError(f"need 1 <= k < 2**31, got {k}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the kNN kernels run on cpu or cuda tensors, not {vals.device}")


# B7's routes (csrc/knn_merge.cu): the radix kernel keeps at most
# RADIX_MAX_K ranks and stages at most SLICE_KEYS pool values a CTA (96 KB:
# two CTAs an SM), on clusters of up to MAX_CLUSTER CTAs a row; a row split
# across a cluster runs CLUSTER_THREADS threads a CTA, a row on one CTA 256
RADIX_MAX_K = 2048
SLICE_KEYS = 24_576
MAX_CLUSTER = 16
CLUSTER_THREADS = 512


def _merge_route(p: int, k: int) -> Tuple[int, int]:
    """(CTAs a row, threads a CTA) of the radix kernel for a pool p wide
    merged to k -- the fewest CTAs whose slices hold SLICE_KEYS values or
    fewer -- or (0, 256) for the windowed kernel: k past RADIX_MAX_K, or a
    row wider than MAX_CLUSTER slices.  A pure function of the shape."""
    if k > RADIX_MAX_K:
        return 0, 256
    cluster = 1
    while cluster < MAX_CLUSTER and -(-p // cluster) > SLICE_KEYS:
        cluster *= 2
    if -(-p // cluster) > SLICE_KEYS:
        return 0, 256
    return cluster, 256 if cluster == 1 else CLUSTER_THREADS


def knn_fused_merge(vals: torch.Tensor, pos: torch.Tensor, k: int):
    """Merge a (Q, ng, m) pool: (dist (Q, k) float32 = sqrt(max(d2, 0))
    ascending, positions (Q, k) int32, flags (Q,) int32 = 1 where some
    group's m-th kept value beats the margined threshold, thresholds (Q,)
    float32, counts (Q,) int32 of kept values above the threshold).  Ranks
    past the pool read as -inf with position 0.  Any pool width and any k
    below 2**31."""
    _check_pool(vals, pos, k)
    if vals.device.type == "cpu":
        return knn_fused_merge_plain(vals, pos, k)
    out = _merge_cuda(vals, pos, k, *_merge_route(vals.shape[1] * vals.shape[2], k))
    knn_fused_merge.launches += int(vals.shape[0] > 0)
    return out


def _merge_cuda(vals: torch.Tensor, pos: torch.Tensor, k: int, cluster: int, threads: int = 256):
    """One launch of B7 on `cluster` CTAs a row of `threads` threads (256 or
    512; cluster 0: the windowed kernel)."""
    q, ng, m = vals.shape
    p = ng * m
    dev = vals.device
    dist = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_pos = torch.empty((q, k), dtype=torch.int32, device=dev)
    flags = torch.empty(q, dtype=torch.int32, device=dev)
    thresh = torch.empty(q, dtype=torch.float32, device=dev)
    above = torch.empty(q, dtype=torch.int32, device=dev)
    if q == 0:
        return dist, out_pos, flags, thresh, above
    fn = _build.load(_MERGE_LIBRARY).srml_knn_fused_merge_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        vals.data_ptr(), pos.data_ptr(), dist.data_ptr(), out_pos.data_ptr(), flags.data_ptr(),
        thresh.data_ptr(), above.data_ptr(), q, p, k, m, cluster, threads,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn_fused_merge kernel launch failed: CUDA error {err}")
    return dist, out_pos, flags, thresh, above


knn_fused_merge.launches = 0


def knn_fused_merge_plain(vals: torch.Tensor, pos: torch.Tensor, k: int):
    """The merge in plain PyTorch: a stable descending sort of each row (ties
    keep pool order), the first k, the threshold and the flags.  Runs on any
    device."""
    q, ng, m = vals.shape
    v, p = vals.reshape(q, ng * m), pos.reshape(q, ng * m)
    sv, order = torch.sort(v, dim=1, descending=True, stable=True)
    kk = min(k, v.shape[1])
    top_v, top_p = sv[:, :kk], p.gather(1, order[:, :kk])
    if kk < k:
        top_v = torch.nn.functional.pad(top_v, (0, k - kk), value=float("-inf"))
        top_p = torch.nn.functional.pad(top_p, (0, k - kk), value=0)
    t = top_v[:, k - 1]
    tu = torch.where(torch.isfinite(t), t + (t.abs() * 1e-6 + 1e-30), t)
    flags = (vals[:, :, m - 1] > tu[:, None]).any(dim=1).to(torch.int32)
    above = (top_v > tu[:, None]).sum(dim=1).to(torch.int32)
    dist = sqrt_clamped(-top_v)
    return dist, top_p.contiguous(), flags, tu, above


# ---------------------------------------------------------------------------
# B8: audit count
# ---------------------------------------------------------------------------


def knn_count(
    items: torch.Tensor, item_norm: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor,
    thresh: torch.Tensor,
) -> torch.Tensor:
    """#{valid items x : -d2(q, x) > thresh[q]} per query, (Q,) int32, with
    -d2 bitwise equal to the candidate kernel's."""
    _check_search_inputs(items, item_norm, valid, queries)
    if thresh.dtype != torch.float32 or tuple(thresh.shape) != (queries.shape[0],):
        raise ValueError(f"thresh must be float32 of shape ({queries.shape[0]},)")
    if thresh.device != queries.device or not thresh.is_contiguous():
        raise ValueError("thresh must be contiguous, on the queries' device")
    inorm, qnorm = _masked_norms(item_norm, valid), squared_norms(queries)
    if queries.device.type == "cpu":
        return knn_count_plain(items, inorm, queries, qnorm, thresh)
    (n, d), q = items.shape, queries.shape[0]
    out = torch.zeros(q, dtype=torch.int32, device=queries.device)
    if q == 0:
        return out
    fn = _build.load(_TOPM_LIBRARY).srml_knn_count_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        items.data_ptr(), inorm.data_ptr(), queries.data_ptr(), qnorm.data_ptr(),
        thresh.data_ptr(), out.data_ptr(), n, q, d,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"knn_count kernel launch failed: CUDA error {err}")
    knn_count.launches += 1
    return out


knn_count.launches = 0


def knn_count_plain(
    items: torch.Tensor, inorm: torch.Tensor, queries: torch.Tensor, qnorm: torch.Tensor,
    thresh: torch.Tensor,
) -> torch.Tensor:
    """The count in plain PyTorch, given the masked item norms and the query
    norms, in query chunks.  Runs on any device."""
    q, n = queries.shape[0], items.shape[0]
    out = torch.empty(q, dtype=torch.int32, device=queries.device)
    rows = max(1, _PLAIN_BLOCK_BYTES // (4 * n))
    for sl in chunk_iter(q, rows):
        out[sl] = (_neg_d2(items, inorm, queries[sl], qnorm[sl]) > thresh[sl, None]).sum(dim=1).to(torch.int32)
    return out
