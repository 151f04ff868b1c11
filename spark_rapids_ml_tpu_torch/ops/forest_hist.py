#
# Random-forest node histograms: per (feature, slot, bin) sums of the
# bf16-rounded stats of the rows in each node, where a slot packs
# (tree, node, stat).
#
# Counterpart of spark_rapids_ml_tpu/ops/forest_hist.py.  It replaces the TPU
# kernels _hist_kernel (node_histograms) and _hist_kernel_bucketed
# (node_histograms_bucketed) with the CUDA kernel csrc/forest_hist.cu,
# written by hand for Hopper (sm_90a), two entry points over one kernel.
#
# What bounds it on the card: one shared-memory atomic add per (row,
# feature, tree) with a non-zero stat; the bytes it reads (int8 bins, int32
# node ids, fp32 stats) are small beside them.  The TPU kernels build the
# histogram as a one-hot matmul on the matrix unit; here a block keeps
# private (slots x B) fp32 histograms of a few features in shared memory
# and adds each bf16-rounded stat into its cell (the form cuML uses), then
# adds the block's cells into the output.  Integer stats give exact sums in
# any order, so the kernel equals the plain version bit for bit on them;
# float stats differ by the order of the fp32 additions only.
#
# gather_rows replaces gather_rows_matmul: on the card the feature subset is
# a plain index_select of the feature-major bin rows (exact), zero-padded to
# f_pad — the one-hot matmul was the TPU's way around its slow gather.
#
# Routing: a CPU tensor takes the plain PyTorch version; a CUDA tensor
# launches the kernel or raises — there is no fallback.
#

from __future__ import annotations

import ctypes

import torch

from . import _build

_LIBRARY = "forest_hist"
M_SLOTS = 128        # slots of node_histograms' output, as in the JAX package
MAX_BINS = 128
ROW_TILE = 2048      # rows are padded to a multiple of this (the JAX package's _ROW_TILE)
ROW_TILE_DEEP = 512  # deep-phase bucket capacities are multiples of this
F_BLOCK = 32         # subset rows are padded to a multiple of this


def slots_pad_of(nodes: int, s_dim: int) -> int:
    """The bucketed output's slot axis: max(8, nodes * s_dim rounded up to 8)."""
    return max(8, -(-(nodes * s_dim) // 8) * 8)


def gather_rows(bins_fm: torch.Tensor, feats: torch.Tensor, f_pad: int) -> torch.Tensor:
    """Rows `feats` of the (D, N) int8 bin matrix as (f_pad, N) int8, rows
    past len(feats) zero."""
    out = torch.zeros((f_pad, bins_fm.shape[1]), dtype=bins_fm.dtype, device=bins_fm.device)
    torch.index_select(bins_fm, 0, feats.to(bins_fm.device, torch.int64), out=out[: feats.shape[0]])
    return out


# ---------------------------------------------------------------------------
# node_histograms (kernel B3)
# ---------------------------------------------------------------------------


def node_histograms(
    bins_sub: torch.Tensor,  # (F_pad, N) int8 subset rows
    node_rel: torch.Tensor,  # (T_pack, N) int32 node-in-level ids; outside [0, nodes) masks a row
    stats_s: torch.Tensor,   # (T_pack * S, N) float32 weighted stat rows
    t_pack: int,
    nodes: int,
    s_dim: int,
    n_bins: int,
) -> torch.Tensor:
    """(F_pad, 128, B) float32 with slot = (t * nodes + c) * s_dim + s."""
    _check_common(bins_sub, node_rel, stats_s, t_pack * nodes * s_dim, n_bins)
    if node_rel.dim() != 2 or node_rel.shape[0] != t_pack or stats_s.shape[0] != t_pack * s_dim:
        raise ValueError(
            f"node_rel {tuple(node_rel.shape)} / stats_s {tuple(stats_s.shape)} must be "
            f"({t_pack}, N) / ({t_pack * s_dim}, N)"
        )
    if bins_sub.device.type == "cpu":
        return node_histograms_plain(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins)
    if bins_sub.device.type != "cuda":
        raise ValueError(f"node_histograms runs on cpu or cuda tensors, not {bins_sub.device}")
    f_pad, n = bins_sub.shape
    out = torch.zeros((f_pad, M_SLOTS, n_bins), dtype=torch.float32, device=bins_sub.device)
    fn = _build.load(_LIBRARY).srml_node_histograms
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(bins_sub.device).cuda_stream
    err = fn(
        bins_sub.data_ptr(), node_rel.data_ptr(), stats_s.data_ptr(), out.data_ptr(),
        n, f_pad, t_pack, nodes, s_dim, n_bins, M_SLOTS, stream,
    )
    if err != 0:
        raise RuntimeError(f"node_histograms kernel launch failed: CUDA error {err}")
    node_histograms.launches += 1
    return out


# launches of the CUDA kernel, for runs that must show the main path went
# through it
node_histograms.launches = 0


def node_histograms_plain(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins):
    """The same function in plain PyTorch: per (tree, stat) one index_add_
    of the bf16-rounded stats over the flat (feature, slot, bin) index.
    Runs on any device."""
    f_pad, n = bins_sub.shape
    out = torch.zeros(f_pad * M_SLOTS * n_bins, dtype=torch.float32, device=bins_sub.device)
    feat_base = (torch.arange(f_pad, device=bins_sub.device) * (M_SLOTS * n_bins))[:, None]
    bins = bins_sub.long()
    bin_ok = (bins >= 0) & (bins < n_bins)
    for t in range(t_pack):
        c = node_rel[t].long()
        row_ok = (c >= 0) & (c < nodes)
        for s in range(s_dim):
            v = _bf16(stats_s[t * s_dim + s])
            slot = (t * nodes + c.clamp(0, nodes - 1)) * s_dim + s
            idx = feat_base + slot[None, :] * n_bins + bins.clamp(0, n_bins - 1)
            vals = torch.where(bin_ok & row_ok[None, :], v[None, :], 0.0)
            out.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return out.reshape(f_pad, M_SLOTS, n_bins)


# ---------------------------------------------------------------------------
# node_histograms_bucketed (kernel B4)
# ---------------------------------------------------------------------------


def node_histograms_bucketed(
    bins_sub: torch.Tensor,  # (F_pad, n_buckets * cap) int8, bucket-sorted rows
    node_rel: torch.Tensor,  # (1, n_buckets * cap) int32 bucket-local node ids
    stats_s: torch.Tensor,   # (S, n_buckets * cap) float32
    n_buckets: int,
    nodes: int,              # local nodes per bucket at this level
    s_dim: int,
    n_bins: int,
) -> torch.Tensor:
    """(n_buckets, F_pad, slots_pad, B) float32: node_histograms of each
    contiguous bucket of cap rows, with slot = c * s_dim + s."""
    _check_common(bins_sub, node_rel, stats_s, nodes * s_dim, n_bins)
    n_tot = bins_sub.shape[1]
    if node_rel.dim() != 2 or node_rel.shape[0] != 1 or stats_s.shape[0] != s_dim:
        raise ValueError(
            f"node_rel {tuple(node_rel.shape)} / stats_s {tuple(stats_s.shape)} must be "
            f"(1, N) / ({s_dim}, N)"
        )
    if n_buckets < 1 or n_tot % n_buckets or (n_tot // n_buckets) % ROW_TILE_DEEP:
        raise ValueError(f"{n_tot} rows are not {n_buckets} buckets of a multiple of {ROW_TILE_DEEP}")
    if bins_sub.device.type == "cpu":
        return node_histograms_bucketed_plain(bins_sub, node_rel, stats_s, n_buckets, nodes, s_dim, n_bins)
    if bins_sub.device.type != "cuda":
        raise ValueError(f"node_histograms_bucketed runs on cpu or cuda tensors, not {bins_sub.device}")
    if n_buckets > 65535:
        raise ValueError(f"at most 65535 buckets per launch, got {n_buckets}")
    f_pad = bins_sub.shape[0]
    slots_pad = slots_pad_of(nodes, s_dim)
    out = torch.zeros((n_buckets, f_pad, slots_pad, n_bins), dtype=torch.float32, device=bins_sub.device)
    fn = _build.load(_LIBRARY).srml_node_histograms_bucketed
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(bins_sub.device).cuda_stream
    err = fn(
        bins_sub.data_ptr(), node_rel.data_ptr(), stats_s.data_ptr(), out.data_ptr(),
        n_buckets, n_tot // n_buckets, f_pad, nodes, s_dim, slots_pad, n_bins, stream,
    )
    if err != 0:
        raise RuntimeError(f"node_histograms_bucketed kernel launch failed: CUDA error {err}")
    node_histograms_bucketed.launches += 1
    return out


node_histograms_bucketed.launches = 0


def node_histograms_bucketed_plain(bins_sub, node_rel, stats_s, n_buckets, nodes, s_dim, n_bins):
    """The same function in plain PyTorch: per stat one index_add_ of the
    bf16-rounded stats over the flat (bucket, feature, slot, bin) index.
    Runs on any device."""
    f_pad, n_tot = bins_sub.shape
    cap = n_tot // n_buckets
    slots_pad = slots_pad_of(nodes, s_dim)
    dev = bins_sub.device
    out = torch.zeros(n_buckets * f_pad * slots_pad * n_bins, dtype=torch.float32, device=dev)
    bucket = torch.arange(n_tot, device=dev) // cap
    feat = torch.arange(f_pad, device=dev)[:, None]
    bins = bins_sub.long()
    ok = (bins >= 0) & (bins < n_bins)
    c = node_rel[0].long()
    ok &= ((c >= 0) & (c < nodes))[None, :]
    for s in range(s_dim):
        slot = c.clamp(0, nodes - 1) * s_dim + s
        idx = ((bucket[None, :] * f_pad + feat) * slots_pad + slot[None, :]) * n_bins + bins.clamp(0, n_bins - 1)
        vals = torch.where(ok, _bf16(stats_s[s])[None, :], 0.0)
        out.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return out.reshape(n_buckets, f_pad, slots_pad, n_bins)


def node_histograms_reference(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins):
    """Row-by-row loops over the same sum, for tests at tiny sizes (the JAX
    package's node_histograms_reference, with the stats rounded to bf16 as
    the kernels round them)."""
    f_pad, n = bins_sub.shape
    H = torch.zeros((f_pad, M_SLOTS, n_bins), dtype=torch.float32)
    st = _bf16(stats_s.cpu())
    for f in range(f_pad):
        for t in range(t_pack):
            for r in range(n):
                c = int(node_rel[t, r])
                b = int(bins_sub[f, r])
                if 0 <= c < nodes and 0 <= b < n_bins:
                    for s in range(s_dim):
                        H[f, (t * nodes + c) * s_dim + s, b] += st[t * s_dim + s, r]
    return H


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (nearest even) and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _check_common(bins_sub, node_rel, stats_s, slots, n_bins) -> None:
    if bins_sub.dtype != torch.int8 or node_rel.dtype != torch.int32 or stats_s.dtype != torch.float32:
        raise TypeError(
            f"bins/node/stats must be int8/int32/float32, not {bins_sub.dtype}/{node_rel.dtype}/{stats_s.dtype}"
        )
    if bins_sub.dim() != 2 or stats_s.dim() != 2 or node_rel.dim() != 2:
        raise ValueError("bins_sub, node_rel and stats_s must be 2-D")
    n = bins_sub.shape[1]
    if node_rel.shape[1] != n or stats_s.shape[1] != n:
        raise ValueError(f"bins_sub has {n} rows, node_rel {node_rel.shape[1]}, stats_s {stats_s.shape[1]}")
    if not 1 <= slots <= M_SLOTS:
        raise ValueError(f"need 1 <= trees * nodes * stats <= {M_SLOTS} slots, got {slots}")
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"need 1 <= n_bins <= {MAX_BINS}, got {n_bins}")
    for name, t in (("node_rel", node_rel), ("stats_s", stats_s)):
        if t.device != bins_sub.device:
            raise ValueError(f"{name} is on {t.device}, bins_sub is on {bins_sub.device}")
    for name, t in (("bins_sub", bins_sub), ("node_rel", node_rel), ("stats_s", stats_s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
