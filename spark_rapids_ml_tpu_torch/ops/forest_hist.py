#
# Random-forest node histograms: per (feature, slot, bin) sums of the
# bf16-rounded stats of the rows in each node, where a slot packs
# (tree, node, stat).
#
# Counterpart of spark_rapids_ml_tpu/ops/forest_hist.py.  It replaces the TPU
# kernels _hist_kernel (node_histograms) and _hist_kernel_bucketed
# (node_histograms_bucketed) with the CUDA kernels of csrc/forest_hist.cu,
# written by hand for Hopper (sm_90a).
#
# node_histograms (B3) has two routes, picked per launch by _hist_route from
# the launch's shape alone:
#   - node_histograms_mma: the TPU kernel's one-hot product, on the tensor
#     cores (mma.sync bf16, fp32 sums): the one-hot of the bins built in
#     registers, the masked stats in shared memory.  Its work is
#     slots_pad x bins_pad multiply-adds per row and feature (both rounded
#     up to 16), so it grows with the nodes of a level;
#   - node_histograms_atomic: private (slots x B) fp32 histograms of a few
#     features in shared memory, one atomic add per (row, feature, tree,
#     non-zero stat) (the form cuML uses); its work does not grow with the
#     nodes, so it wins at the deep end of the shallow phase.
# node_histograms_bucketed (B4, the deep phase) runs the atomic kernel per
# bucket.  _atomic_geometry cuts a launch of the atomic kernel into blocks;
# where each block owns its output slice (B4 wherever the buckets and
# features fill the card) it writes all of it, and where rows are split
# across blocks the kernel's C entry zeroes the output, so the wrappers
# allocate with torch.empty either way.  A caller that knows its stats are
# integers (integer_stats) has the atomic kernel add them with native
# integer shared atomics; an fp32 shared atomic is a compare-and-swap loop
# that retries for every lane of a warp that hits the same cell.  Integer
# stats give exact sums on every route, so each equals the plain version bit
# for bit on them; float stats differ by the order of the fp32 additions
# only.  The tensor-core route adds in a fixed order (no atomics) and gives
# the same bits on every call.
#
# node_histograms_sharded is the JAX package's sharding rule for B3: the
# rows split over the shards of a mesh (lists of per-shard tensors), B3 on
# each shard's rows, the partial histograms summed by one psum_parts (section
# forest.hist_parts).  On integer stats the sum is bit for bit
# node_histograms over all the rows.  The one-shard histogram builder
# (ops/forest_grow.py) does not take it: multi-shard fits grow on the
# scatter engine (ops/forest.grow_forest), as in the JAX package.
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

# The tensor-core route spends slots_pad * bins_pad multiply-adds per row
# and feature where the atomic route spends one add per (tree, stat): it is
# taken while that ratio is at most MMA_MAX_MACS_PER_ADD.  Measured on an
# H100 (chip_smoke.py, phase kernels_forest, both routes at every shallow
# level of the two RandomForest flagships; PERF.md section 6), since the
# atomic kernel reads its rows 4 at a time: at 2 stats and 128 bins the
# tensor cores win up to 4 nodes a tree (ratio 512; 123.0 against 125.6 ms
# at the regressor's level 2) and lose from 8 (ratio 1024: 8.9 against 4.3
# ms at the classifier's level 3, 123.2 against 63.0 at the regressor's).
# Integer stats (int32 cells, native atomics) move the crossover down: the
# tensor cores win at ratio 256 (9.0 against 13.1 ms at the classifier's
# level 1) and lose at 512 (9.0 against 6.5 ms, level 2); their time over
# the atomics' grows with the ratio (0.68, 1.38), so the two break even
# near 376.
MMA_MAX_MACS_PER_ADD = 512
MMA_MAX_MACS_PER_INT_ADD = 384
MMA_ROWS_TILE = 128              # rows per tile of the tensor-core kernel
MMA_TARGET_BLOCKS = 132 * 8      # ~8 waves of one 8-warp block on each of 132 SMs


def _hist_route(t_pack: int, nodes: int, s_dim: int, n_bins: int, integer_stats: bool = False) -> str:
    """"mma" or "atomic": the kernel node_histograms launches for this shape
    and stat kind."""
    slots_pad = -(-(t_pack * nodes * s_dim) // 16) * 16
    bins_pad = -(-n_bins // 16) * 16
    limit = MMA_MAX_MACS_PER_INT_ADD if integer_stats else MMA_MAX_MACS_PER_ADD
    return "mma" if slots_pad * bins_pad <= limit * t_pack * s_dim else "atomic"


# The atomic kernel: a block's (slots x B) fp32 histograms of its features
# take at most this many bytes of shared memory (two blocks an SM); a
# launch wants about ATOMIC_TARGET_BLOCKS blocks to fill the card, and
# splits the rows across blocks, in runs of at least ATOMIC_MIN_ROWS rows
# (a multiple of 4: the kernel reads aligned rows 4 at a time), only where
# one feature a block does not give that many.
ATOMIC_SMEM_BUDGET = 96 * 1024
ATOMIC_TARGET_BLOCKS = 132 * 8
ATOMIC_MIN_ROWS = 1024


def _atomic_geometry(f_pad: int, n_buckets: int, seg_len: int, slots: int, n_bins: int) -> tuple:
    """(fb, splits, rows_per_block) of the atomic kernel: block (f, s, z)
    takes features [f * fb, f * fb + fb) of bucket z's rows [s *
    rows_per_block, +rows_per_block) (clipped to the f_pad features and the
    seg_len rows of a bucket).  With one split every block owns its output
    slice and writes all of it; with more, the blocks of a slice add into
    it with global atomics, after the output is zeroed.  So a launch is cut
    by features first (each more feature group only reads the rows' node
    ids and stats once more), and by rows only where one feature a block
    leaves the card short of blocks."""
    f_groups_wanted = -(-ATOMIC_TARGET_BLOCKS // n_buckets)
    fb = max(1, min(f_pad, ATOMIC_SMEM_BUDGET // (4 * slots * n_bins), f_pad // f_groups_wanted))
    per_split = -(-f_pad // fb) * n_buckets
    splits = max(1, min(-(-ATOMIC_TARGET_BLOCKS // per_split), -(-seg_len // ATOMIC_MIN_ROWS)))
    rows = -(-seg_len // (4 * splits)) * 4
    return fb, -(-seg_len // rows), rows


def _mma_geometry(f_pad: int, n: int, n_bins: int) -> tuple:
    """(splits, tiles_per_split): the row split of the tensor-core kernel.
    A block holds 8 warps, one 16-bin m-tile each, over 8 // m_tiles
    features; rows are split across blocks until about MMA_TARGET_BLOCKS
    blocks fill the card, each split a run of whole 128-row tiles."""
    per_block = max(1, 8 // -(-n_bins // 16))
    f_groups = -(-f_pad // per_block)
    tiles = -(-n // MMA_ROWS_TILE)
    splits = max(1, min(tiles, -(-MMA_TARGET_BLOCKS // f_groups)))
    per_split = -(-tiles // splits)
    return -(-tiles // per_split), per_split


def node_histograms(
    bins_sub: torch.Tensor,  # (F_pad, N) int8 subset rows
    node_rel: torch.Tensor,  # (T_pack, N) int32 node-in-level ids; outside [0, nodes) masks a row
    stats_s: torch.Tensor,   # (T_pack * S, N) float32 weighted stat rows
    t_pack: int,
    nodes: int,
    s_dim: int,
    n_bins: int,
    integer_stats: bool = False,
) -> torch.Tensor:
    """(F_pad, 128, B) float32 with slot = (t * nodes + c) * s_dim + s.
    CUDA tensors take the route _hist_route picks for the shape and the
    stat kind.
    integer_stats: the caller knows every stat is an integer (it never
    checks the data for it); the atomic kernel then sums in int32 cells,
    bit for bit the fp32 sums while a cell stays below 2**24."""
    _check_shallow(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins)
    if bins_sub.device.type == "cpu":
        return node_histograms_plain(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins)
    if _hist_route(t_pack, nodes, s_dim, n_bins, integer_stats) == "mma":
        return node_histograms_mma(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins)
    return node_histograms_atomic(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins, integer_stats)


def node_histograms_mma(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins):
    """node_histograms on the tensor-core kernel, whatever the shape (CPU
    tensors: its plain version, node_histograms_onehot_plain)."""
    _check_shallow(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins)
    if bins_sub.device.type == "cpu":
        return node_histograms_onehot_plain(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins)
    f_pad, n = bins_sub.shape
    ns = -(-(t_pack * nodes * s_dim) // 16) * 16
    splits, per_split = _mma_geometry(f_pad, n, n_bins)
    dev = bins_sub.device
    out = torch.zeros((f_pad, M_SLOTS, n_bins), dtype=torch.float32, device=dev)
    bmat = torch.empty((-(-n // MMA_ROWS_TILE), ns, MMA_ROWS_TILE), dtype=torch.bfloat16, device=dev)
    part = torch.empty((splits, f_pad, ns, n_bins) if splits > 1 else (0,), dtype=torch.float32, device=dev)
    fn = _build.load(_LIBRARY).srml_node_histograms_mma
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    aligned16 = int(n % 16 == 0 and bins_sub.data_ptr() % 16 == 0)
    err = fn(
        bins_sub.data_ptr(), node_rel.data_ptr(), stats_s.data_ptr(), out.data_ptr(), part.data_ptr(),
        bmat.data_ptr(), n, f_pad, t_pack, nodes, s_dim, n_bins, M_SLOTS, splits, per_split, aligned16,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"node_histograms_mma kernel launch failed: CUDA error {err}")
    node_histograms_mma.launches += 1
    return out


def node_histograms_atomic(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins, integer_stats=False):
    """node_histograms on the shared-memory atomic kernel, whatever the
    shape (CPU tensors: node_histograms_plain)."""
    _check_shallow(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins)
    if bins_sub.device.type == "cpu":
        return node_histograms_plain(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins)
    f_pad, n = bins_sub.shape
    out = torch.empty((f_pad, M_SLOTS, n_bins), dtype=torch.float32, device=bins_sub.device)
    fn = _build.load(_LIBRARY).srml_node_histograms
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(bins_sub.device).cuda_stream
    err = fn(
        bins_sub.data_ptr(), node_rel.data_ptr(), stats_s.data_ptr(), out.data_ptr(),
        n, f_pad, t_pack, nodes, s_dim, n_bins, M_SLOTS,
        *_atomic_geometry(f_pad, 1, n, t_pack * nodes * s_dim, n_bins), int(integer_stats), stream,
    )
    if err != 0:
        raise RuntimeError(f"node_histograms_atomic kernel launch failed: CUDA error {err}")
    node_histograms_atomic.launches += 1
    return out


def node_histograms_sharded(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins, integer_stats=False):
    """node_histograms over row-sharded operands (per-shard lists, shard i's
    rows of each on its device): B3 on each shard, the partial (F_pad, 128,
    B) histograms summed in shard order by one psum_parts, replicated (a
    list, one histogram a shard)."""
    from ..parallel.exchange import psum_parts

    parts = [
        node_histograms(b, nr, st, t_pack, nodes, s_dim, n_bins, integer_stats)
        for b, nr, st in zip(bins_sub, node_rel, stats_s)
    ]
    return psum_parts(parts, section="forest.hist_parts")


# launches of each route's CUDA kernel, for runs that must show the main
# path went through it
node_histograms_mma.launches = 0
node_histograms_atomic.launches = 0


def node_histograms_onehot_plain(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins):
    """The tensor-core route's arithmetic in plain PyTorch: per feature, the
    bf16 one-hot of the bins (bins x rows) times the masked bf16 stat tile
    (rows x slots), [node[t, r] == c] * bf16(stat[t * S + s, r]), summed in
    fp32.  Runs on any device."""
    f_pad, n = bins_sub.shape
    dev = bins_sub.device
    slots = t_pack * nodes * s_dim
    slot = torch.arange(slots, device=dev)
    t, c, s = slot // (nodes * s_dim), (slot // s_dim) % nodes, slot % s_dim
    masked = torch.where(node_rel[t] == c[:, None], stats_s[t * s_dim + s], 0.0)
    masked = masked.to(torch.bfloat16).float().T  # (rows, slots)
    bin_ids = torch.arange(n_bins, device=dev, dtype=torch.int8)[:, None]
    out = torch.zeros((f_pad, M_SLOTS, n_bins), dtype=torch.float32, device=dev)
    for f in range(f_pad):
        onehot = (bins_sub[f][None, :] == bin_ids).to(torch.bfloat16).float()  # (bins, rows)
        out[f, :slots] = (onehot @ masked).T
    return out


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
    integer_stats: bool = False,
) -> torch.Tensor:
    """(n_buckets, F_pad, slots_pad, B) float32: node_histograms of each
    contiguous bucket of cap rows, with slot = c * s_dim + s.
    integer_stats: as node_histograms'."""
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
    f_pad, cap = bins_sub.shape[0], n_tot // n_buckets
    slots_pad = slots_pad_of(nodes, s_dim)
    out = torch.empty((n_buckets, f_pad, slots_pad, n_bins), dtype=torch.float32, device=bins_sub.device)
    fn = _build.load(_LIBRARY).srml_node_histograms_bucketed
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(bins_sub.device).cuda_stream
    err = fn(
        bins_sub.data_ptr(), node_rel.data_ptr(), stats_s.data_ptr(), out.data_ptr(),
        n_buckets, cap, f_pad, nodes, s_dim, slots_pad, n_bins,
        *_atomic_geometry(f_pad, n_buckets, cap, nodes * s_dim, n_bins), int(integer_stats), stream,
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


def _check_shallow(bins_sub, node_rel, stats_s, t_pack, nodes, s_dim, n_bins) -> None:
    _check_common(bins_sub, node_rel, stats_s, t_pack * nodes * s_dim, n_bins)
    if node_rel.dim() != 2 or node_rel.shape[0] != t_pack or stats_s.shape[0] != t_pack * s_dim:
        raise ValueError(
            f"node_rel {tuple(node_rel.shape)} / stats_s {tuple(stats_s.shape)} must be "
            f"({t_pack}, N) / ({t_pack * s_dim}, N)"
        )
    if bins_sub.device.type not in ("cpu", "cuda"):
        raise ValueError(f"node_histograms runs on cpu or cuda tensors, not {bins_sub.device}")


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
