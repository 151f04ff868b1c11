#
# Random-forest growth: lock-step level-wise growth of every tree on the
# node-histogram kernels (ops/forest_hist.py).
#
# Counterpart of spark_rapids_ml_tpu/ops/forest_mxu.py (grow_forest_mxu; its
# "MXU" names the TPU's matrix unit, which this card does not have).  The same
# two phases, and the same trees:
#
#   - Shallow phase, levels 0..L_s with 2^L_s * S <= 128: trees grow in lock
#     step, packed 128 // (nodes * S) to a histogram launch (kernel B3).  One
#     feature subset is drawn per (level, tree group) and shared by the group.
#   - Deep phase, levels L_s+1..max_depth (at most L_s more): the rows of each
#     tree are grouped once by their level-(L_s+1) ancestor (a bucket), and
#     every level runs one bucketed histogram launch (kernel B4) per chunk of
#     buckets, each bucket paying only for its own <= 128 (local node, stat)
#     slots.  One feature subset is drawn per tree for the whole phase.
#   - Split search, routing and the tree arrays follow forest_mxu line by
#     line (_split_from_hist, _route, the leaf totals), in plain PyTorch.
#
# The random draws come from one numpy Generator in the JAX package's order:
# one subset per (level, tree group) in loop order, then one subset per tree
# for the deep phase.
#
# What differs from forest_mxu, by design:
#   - no precompile / persistent-cache machinery: PyTorch runs eagerly;
#   - a tree group that does not fill its pack runs as a smaller pack instead
#     of a clamped window (the trees of a pack never interact);
#   - the deep phase groups rows with one stable sort of (tree, bucket) keys
#     instead of the split 2-operand payload sorts, and lays out only the rows
#     with weight > 0: a row of weight 0 adds nothing to any histogram or
#     total, so leaving it out changes no tree.  Each (tree, bucket) that
#     holds any row, weighted or not, is still a segment whose nodes are
#     written, as in the JAX package.  A segment is padded to a power-of-two
#     multiple of 512 rows (its size class); pad rows carry weight 0 and a
#     node id outside every level's range.
#
# Numerics: the split search sums the few stat rows (classes) one after the
# other, in order; integer stats (bootstrap counts x classes) make every
# histogram exact, so classification trees do not depend on the order of the
# kernels' atomic adds.
#

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .forest_hist import (
    F_BLOCK,
    M_SLOTS,
    ROW_TILE,
    ROW_TILE_DEEP,
    gather_rows,
    node_histograms,
    node_histograms_bucketed,
    slots_pad_of,
)

# node id of the deep phase's pad rows: outside every level's local node
# range (local <= 64) and far from int32 overflow as levels double it
_STRAY = 1 << 18
# a deep chunk's bucketed histogram stays below this many bytes at its
# deepest split level (the split search makes a few temporaries of its size)
_DEEP_HIST_BYTES = 256 * 1024 * 1024
_EPS = 1e-12


def shallow_levels(s_dim: int) -> int:
    """Deepest level the shallow phase hosts: 2^l * s_dim <= 128."""
    l = 0
    while (2 ** (l + 1)) * s_dim <= M_SLOTS:
        l += 1
    return l


def shallow_t_pack(trees: int, nodes: int, s_dim: int) -> int:
    """Trees packed into one 128-slot node_histograms launch at a level of
    `nodes` nodes."""
    return max(1, min(trees, M_SLOTS // (nodes * s_dim)))


def shallow_launches(trees: int, s_dim: int, max_depth: int) -> List[Tuple[int, int, int]]:
    """(level, nodes, t_pack) of every node_histograms launch of a fit's
    shallow phase, in order: split levels 0 .. min(max_depth - 1, L_s)."""
    out = []
    for level in range(min(max_depth - 1, shallow_levels(s_dim)) + 1):
        tpack = shallow_t_pack(trees, 2**level, s_dim)
        out += [(level, 2**level, min(tpack, trees - g0)) for g0 in range(0, trees, tpack)]
    return out


def depth_supported(max_depth: int, s_dim: int) -> bool:
    """The shallow phase hosts levels up to L_s; the deep phase another
    L_s + 1."""
    return max_depth <= 2 * shallow_levels(s_dim) + 1


def _sum_small(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over a short axis (the stat rows), one term after the other."""
    acc = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def split_from_hist(
    H: torch.Tensor,                    # (F_pad, slots, B) slot-packed histogram
    node_tot: Optional[torch.Tensor],   # (tpack, nodes, 3) (w, wy, wy2); None for classification
    feat_valid: torch.Tensor,           # (F_pad,) bool
    tpack: int,
    nodes: int,
    s_dim: int,
    kind: str,
    min_samples_leaf: float,
    min_impurity_decrease: float,
) -> Tuple[torch.Tensor, ...]:
    """Best split per (group, node): (best_f_local, best_bin, split_ok,
    node_w, node_imp, node_val) with leading (tpack, nodes) axes; node_val is
    (tpack, nodes, V).  forest_mxu._split_from_hist."""
    F_pad, _, B = H.shape
    used = tpack * nodes * s_dim
    hist = H[:, :used, :].reshape(F_pad, tpack, nodes, s_dim, B).permute(1, 3, 2, 0, 4)
    left = hist.cumsum(dim=-1)  # (tpack, S, nodes, F, B)
    right = left[..., -1:] - left
    if kind == "regression":
        p_w = node_tot[:, :, 0]
        l_w, l_wy = left[:, 0], left[:, 1]
        r_w, r_wy = right[:, 0], right[:, 1]
        p_wy, p_wy2 = node_tot[:, :, 1], node_tot[:, :, 2]
        gain = (
            l_wy * l_wy / l_w.clamp_min(_EPS)
            + r_wy * r_wy / r_w.clamp_min(_EPS)
            - (p_wy * p_wy / p_w.clamp_min(_EPS))[:, :, None, None]
        )
        p_imp = (p_wy2 / p_w.clamp_min(_EPS) - (p_wy / p_w.clamp_min(_EPS)) ** 2).clamp_min(0.0)
        p_val = (p_wy / p_w.clamp_min(_EPS))[:, :, None]
    else:
        l_w = _sum_small(left, 1)
        r_w = _sum_small(right, 1)
        pl_ = left / l_w.clamp_min(_EPS)[:, None]
        pr_ = right / r_w.clamp_min(_EPS)[:, None]
        if kind == "entropy":
            l_imp = -_sum_small(pl_ * torch.log2(pl_.clamp_min(_EPS)), 1)
            r_imp = -_sum_small(pr_ * torch.log2(pr_.clamp_min(_EPS)), 1)
        else:  # gini
            l_imp = 1.0 - _sum_small(pl_ * pl_, 1)
            r_imp = 1.0 - _sum_small(pr_ * pr_, 1)
        # the node's class totals: any feature's bins sum to them (feature 0)
        node_cls = hist[:, :, :, 0, :].sum(dim=-1).movedim(1, 2)  # (tpack, nodes, S)
        p_w = _sum_small(node_cls, 2)
        pp = node_cls / p_w.clamp_min(_EPS)[:, :, None]
        if kind == "entropy":
            p_imp = -_sum_small(pp * torch.log2(pp.clamp_min(_EPS)), 2)
        else:
            p_imp = 1.0 - _sum_small(pp * pp, 2)
        p_val = pp
        gain = p_imp[:, :, None, None] * p_w[:, :, None, None] - (l_imp * l_w + r_imp * r_w)

    neg_inf = torch.tensor(float("-inf"), dtype=gain.dtype, device=gain.device)
    ok_lr = (l_w >= min_samples_leaf) & (r_w >= min_samples_leaf)
    gain = torch.where(ok_lr, gain, neg_inf)
    gain[..., -1] = float("-inf")  # last bin: empty right side
    gain = torch.where(feat_valid[None, None, :, None], gain, neg_inf)
    flat = gain.reshape(tpack, nodes, -1)
    best = flat.argmax(dim=-1)  # the first index on ties, as jnp.argmax
    best_gain = flat.gather(-1, best[..., None])[..., 0]
    bf = (best // B).to(torch.int32)
    bb = (best % B).to(torch.int32)
    noise_floor = 1e-6 * p_imp * p_w + 1e-30
    split_ok = (
        torch.isfinite(best_gain)
        & (p_imp > 0)
        & (best_gain > torch.maximum(min_impurity_decrease * p_w, noise_floor))
        & (p_w >= 2 * min_samples_leaf)
    )
    return bf, bb, split_ok, p_w, p_imp, p_val


def _route(sub, rel, bf, bb, ok, seg_of_row=None):
    """Move each row of a node that splits to 2c (bin <= split bin) or
    2c + 1; every other row gets 2 * nodes, outside the next level's range.
    sub (F_pad, N) int8; rel (G, N) node ids; bf/bb/ok (G', nodes).  The
    shallow phase passes one routing row per tree (G = G'); the deep phase
    one row of all buckets (G = 1) and seg_of_row, each column's bucket."""
    nodes = bf.shape[1]
    c = rel.long()
    cc = c.clamp(0, nodes - 1)
    if seg_of_row is None:
        key = cc
        bf_, bb_, ok_ = bf, bb, ok
    else:
        key = seg_of_row[None, :] * nodes + cc
        bf_, bb_, ok_ = bf.reshape(1, -1), bb.reshape(1, -1), ok.reshape(1, -1)
    act = (c >= 0) & (c < nodes) & ok_.gather(1, key)
    bins = sub.gather(0, bf_.long().gather(1, key))
    go = bins.to(torch.int32) > bb_.gather(1, key)
    return torch.where(act, 2 * rel + go.to(torch.int32), 2 * nodes).to(torch.int32)


def _node_totals(idx: torch.Tensor, vals: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_out, V) sums of the rows of vals (R, V) at idx (R,); rows with
    idx outside [0, n_out) are dropped."""
    ok = (idx >= 0) & (idx < n_out)
    out = torch.zeros((n_out + 1, vals.shape[1]), dtype=torch.float32, device=vals.device)
    out.index_add_(0, torch.where(ok, idx, n_out), vals)
    return out[:n_out]


def _leaf_values(tot: np.ndarray, kind: str):
    """(n_samples, impurity, leaf_value) of leaves from their totals:
    regression (w, wy, wy2), classification per-class weights."""
    if kind == "regression":
        w_n = np.maximum(tot[..., 0], 1e-12)
        val = (tot[..., 1] / w_n)[..., None]
        imp = np.maximum(tot[..., 2] / w_n - (tot[..., 1] / w_n) ** 2, 0.0)
        return tot[..., 0], imp, val
    w_n = np.maximum(tot.sum(-1), 1e-12)
    val = tot / w_n[..., None]
    if kind == "entropy":
        imp = -(val * np.log2(np.maximum(val, 1e-12))).sum(-1)
    else:
        imp = 1.0 - (val * val).sum(-1)
    return tot.sum(-1), imp, val


def grow_forest(
    bins_fm: torch.Tensor,      # (D, N_pad) int8 feature-major bins
    base_stats: torch.Tensor,   # (S, N_pad) f32 unweighted stat rows (see below)
    w_trees: torch.Tensor,      # (T, N_pad) f32 per-tree bootstrap * mask weights
    stats3: Optional[torch.Tensor],  # (3, N_pad) f32 (1, y, y^2) * mask (regression) or None
    edges: np.ndarray,          # (D, B-1) raw-space bin edges
    max_depth: int,
    n_bins: int,
    kind: str,                  # "gini" | "entropy" | "regression"
    max_features: int,
    min_samples_leaf: float,
    min_impurity_decrease: float,
    seed: int,
    y_vals: Optional[torch.Tensor] = None,  # (N_pad,) class index / target; needed past L_s
    integer_stats: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Grow T trees: (features (T, M) int32, thresholds (T, M) f32,
    leaf_values (T, M, V) f32, n_samples (T, M) f32, impurities (T, M) f32)
    with M = 2^(max_depth+1) - 1.  base_stats rows: regression (1, y) * mask,
    classification the one-hot class rows.  integer_stats: the caller knows
    every histogram stat (w_trees x base_stats) is an integer, as it is for
    a classifier whose rows all weigh 1; it goes to the histogram kernels
    (forest_hist.node_histograms)."""
    T, n_pad = w_trees.shape
    S = base_stats.shape[0]
    V = 1 if kind == "regression" else S
    if n_pad % ROW_TILE:
        raise ValueError(f"pad rows to a multiple of {ROW_TILE}")
    if not depth_supported(max_depth, S):
        raise ValueError(f"depth {max_depth} exceeds the slot budget for {S} stat rows")
    l_s = shallow_levels(S)
    if max_depth > l_s and y_vals is None:
        raise ValueError("deep growth needs y_vals")

    M = 2 ** (max_depth + 1) - 1
    outputs = (
        np.full((T, M), -1, np.int32),
        np.zeros((T, M), np.float32),
        np.zeros((T, M, V), np.float32),
        np.zeros((T, M), np.float32),
        np.zeros((T, M), np.float32),
    )
    rng = np.random.default_rng(seed)
    F = int(max_features)
    msl, mid = float(min_samples_leaf), float(min_impurity_decrease)
    rel = torch.zeros((T, n_pad), dtype=torch.int32, device=bins_fm.device)
    stat_rows = stats3 if kind == "regression" else base_stats
    _shallow_phase(
        rel, bins_fm, w_trees, stat_rows, edges, outputs, rng, last_level=min(max_depth, l_s),
        max_depth=max_depth, n_bins=n_bins, kind=kind, s_dim=S, max_features=F,
        min_samples_leaf=msl, min_impurity_decrease=mid, integer_stats=integer_stats,
    )
    if max_depth > l_s:
        _deep_phase(
            rel, bins_fm, w_trees, y_vals, edges, outputs, rng,
            bucket_level=l_s + 1, max_depth=max_depth, n_bins=n_bins, kind=kind,
            s_dim=S, max_features=F, min_samples_leaf=msl, min_impurity_decrease=mid,
            integer_stats=integer_stats,
        )
    return outputs


@record_function("forest.shallow")
def _shallow_phase(
    rel, bins_fm, w_trees, stat_rows, edges, outputs, rng, *, last_level, max_depth, n_bins,
    kind, s_dim, max_features, min_samples_leaf, min_impurity_decrease, integer_stats,
) -> None:
    """Levels 0..last_level, trees packed into 128-slot launches
    (forest_mxu._shallow_step / _shallow_leaf); updates rel in place."""
    _, _, leaf_value, n_samples, impurity = outputs
    T, n_pad = w_trees.shape
    D = bins_fm.shape[0]
    S, F = s_dim, max_features
    f_pad = -(-max(F, 1) // F_BLOCK) * F_BLOCK
    dev = bins_fm.device
    feat_valid = torch.arange(f_pad, device=dev) < F
    for level in range(last_level + 1):
        nodes = 2**level
        tpack = shallow_t_pack(T, nodes, S)
        sl = slice(2**level - 1, 2**level - 1 + nodes)
        for g0 in range(0, T, tpack):
            g1 = min(g0 + tpack, T)
            tp = g1 - g0
            rel_g, w_g = rel[g0:g1], w_trees[g0:g1]
            if level == max_depth or kind == "regression":
                # per-tree node totals of the stat rows, weighted
                idx = torch.arange(tp, device=dev)[:, None] * nodes + rel_g.long()
                idx = torch.where(rel_g < nodes, idx, tp * nodes)
                vals = (stat_rows[None, :, :] * w_g[:, None, :]).permute(0, 2, 1)
                tot = _node_totals(idx.reshape(-1), vals.reshape(-1, vals.shape[2]), tp * nodes)
                tot = tot.reshape(tp, nodes, -1)
            if level == max_depth:
                cnt, imp, val = _leaf_values(tot.cpu().numpy(), kind)
                n_samples[g0:g1, sl], impurity[g0:g1, sl], leaf_value[g0:g1, sl] = cnt, imp, val
                continue
            feats = rng.choice(D, F, replace=False).astype(np.int32)
            sub = gather_rows(bins_fm, torch.from_numpy(feats), f_pad)
            base = stat_rows[:2] if kind == "regression" else stat_rows
            stats_s = (base[None, :, :] * w_g[:, None, :]).reshape(tp * S, n_pad).contiguous()
            H = node_histograms(sub, rel_g, stats_s, t_pack=tp, nodes=nodes, s_dim=S, n_bins=n_bins,
                                integer_stats=integer_stats)
            out = split_from_hist(
                H, tot if kind == "regression" else None, feat_valid, tp, nodes, S, kind,
                min_samples_leaf, min_impurity_decrease,
            )
            rel[g0:g1] = _route(sub, rel_g, out[0], out[1], out[2])
            _write_splits(outputs, (np.arange(g0, g1)[:, None], np.arange(sl.start, sl.stop)[None, :]),
                          [a.cpu().numpy() for a in out], feats[None, :], edges, F)


def _write_splits(outputs, where, got, feats, edges, F) -> None:
    """Store one launch's split outputs at outputs[...][where]; feats holds
    each row's feature subset (broadcast against where's first axis)."""
    feature, threshold, leaf_value, n_samples, impurity = outputs
    bf, bb, ok, p_w, p_imp, p_val = got
    gf = np.take_along_axis(feats, np.minimum(bf, F - 1), axis=1)
    n_samples[where] = p_w
    impurity[where] = p_imp
    leaf_value[where] = p_val
    feature[where] = np.where(ok, gf, -1)
    threshold[where] = np.where(ok, edges[gf, np.minimum(bb, edges.shape[1] - 1)], 0.0)


class _Chunk:
    """A run of deep segments of one size class, laid out bucket by bucket:
    sub (F_pad, nseg * cap) int8, rel (nseg * cap,) int32 bucket-local node
    ids, w and y (nseg * cap,) f32; trees/buckets (nseg,) say whose each
    segment is."""

    def __init__(self, cap, trees, buckets, sub, rel, w, y):
        self.cap, self.trees, self.buckets = cap, trees, buckets
        self.sub, self.rel, self.w, self.y = sub, rel, w, y
        self.seg_of_row = torch.arange(len(trees), device=rel.device).repeat_interleave(cap)


@record_function("forest.deep_layout")
def _deep_layout(rel, bins_fm, w_trees, y_vals, feats_all, n_buckets, f_pad, chunk_seg_bytes) -> List[_Chunk]:
    """Group every tree's weighted rows by bucket (its level-(L_s+1)
    ancestor) into size-class chunks."""
    T, n_pad = rel.shape
    dev = rel.device
    F = feats_all.shape[1]
    keys = rel.clamp(max=n_buckets).long() + (torch.arange(T, device=dev) * (n_buckets + 1))[:, None]
    seg_rows = torch.bincount(keys.reshape(-1), minlength=T * (n_buckets + 1))
    seg_rows = seg_rows.reshape(T, n_buckets + 1)[:, :n_buckets].reshape(-1).cpu().numpy()
    live = (rel < n_buckets) & (w_trees > 0)
    t_idx, r_idx = live.nonzero(as_tuple=True)
    g = t_idx * n_buckets + rel[t_idx, r_idx].long()  # segment id = tree * n_buckets + bucket
    order = torch.sort(g, stable=True).indices
    g, t_idx, r_idx = g[order], t_idx[order], r_idx[order]
    seg_live = torch.bincount(g, minlength=T * n_buckets).cpu().numpy()
    seg_start = np.concatenate([[0], np.cumsum(seg_live)[:-1]])
    pos = torch.arange(g.shape[0], device=dev) - torch.from_numpy(seg_start).to(dev)[g]

    # segments (every (tree, bucket) holding a row) and their size classes
    present = np.flatnonzero(seg_rows > 0)
    caps = np.full(present.shape, ROW_TILE_DEEP, np.int64)
    while True:
        grow = caps < seg_live[present]
        if not grow.any():
            break
        caps[grow] *= 2
    seg_cap = np.zeros(T * n_buckets, np.int64)
    seg_cap[present] = caps
    ordinal = np.zeros(T * n_buckets, np.int64)  # a segment's place within its class
    for cap in np.unique(caps):
        ordinal[present[caps == cap]] = np.arange(int((caps == cap).sum()))
    cap_of = torch.from_numpy(seg_cap).to(dev)[g]
    ord_of = torch.from_numpy(ordinal).to(dev)[g]
    chunks: List[_Chunk] = []
    feats_dev = torch.from_numpy(feats_all.astype(np.int64)).to(dev)
    for cap in np.unique(caps):
        segs = present[caps == cap]
        in_class = cap_of == int(cap)
        tk, rk, pk, ordk = t_idx[in_class], r_idx[in_class], pos[in_class], ord_of[in_class]
        per_chunk = int(max(1, min(65535, chunk_seg_bytes(int(cap)))))
        for c0 in range(0, len(segs), per_chunk):
            c1 = min(c0 + per_chunk, len(segs))
            ncols = (c1 - c0) * int(cap)
            sel = (ordk >= c0) & (ordk < c1)
            col = (ordk[sel] - c0) * int(cap) + pk[sel]
            t_col = torch.zeros(ncols, dtype=torch.int64, device=dev)
            r_col = torch.zeros(ncols, dtype=torch.int64, device=dev)
            valid = torch.zeros(ncols, dtype=torch.bool, device=dev)
            t_col[col], r_col[col], valid[col] = tk[sel], rk[sel], True
            sub = torch.zeros((f_pad, ncols), dtype=torch.int8, device=dev)
            idx = feats_dev[t_col].T * n_pad + r_col[None, :]  # (F, ncols) into the flat bins
            sub[:F] = torch.where(valid[None, :], bins_fm.reshape(-1)[idx], 0)
            del idx
            w = torch.where(valid, w_trees[t_col, r_col], 0.0)
            y = torch.where(valid, y_vals[r_col], 0.0)
            rel_c = torch.where(valid, 0, _STRAY).to(torch.int32)
            gs = segs[c0:c1]
            chunks.append(_Chunk(int(cap), gs // n_buckets, gs % n_buckets, sub, rel_c, w, y))
    return chunks


@record_function("forest.deep")
def _deep_phase(
    rel, bins_fm, w_trees, y_vals, edges, outputs, rng, *, bucket_level, max_depth,
    n_bins, kind, s_dim, max_features, min_samples_leaf, min_impurity_decrease, integer_stats,
) -> None:
    """Levels bucket_level..max_depth, bucket by bucket (forest_mxu._deep_phase)."""
    _, _, leaf_value, n_samples, impurity = outputs
    T = rel.shape[0]
    D = bins_fm.shape[0]
    n_buckets = 2**bucket_level
    F = int(max_features)
    f_pad = -(-max(F, 4) // F_BLOCK) * F_BLOCK
    dev = rel.device
    # one subset per tree, shared by its deep levels (after the shallow draws)
    feats_all = np.stack([rng.choice(D, F, replace=False).astype(np.int32) for _ in range(T)])
    deepest_local = 2 ** max(0, max_depth - 1 - bucket_level)
    seg_hist_bytes = f_pad * slots_pad_of(deepest_local, s_dim) * n_bins * 4
    chunks = _deep_layout(
        rel, bins_fm, w_trees, y_vals, feats_all, n_buckets, f_pad,
        lambda cap: _DEEP_HIST_BYTES // max(seg_hist_bytes, cap * 64),
    )
    feat_valid = torch.arange(f_pad, device=dev) < F
    for level in range(bucket_level, max_depth + 1):
        local = 2 ** (level - bucket_level)
        base = 2**level - 1
        for ch in chunks:
            nseg = len(ch.trees)
            where = (ch.trees[:, None], base + ch.buckets[:, None] * local + np.arange(local)[None, :])
            node_idx = torch.where(ch.rel < local, ch.seg_of_row * local + ch.rel.long(), -1)
            if level == max_depth or kind == "regression":
                if kind == "regression":
                    vals = torch.stack([ch.w, ch.w * ch.y, ch.w * ch.y * ch.y], dim=1)
                else:
                    vals = torch.stack([ch.w * (ch.y == c).float() for c in range(s_dim)], dim=1)
                tot = _node_totals(node_idx, vals, nseg * local).reshape(nseg, local, -1)
            if level == max_depth:
                cnt, imp, val = _leaf_values(tot.cpu().numpy(), kind)
                n_samples[where], impurity[where], leaf_value[where] = cnt, imp, val
                continue
            if kind == "regression":
                stats = torch.stack([ch.w, ch.w * ch.y])
            else:
                stats = torch.stack([ch.w * (ch.y == c).float() for c in range(s_dim)])
            H = node_histograms_bucketed(
                ch.sub, ch.rel[None, :], stats, n_buckets=nseg, nodes=local, s_dim=s_dim, n_bins=n_bins,
                integer_stats=integer_stats,
            )
            Hf = H[:, :, : local * s_dim, :].permute(1, 0, 2, 3).reshape(f_pad, nseg * local * s_dim, n_bins)
            del H
            out = split_from_hist(
                Hf, tot if kind == "regression" else None, feat_valid, nseg, local, s_dim, kind,
                min_samples_leaf, min_impurity_decrease,
            )
            del Hf
            ch.rel = _route(ch.sub, ch.rel[None, :], out[0], out[1], out[2], ch.seg_of_row)[0]
            _write_splits(outputs, where, [a.cpu().numpy() for a in out], feats_all[ch.trees], edges, F)
