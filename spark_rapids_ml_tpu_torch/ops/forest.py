#
# Random-forest binning, prediction, and the mesh-parallel scatter engine.
#
# Counterpart of spark_rapids_ml_tpu/ops/forest.py:
#   - compute_bin_edges: per-feature quantile edges on the host, the same
#     float64 sort + linear-interpolation formula;
#   - bin_features_feature_major: (N, D) -> (D, n_pad) int8 bins, through the
#     hand-written binning kernel (ops/binning.py) on the card;
#     bin_features_wide the same count for any number of edges, one kernel
#     launch a group of <= 127 edges (a bin counts the edges strictly below
#     x, so the groups' counts add up to it), in int16 bins;
#   - forest_predict: the mean of the trees' leaf values, a batched gather
#     traversal of the dense tree arrays (max_depth gather/compare steps);
#   - grow_forest: the scatter engine, the growth of every fit outside the
#     histogram builder's limits (ops/forest_grow.py) and of every fit on
#     more than one shard (models/random_forest.py).
# The dense layout: node i has children 2i+1 (x <= threshold) and 2i+2;
# feature -1 marks a leaf.
#
# The scatter engine grows T trees level by level over row-sharded bins (a
# list of per-shard (D, n_loc) feature-major bin tensors, B2's layout; one
# tensor is the one-shard case) and per-shard (S, T, n_loc) bootstrap-
# weighted stats.  Each level runs the JAX package's _wide_split_search:
# per feature chunk (_feat_chunk) the shards' fp32 segment sums of the
# unrounded stats keyed by (tree, node, bin) (scatter_add_, not kernel B3,
# which sums bf16-rounded stats: the two are not the same function), ONE
# psum_parts over the shards a chunk (section forest.hist_parts), then the
# split search on shard 0's device, the per-node feature subsets drawn with
# ops/prng.uniform_at / fold_in bit for bit with jax.random, and each shard
# routes its own rows.  The search runs only over the (tree, node) slots
# that hold rows (one psum of the shards' row counts a level, section
# forest.node_occupancy, finds them): a slot without rows takes the values
# the JAX package's search gives zero stats, so the trees are the same,
# and the deep levels of a large padded block cost what their nodes hold.
# XLA contracts a product feeding a sum into one fused multiply-add; the
# impurities, gains and the split gate do the same here (_fma: float32
# through float64), so equal histograms give equal splits.  Levels run in blocks of LEVEL_BLOCK, every level of
# a block at the block's padded node count (the draws' shape depends on
# it), the host reads one any-split flag per block, and the trees cross to
# the host once.  Ties and the order of every sum follow the JAX engine's,
# so on integer-valued stats (exact sums) the forests are node for node the
# JAX package's, on any shard count; on float stats the shards' partials
# add in shard order and agree within rounding.  On CPU tensors the
# segment sums run in row order, as XLA's on the CPU; on the card they are
# float atomics, whose order is free.  Across processes (the JAX package's
# multi-process branches, parallel/runner.py) the engine is unchanged: its
# two psums cross the ranks in global shard order (parallel/exchange.py),
# and every multi-rank forest grows here (models/random_forest.py routes by
# the global shard count).
#
# Not carried over: compute_bin_edges_device, forest_predict_cached and
# warm_forest_kernels (the TPU host link's and the AOT compile cache's
# workarounds; ops/precompile.py records why the port compiles nothing per
# shape), the SRML_FOREST_LEVEL_BLOCK / SRML_FOREST_HIST_MB switches (their
# defaults are the constants below), and the per-tree grow_tree reference
# (the tests hold the engine against the JAX package's engine instead).
#

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from .. import profiling
from ..parallel.exchange import psum_parts, replicate
from ..parallel.mesh import as_shards
from . import prng
from .binning import MAX_EDGES, bin_features_fm


def compute_bin_edges(X: np.ndarray, n_bins: int, max_sample: int = 100_000, seed: int = 0) -> np.ndarray:
    """Per-feature quantile bin edges, (D, n_bins-1) float32, from a row
    subsample of at most max_sample rows, on the host."""
    n = X.shape[0]
    if n > max_sample:
        idx = np.random.default_rng(seed).choice(n, max_sample, replace=False)
        sample = X[idx]
    else:
        sample = X
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    s = np.sort(np.asarray(sample, dtype=np.float64), axis=0)
    pos = qs * (s.shape[0] - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.ceil(pos).astype(np.int64)
    frac = (pos - lo)[:, None]
    return np.ascontiguousarray((s[lo] * (1.0 - frac) + s[hi] * frac).T, dtype=np.float32)


def bin_features_feature_major(X: torch.Tensor, edges: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(N, D) float32 -> (D, n_pad) int8 bins (bin = the number of edges
    strictly below x); columns N..n_pad-1 are zero bins (callers mask padded
    rows through weights).  At most 127 edges."""
    return bin_features_fm(X, edges.to(X.device, torch.float32).contiguous(), n_pad)


def bin_features_wide(X: torch.Tensor, edges: torch.Tensor, n_pad: int) -> torch.Tensor:
    """bin_features_feature_major for any number of edges: (D, n_pad)
    bins, int8 up to 127 edges, else int16 summed over one kernel launch a
    group of <= 127 edges."""
    edges = edges.to(X.device, torch.float32).contiguous()
    if edges.shape[1] <= MAX_EDGES:
        return bin_features_fm(X, edges, n_pad)
    out = torch.zeros((X.shape[1], n_pad), dtype=torch.int16, device=X.device)
    for g0 in range(0, edges.shape[1], MAX_EDGES):
        out += bin_features_fm(X, edges[:, g0 : g0 + MAX_EDGES].contiguous(), n_pad)
    return out


def forest_predict(
    X: torch.Tensor,          # (N, D)
    feature: torch.Tensor,    # (T, M) int32
    threshold: torch.Tensor,  # (T, M) in X's dtype
    leaf_value: torch.Tensor, # (T, M, V) float32
    max_depth: int,
) -> torch.Tensor:
    """Mean of the per-tree leaf values, (N, V) float32.  The trees are
    summed one after the other, in tree order."""
    T = feature.shape[0]
    n = X.shape[0]
    feature = feature.long()
    node = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        f = feature.gather(1, node)
        x = X.gather(1, f.clamp(min=0).T).T  # (T, N): x[t, r] = X[r, f[t, r]]
        child = 2 * node + 1 + (x > threshold.gather(1, node)).long()
        node = torch.where(f < 0, node, child)
    acc = leaf_value[0][node[0]]
    for t in range(1, T):
        acc = acc + leaf_value[t][node[t]]
    return acc / T


# ---------------------------------------------------------------------------
# The scatter engine (the JAX package's mesh-parallel level-block engine)
# ---------------------------------------------------------------------------

# inactive-row node id: above every level's node range (depth <= 16) and
# never doubled (retired rows are written the sentinel, not routed)
_SENTINEL = 1 << 20
# levels of one block, and the histogram budget of one feature chunk: the
# JAX package's SRML_FOREST_LEVEL_BLOCK and SRML_FOREST_HIST_MB defaults
LEVEL_BLOCK = 4
HIST_BUDGET_BYTES = 256 << 20
# elements of one (features, trees * rows) segment-id block of a shard's
# histogram pass
_SCATTER_ELEMENTS = 1 << 25


def _p2floor(x: int) -> int:
    """Largest power of two <= x (>= 1)."""
    return 1 << (max(1, int(x)).bit_length() - 1)


def _feat_chunk(n_cols: int, combined: int, n_bins: int, s_dim: int) -> int:
    """Power-of-two feature-chunk width keeping one (fc, S, combined * B)
    histogram under HIST_BUDGET_BYTES."""
    fc = max(1, HIST_BUDGET_BYTES // max(1, combined * n_bins * s_dim * 4))
    return max(1, min(_p2floor(fc), _p2floor(n_cols)))


def _engine_blocks(max_depth: int) -> List[Tuple[int, int, int]]:
    """(l0, block, n_nodes_pad) of each block: LEVEL_BLOCK levels, padded to
    the top level's node count."""
    out = []
    for l0 in range(0, max_depth + 1, LEVEL_BLOCK):
        l1 = min(l0 + LEVEL_BLOCK, max_depth + 1)
        out.append((l0, l1 - l0, 2 ** (l1 - 1)))
    return out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, as XLA contracts a product feeding a sum into
    a fused multiply-add: float32 operands through float64 (the product is
    exact there), then one rounding to float32."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def _sum_products(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_s x[s] * y[s] over the leading (stat) axis, one fused
    multiply-add a term after the first product (XLA's reduction of a
    product)."""
    acc = x[0] * y[0]
    for i in range(1, x.shape[0]):
        acc = _fma(x[i], y[i], acc)
    return acc


def _impurity_s0(stats: torch.Tensor, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stat-leading (S, ...) stats -> (impurity, weight)."""
    if kind == "regression":
        w = stats[0]
        mean = stats[1] / w.clamp_min(1e-12)
        var = _fma(-mean, mean, stats[2] / w.clamp_min(1e-12))
        return var.clamp_min(0.0), w
    w = stats[0]
    for i in range(1, stats.shape[0]):
        w = w + stats[i]
    p = stats / w.clamp_min(1e-12)[None]
    if kind == "entropy":
        imp = -_sum_products(p, torch.log(p.clamp_min(1e-12)) / math.log(2.0))
    else:  # gini
        imp = 1.0 - _sum_products(p, p)
    return imp, w


def _node_value_s0(node_stats: torch.Tensor, kind: str) -> torch.Tensor:
    """(S, nb) node stats -> (nb, V) node values."""
    if kind == "regression":
        return (node_stats[1] / node_stats[0].clamp_min(1e-12))[:, None]
    w = node_stats[0]
    for i in range(1, node_stats.shape[0]):
        w = w + node_stats[i]
    return (node_stats / w.clamp_min(1e-12)[None]).T


def _split_ok(bg, p_w, p_imp, min_samples_leaf, min_impurity_decrease) -> torch.Tensor:
    """The split gate: a finite gain above the parent's noise floor and
    min_impurity_decrease, an impure parent, enough weight for two
    leaves."""
    noise_floor = _fma(1e-6 * p_imp, p_w, torch.full_like(p_w, 1e-30))
    return (
        torch.isfinite(bg)
        & (p_imp > 0)
        & (bg > torch.maximum(min_impurity_decrease * p_w, noise_floor))
        & (p_w >= 2 * min_samples_leaf)
    )


def _best_split_from_hist(hist: torch.Tensor, kind: str, min_samples_leaf: float):
    """hist (S, nb, Dc, B) -> (gain (nb, Dc, B), p_w (nb,), p_imp (nb,),
    p_val (nb, V)): the weighted impurity decrease of every (feature, bin)
    split, the empty-right last bin and min_samples_leaf gated to -inf; the
    parent's stats from the chunk's first feature's totals."""
    left = torch.cumsum(hist, dim=-1)
    total = left[..., -1:]
    right = total - left
    l_imp, l_w = _impurity_s0(left, kind)
    r_imp, r_w = _impurity_s0(right, kind)
    node_stats = total[:, :, 0, 0]
    p_imp, p_w = _impurity_s0(node_stats, kind)
    p_val = _node_value_s0(node_stats, kind)
    gain = _fma(p_imp[:, None, None], p_w[:, None, None], -_fma(l_imp, l_w, r_imp * r_w))
    ok = (l_w >= min_samples_leaf) & (r_w >= min_samples_leaf)
    gain = torch.where(ok, gain, -math.inf)
    gain[:, :, -1] = -math.inf
    return gain, p_w, p_imp, p_val


def _shard_histograms(bins: torch.Tensor, stats_m: torch.Tensor, base_ids: torch.Tensor, start: int,
                      fc: int, n_slots: int, n_bins: int) -> torch.Tensor:
    """One shard's (fc, S, n_slots * B) histogram of features [start,
    start + fc): per feature and stat the segment sum of the masked stats
    (S, T, n_loc) at ids base_ids (T, n_loc) + the feature's bins, in
    (tree, row) order within a segment."""
    S = stats_m.shape[0]
    tn = base_ids.numel()
    out = torch.zeros((fc, S, n_slots * n_bins), dtype=stats_m.dtype, device=stats_m.device)
    group = max(1, _SCATTER_ELEMENTS // max(1, tn))
    flat_stats = stats_m.reshape(S, 1, tn)
    for g0 in range(0, fc, group):
        g1 = min(fc, g0 + group)
        ids = (base_ids[None] + bins[start + g0 : start + g1, None, :].long()).reshape(g1 - g0, tn)
        for s in range(S):
            out[g0:g1, s].scatter_add_(1, ids, flat_stats[s].expand(g1 - g0, tn))
    return out


def _wide_split_search(bins, stats_m, ids, slots, combined, key, n_bins, feat_batch, kind, max_features,
                       min_samples_leaf, min_impurity_decrease):
    """One level's split search over every shard's rows (the JAX package's
    _wide_split_search with its psum combine) for the occupied (tree, node)
    slots `slots` (n_occ,) of the level's `combined`: per feature chunk the
    shards' histograms keyed by compact slot, one psum_parts, the best
    (feature, bin) of each slot.  Returns (bf, bb, split_ok, p_w, p_imp,
    p_val) over the occupied slots, on shard 0's device."""
    D = bins[0].shape[0]
    S = stats_m[0].shape[0]
    B = n_bins
    n_occ = int(slots.shape[0])
    dev = stats_m[0].device
    if max_features < D:
        # per-node exact-size random feature subset: the max_features-th
        # largest of per-(node, feature) float32 uniform scores, the
        # occupied slots' rows of the (combined, D) draw
        flat = slots.to(dev)[:, None] * D + torch.arange(D, dtype=torch.int64, device=dev)[None, :]
        scores = prng.uniform_at(key.to(dev), flat)
        kth = torch.topk(scores, max_features, dim=1).values[:, -1]
        fmask_full = scores >= kth[:, None]
    cbf = torch.zeros(n_occ, dtype=torch.int32, device=dev)
    cbb = torch.zeros(n_occ, dtype=torch.int32, device=dev)
    cbg = torch.full((n_occ,), -math.inf, dtype=stats_m[0].dtype, device=dev)
    aux = None
    for c in range(-(-D // feat_batch)):
        # a clamped start keeps the chunk in bounds; overlapped features are
        # evaluated twice, with the same gains, which cannot change the
        # strict-> combine
        start = min(c * feat_batch, D - feat_batch)
        with profiling.phase("forest.engine.hist", dev):
            parts = [_shard_histograms(b, st, i, start, feat_batch, n_occ, B) for b, st, i in zip(bins, stats_m, ids)]
            hist = psum_parts(parts, section="forest.hist_parts")[0]
        with profiling.phase("forest.engine.split", dev):
            hist = hist.reshape(feat_batch, S, n_occ, B).permute(1, 2, 0, 3)  # (S, n_occ, fc, B)
            gain, p_w, p_imp, p_val = _best_split_from_hist(hist, kind, min_samples_leaf)
            if max_features < D:
                gain = torch.where(fmask_full[:, start : start + feat_batch, None], gain, -math.inf)
            flat_gain = gain.reshape(n_occ, -1)
            best = torch.argmax(flat_gain, dim=1)
            bg = flat_gain.gather(1, best[:, None])[:, 0]
            bf = (start + best // B).to(torch.int32)
            bb = (best % B).to(torch.int32)
            if aux is None:
                aux = (p_w, p_imp, p_val)  # identical across chunks
            better = bg > cbg
            cbf, cbb, cbg = torch.where(better, bf, cbf), torch.where(better, bb, cbb), torch.maximum(bg, cbg)
    p_w, p_imp, p_val = aux
    ok = _split_ok(cbg, p_w, p_imp, min_samples_leaf, min_impurity_decrease)
    return cbf, cbb, ok, p_w, p_imp, p_val


def _occupied_slots(rel_c: List[torch.Tensor], combined: int, dev: torch.device) -> torch.Tensor:
    """The (tree, node) slots below `combined` that hold any shard's row,
    ascending, on `dev`: one psum_parts of the shards' row counts."""
    counts = []
    for rc in rel_c:
        cnt = torch.zeros(combined + 1, dtype=torch.int32, device=rc.device)
        counts.append(cnt.index_add_(0, rc.reshape(-1), torch.ones(rc.numel(), dtype=torch.int32, device=rc.device)))
    total = psum_parts(counts, section="forest.node_occupancy")[0]
    return torch.nonzero(total[:combined] > 0)[:, 0].to(dev)


def _empty_slot_values(kind: str, s_dim: int, dtype: torch.dtype, dev: torch.device):
    """(p_w, p_imp, p_val) of a slot without rows: the split search's values
    on zero stats."""
    zero = torch.zeros((s_dim, 1), dtype=dtype, device=dev)
    p_imp, p_w = _impurity_s0(zero, kind)
    return p_w[0], p_imp[0], _node_value_s0(zero, kind)[0]


def _forest_block(bins, stats, rel, key, bufs, edges_dev, *, l0, block, n_nodes_pad, max_depth, n_bins,
                  feat_batch, kind, max_features, min_samples_leaf, min_impurity_decrease):
    """`block` growth levels (the JAX package's _forest_block_body and the
    tree-buffer writes of _forest_block_kernel): per level the split search
    at n_nodes_pad nodes a tree — run on the slots that hold rows, every
    other slot taking the values the search gives a slot without rows —
    each shard's rows routed, the level's nodes written into the (T, M)
    buffers.  Updates rel and bufs in place and returns the block's
    any-split flags (on shard 0's device)."""
    T = rel[0].shape[0]
    combined = T * n_nodes_pad
    dev = bufs[0].device
    devices = [r.device for r in rel]
    tree_base = [(torch.arange(T, dtype=torch.int64, device=d) * n_nodes_pad)[:, None] for d in devices]
    feature, threshold, leaf_value, counts, impurity = bufs
    D = bins[0].shape[0]
    S = stats[0].shape[0]
    e_cols = edges_dev.shape[1]
    empty_w, empty_imp, empty_val = _empty_slot_values(kind, S, stats[0].dtype, dev)
    flags = []
    for li in range(l0, l0 + block):
        before = profiling.phase_times()
        t0 = profiling.now()
        active = [r < _SENTINEL for r in rel]
        rel_c = [torch.where(a, r.long() + tb, combined) for a, r, tb in zip(active, rel, tree_base)]
        slots = _occupied_slots(rel_c, combined, dev)
        n_occ = int(slots.shape[0])
        compact = torch.zeros(combined + 1, dtype=torch.int64, device=dev)
        compact[slots] = torch.arange(n_occ, dtype=torch.int64, device=dev)
        bf = torch.zeros(combined, dtype=torch.int32, device=dev)
        bb = torch.zeros(combined, dtype=torch.int32, device=dev)
        ok = torch.zeros(combined, dtype=torch.bool, device=dev)
        p_w = empty_w.expand(combined).clone()
        p_imp = empty_imp.expand(combined).clone()
        p_val = empty_val.expand(combined, -1).clone()
        if n_occ:
            stats_m = [torch.where(a[None], st, 0.0) for a, st in zip(active, stats)]
            # inactive rows add their zero stats to slot 0, as in the JAX
            # package
            ids = [c.gather(0, rc.reshape(-1)).reshape(rc.shape) * n_bins
                   for c, rc in zip(replicate(compact, devices), rel_c)]
            found = _wide_split_search(
                bins, stats_m, ids, slots, combined, prng.fold_in(key, li), n_bins, feat_batch, kind,
                max_features, min_samples_leaf, min_impurity_decrease,
            )
            for full, part in zip((bf, bb, ok, p_w, p_imp, p_val), found):
                full.index_copy_(0, slots, part)
        with profiling.phase("forest.engine.route", dev):
            bf_t, bb_t = bf.reshape(T, n_nodes_pad), bb.reshape(T, n_nodes_pad)
            pw_t, pi_t = p_w.reshape(T, n_nodes_pad), p_imp.reshape(T, n_nodes_pad)
            pv_t = p_val.reshape(T, n_nodes_pad, -1)
            # the forest's last level never splits (its nodes are the leaves)
            ok_t = ok.reshape(T, n_nodes_pad) & (li < max_depth)
            flags.append(ok_t.any())
            for i, (f_s, b_s, o_s) in enumerate(zip(replicate(bf_t, devices), replicate(bb_t, devices),
                                                      replicate(ok_t, devices))):
                safe = torch.where(active[i], rel[i], 0).long()
                f_r = f_s.gather(1, safe)
                b_r = b_s.gather(1, safe)
                ok_r = o_s.gather(1, safe) & active[i]
                row_bin = bins[i].gather(0, f_r.long()).to(torch.int32)
                go = (row_bin > b_r).to(torch.int32)
                rel[i] = torch.where(ok_r, 2 * rel[i] + go, _SENTINEL).to(torch.int32)
            n_nodes = 2**li
            sl = slice(n_nodes - 1, 2 * n_nodes - 1)
            ok_i, bf_i, bb_i = ok_t[:, :n_nodes], bf_t[:, :n_nodes], bb_t[:, :n_nodes]
            feature[:, sl] = torch.where(ok_i, bf_i, -1)
            thr = edges_dev[bf_i.long().clamp(0, D - 1), bb_i.long().clamp(0, e_cols - 1)]
            threshold[:, sl] = torch.where(ok_i, thr, 0.0).to(threshold.dtype)
            leaf_value[:, sl] = pv_t[:, :n_nodes].to(leaf_value.dtype)
            counts[:, sl] = pw_t[:, :n_nodes].to(counts.dtype)
            impurity[:, sl] = pi_t[:, :n_nodes].to(impurity.dtype)
        after = profiling.phase_times()
        spent = {k: after.get(f"forest.engine.{k}", 0.0) - before.get(f"forest.engine.{k}", 0.0)
                 for k in ("hist", "split", "route")}
        profiling.record_event("forest.engine.level", level=li, slots=n_occ, seconds=profiling.now() - t0,
                               hist_s=spent["hist"], split_s=spent["split"], route_s=spent["route"])
    return torch.stack(flags)


def grow_forest(
    bins,
    stats_t,
    edges: np.ndarray,
    max_depth: int,
    n_bins: int,
    kind: str,
    max_features: int,
    min_samples_leaf: float,
    min_impurity_decrease: float,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Grow T trees on the scatter engine (module header).  `bins`: per-shard
    (D, n_loc) integer bins; `stats_t`: per-shard (S, T, n_loc) bootstrap-
    weighted stats (regression (w, wy, wy^2), classification w x one-hot).
    Returns host arrays (features (T, M) int32, thresholds (T, M),
    leaf_values (T, M, V), n_samples (T, M), impurities (T, M)) float32,
    M = 2^(max_depth+1) - 1, the levels past the last split at their leaf
    defaults.  Counters forest.levels.dispatches (blocks run),
    forest.level_syncs (flag reads) and forest.d2h_transfers (1); phases
    forest.engine.hist (the shards' histograms and their psum, a feature
    chunk), forest.engine.split (the split search, a chunk) and
    forest.engine.route, each synchronised on a card, and one
    forest.engine.level event a level with its occupied slots and
    seconds."""
    bins, stats = as_shards(bins), [s for s in as_shards(stats_t)]
    S, T = int(stats[0].shape[0]), int(stats[0].shape[1])
    D = int(bins[0].shape[0])
    V = 1 if kind == "regression" else S
    M = 2 ** (max_depth + 1) - 1
    if 2 ** (max_depth + 1) >= _SENTINEL:
        raise ValueError(f"max_depth={max_depth} exceeds the engine's sentinel headroom")
    dev = stats[0].device
    edges_dev = torch.as_tensor(np.asarray(edges, np.float32), device=dev)
    key = prng.prng_key(seed, dev)
    rel = [torch.zeros((T, int(b.shape[1])), dtype=torch.int32, device=b.device) for b in bins]
    bufs = (
        torch.full((T, M), -1, dtype=torch.int32, device=dev),
        torch.zeros((T, M), dtype=torch.float32, device=dev),
        torch.zeros((T, M, V), dtype=torch.float32, device=dev),
        torch.zeros((T, M), dtype=torch.float32, device=dev),
        torch.zeros((T, M), dtype=torch.float32, device=dev),
    )
    top = max_depth
    for l0, block, npad in _engine_blocks(max_depth):
        flags = _forest_block(
            bins, stats, rel, key, bufs, edges_dev, l0=l0, block=block, n_nodes_pad=npad,
            max_depth=max_depth, n_bins=n_bins, feat_batch=_feat_chunk(D, T * npad, n_bins, S), kind=kind,
            max_features=int(max_features), min_samples_leaf=float(min_samples_leaf),
            min_impurity_decrease=float(min_impurity_decrease),
        )
        profiling.incr_counter("forest.levels.dispatches")
        flags_h = flags.cpu().tolist()
        profiling.incr_counter("forest.level_syncs")
        stopped = next((l0 + i for i, any_split in enumerate(flags_h) if not any_split), None)
        if stopped is not None:
            top = stopped
            break
    m_used = 2 ** (top + 1) - 1
    host = [b[:, :m_used].cpu().numpy() for b in bufs]
    profiling.incr_counter("forest.d2h_transfers")
    if m_used == M:
        return tuple(host)
    out = (
        np.full((T, M), -1, np.int32),
        np.zeros((T, M), np.float32),
        np.zeros((T, M, V), np.float32),
        np.zeros((T, M), np.float32),
        np.zeros((T, M), np.float32),
    )
    for full, part in zip(out, host):
        full[:, :m_used] = part
    return out
