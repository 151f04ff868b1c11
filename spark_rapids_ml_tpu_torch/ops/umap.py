#
# UMAP primitives: the fuzzy simplicial set and the SGD layout, the layout
# column-sharded over a device mesh.
#
# Counterpart of spark_rapids_ml_tpu/ops/umap.py.  The JAX package runs this
# module on XLA (no Pallas kernel lies in it), so the port runs it on plain
# torch ops on the device the graph lives on:
#
#   graph   smooth-kNN calibration (rho / sigma by 64 fixed bisection steps,
#           all rows at once, exp as XLA evaluates it, ops/xla_math.py),
#           the fuzzy union, the optional label
#           intersection, then the on-device assembly of the padded
#           head-grouped layout: _graph_edges (the dense transpose lookup),
#           _edge_order (head-major, weight-descending: a
#           stable sort on -w2 then one on the head key, torch's lexsort) and
#           _gather_layout.  Its one host read is the degree quantile that
#           fixes the pad width P.
#   init    "spectral": deflated subspace iteration on the normalized
#           adjacency of the padded layout (a row gather per SpMV, Cholesky
#           and a triangular solve in float32), read back once an iteration
#           for its stopping test; "random": uniform [-10, 10) at the padded
#           shape.
#   layout  the per-device body of the JAX package's sharded epoch step:
#           firing draws from counter-mode threefry over the (P, n_pad)
#           grid, the shared negative table of table_size rows an epoch, 2x
#           attraction, clip at +-4, alpha = lr (1 - e / epochs).  The keys
#           and negative tables of a block of epochs are drawn in one
#           batched call (ops/prng.py), bit for bit the JAX draws.  On one
#           shard (optimize_layout) every head is the device's; on a mesh
#           (optimize_layout_sharded) each shard owns a block of n_pad /
#           n_dev head columns of the transposed layout, the embedding is
#           replicated, each epoch updates every shard's heads against the
#           epoch-start embedding (its counter grid offset by the block's
#           first column col0, the negative table the replicated draw), and
#           one all-gather (exchange.umap.layout_rows) rebuilds the whole
#           embedding on every shard.  A head's update reads only the
#           epoch-start embedding and reduces over the P axis alone, in a
#           fixed order (xla_math.sum_dim0), so N shards give the one-shard
#           embedding bit for bit on one device type.
#   transform the staging (calibration, weights, weighted-mean init) and the
#           refinement epochs against the frozen training embedding.
#
# Rows are padded to parallel.mesh.padded_row_count(n, mesh), the geometry
# the firing draws are keyed on, so a fixed seed gives the JAX package's
# draws on every mesh size that divides 64 (its determinism contract).  The
# float results agree with the JAX package to rounding: ops/xla_math.py
# copies XLA's float32 exp, its reduction order and the multiply-adds it
# fuses, where they steer a decision (a bisection step, the edge order) or
# an epoch's update; the matmuls, and the orders XLA picks inside a fusion,
# differ in the last bits.
#
# Phases (profiling.phase): umap.graph, umap.init, umap.layout,
# umap.transform.  Counters: umap.h2d_transfers / umap.h2d_bytes (host
# uploads of the graph, once a fit), umap.layout.dispatches and
# umap.transform.dispatches (once an epoch block).  The JAX engine's
# environment knobs are keyword arguments with its defaults: degree_cap
# (SRML_UMAP_DEGREE_CAP, 36), degree_quantile (SRML_UMAP_DEGREE_QUANTILE,
# 0.98), epoch_block (SRML_UMAP_EPOCH_BLOCK, 50), table_size
# (SRML_UMAP_TABLE, 256).
#
# The graph and the init run on the mesh's first device.  Not carried over:
# the AOT executable cache and the ordered step events.
#

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from .. import profiling
from ..parallel.exchange import allgather_rows, replicate
from ..parallel.mesh import Mesh, padded_row_count
from . import prng
from .xla_math import exp_f32, fma_f32, pow_f32, sum_dim0

DEGREE_CAP = 36
DEGREE_QUANTILE = 0.98
EPOCH_BLOCK = 50
NEG_TABLE = 256


def find_ab_params(spread: float, min_dist: float) -> Tuple[float, float]:
    """Fit the (a, b) curve 1/(1+a*x^(2b)) to the fuzzy membership target
    (standard UMAP curve fit)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros(xv.shape)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def smooth_knn_calibration(
    knn_dists: torch.Tensor,
    local_connectivity: float = 1.0,
    n_iters: int = 64,
    bandwidth: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized rho/sigma search over (n, k) ascending distances (column 0
    may be the self distance): rho = distance to the local_connectivity-th
    nearest nonzero neighbor; sigma solves sum_j exp(-(d_ij - rho)/sigma) =
    log2(k) by `n_iters` bisection steps, floored at 1e-3 times the mean
    nonzero distance."""
    n, k = knn_dists.shape
    dev = knn_dists.device
    target = _f32(math.log2(k), dev) * bandwidth
    nonzero = knn_dists > 0.0
    lc = _f32(local_connectivity, dev)
    idx = int(math.floor(float(local_connectivity))) - 1
    frac = lc - torch.floor(lc)
    big = torch.where(nonzero, knn_dists, math.inf)
    sorted_nz = torch.sort(big, dim=1).values
    lo_val = sorted_nz[:, max(idx, 0)]
    hi_val = sorted_nz[:, min(idx + 1, k - 1)]
    gap = torch.where(torch.isfinite(hi_val), hi_val - lo_val, 0.0)
    rho = torch.where(torch.isfinite(lo_val), lo_val + frac * gap, 0.0)

    excess = torch.clamp(knn_dists - rho[:, None], min=0.0)
    lo = torch.zeros(n, dtype=knn_dists.dtype, device=dev)
    hi = torch.full((n,), math.inf, dtype=knn_dists.dtype, device=dev)
    sigma = torch.ones(n, dtype=knn_dists.dtype, device=dev)
    for _ in range(n_iters):
        cur = sum_dim0(torch.where(nonzero, exp_f32(-excess / sigma[:, None]), 1.0).T)
        too_high = cur > target
        hi = torch.where(too_high, sigma, hi)
        lo = torch.where(too_high, lo, sigma)
        sigma = torch.where(torch.isinf(hi), sigma * 2.0, (lo + hi) / 2.0)
    # floor from the mean NONZERO distance: the all-zero padding rows of a
    # bucketed query block must not dilute it
    nz_count = torch.clamp(nonzero.sum(), min=1)
    mean_d = torch.where(nonzero, knn_dists, 0.0).sum() / nz_count
    return rho, torch.maximum(sigma, 1e-3 * mean_d)


def _transpose_lookup(knn_ids: torch.Tensor, W: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each edge (i -> j = knn_ids[i, s]): the weight of (j -> i) if j
    lists i, else 0, and whether it does (the dense (n, k, k) lookup; at
    1,000,000 x 15 its int64 ids take 1.8 GB, under the layout's peak)."""
    n = knn_ids.shape[0]
    rows = torch.arange(n, device=W.device)[:, None, None]
    match = knn_ids[knn_ids] == rows
    return torch.where(match, W[knn_ids], 0.0).amax(dim=2), match.any(dim=2)


def fuzzy_simplicial_set(
    knn_ids: torch.Tensor,
    knn_dists: torch.Tensor,
    rho: torch.Tensor,
    sigma: torch.Tensor,
    set_op_mix_ratio: float = 1.0,
) -> torch.Tensor:
    """Directed membership strengths (n, k), symmetrized via the fuzzy set
    union/intersection mix: w_sym = mix*(w + wT - w*wT) + (1-mix)*w*wT."""
    n = knn_ids.shape[0]
    ids = knn_ids.long()
    w = exp_f32(-torch.clamp(knn_dists - rho[:, None], min=0.0) / sigma[:, None])
    self_e = ids == torch.arange(n, device=ids.device)[:, None]
    w = torch.where(knn_dists > 0.0, w, torch.where(self_e, 0.0, 1.0))
    wT, _ = _transpose_lookup(ids, w)
    return set_op_mix_ratio * (w + wT - w * wT) + (1.0 - set_op_mix_ratio) * (w * wT)


def categorical_simplicial_set_intersection(
    W: torch.Tensor,
    knn_ids: torch.Tensor,
    labels: torch.Tensor,
    far_dist: float = 5.0,
    unknown_dist: float = 1.0,
) -> torch.Tensor:
    """Supervised UMAP: edges between differently-labeled points are
    downweighted by exp(-far_dist), edges touching an unknown (< 0) label
    by exp(-unknown_dist); each row is then renormalized to max 1."""
    dev = W.device
    yi = labels[:, None]
    yj = labels[knn_ids.long()]
    unknown = (yi < 0) | (yj < 0)
    differ = yi != yj
    scale = torch.where(
        unknown,
        torch.exp(_f32(-unknown_dist, dev)),
        torch.where(differ, torch.exp(_f32(-far_dist, dev)), _f32(1.0, dev)),
    )
    W2 = W * scale
    return W2 / torch.clamp(W2.amax(dim=1, keepdim=True), min=1e-12)


def _calibrated_weights(
    knn_ids: torch.Tensor,
    knn_dists: torch.Tensor,
    local_connectivity: float,
    set_op_mix_ratio: float,
) -> torch.Tensor:
    """Calibration followed by the fuzzy union: the symmetrized W."""
    rho, sigma = smooth_knn_calibration(knn_dists, local_connectivity=local_connectivity)
    return fuzzy_simplicial_set(knn_ids, knn_dists, rho, sigma, set_op_mix_ratio)


# -- host reference assembly -------------------------------------------------


def dedupe_undirected(knn_ids: np.ndarray, W: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Directed (n, k) adjacency -> undirected (ii, jj, ww) edge list with
    each pair kept once at the per-pair MAX of its two directed weights
    (host REFERENCE of the device assembly)."""
    n, k = knn_ids.shape
    heads = np.repeat(np.arange(n, dtype=np.int64), k)
    tails = knn_ids.astype(np.int64).reshape(-1)
    w = np.asarray(W, dtype=np.float32).reshape(-1)
    keep = (w > 0) & (heads != tails)
    heads, tails, w = heads[keep], tails[keep], w[keep]
    lo = np.minimum(heads, tails)
    hi = np.maximum(heads, tails)
    key_ = lo * n + hi
    order = np.argsort(key_, kind="stable")
    k_s, w_s = key_[order], w[order]
    firsts = np.r_[True, k_s[1:] != k_s[:-1]]
    group = np.cumsum(firsts) - 1
    ww = np.zeros(int(group[-1]) + 1 if group.size else 0, np.float32)
    np.maximum.at(ww, group, w_s)
    sel = order[firsts]
    return lo[sel].astype(np.int32), hi[sel].astype(np.int32), ww


def padded_head_layout(
    heads: np.ndarray,
    tails: np.ndarray,
    weights: np.ndarray,
    n: int,
    cap: int = DEGREE_CAP,
    quantile: float = DEGREE_QUANTILE,
):
    """Static scatter-free edge layout for the SGD epochs (host REFERENCE of
    the device assembly): every undirected edge as two directed edges,
    grouped by head, weight-descending, padded to the `quantile` degree of
    the nonzero degrees (at least 8, at most `cap`) with 0-weight
    self-loops.  Returns (tails_pad (n, P) int32, w_pad (n, P) f32)."""
    h2 = np.concatenate([heads, tails]).astype(np.int64)
    t2 = np.concatenate([tails, heads]).astype(np.int64)
    w2 = np.concatenate([weights, weights]).astype(np.float32)
    keep = w2 > 0
    h2, t2, w2 = h2[keep], t2[keep], w2[keep]
    # positive f32 bit patterns order as their values: (head << 32) |
    # ~bits(w) is head-major, weight-descending
    wbits = w2.view(np.uint32).astype(np.int64)
    order = np.argsort((h2 << 32) | (0xFFFFFFFF - wbits), kind="stable")
    h2, t2, w2 = h2[order], t2[order], w2[order]
    counts = np.bincount(h2, minlength=n)
    nz = counts[counts > 0]
    p98 = int(np.quantile(nz, quantile)) if nz.size else 1
    P = int(min(cap, max(8, p98, 1)))
    starts = np.cumsum(counts) - counts
    pos = np.arange(h2.size) - np.repeat(starts, counts)
    sel = pos < P
    tails_pad = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, P))
    w_pad = np.zeros((n, P), np.float32)
    tails_pad[h2[sel], pos[sel]] = t2[sel].astype(np.int32)
    w_pad[h2[sel], pos[sel]] = w2[sel]
    return tails_pad, w_pad


# -- on-device graph assembly ------------------------------------------------


def _graph_edges(knn_ids: torch.Tensor, W: torch.Tensor):
    """Directed (n, k) adjacency -> flat directed edge list covering both
    directions of every undirected pair once per endpoint, at the per-pair
    MAX weight; the reversed copies of mutual edges are dropped.  Returns
    (heads, tails, w, valid, wmax), each flat of size 2nk but wmax."""
    n, k = knn_ids.shape
    ids = knn_ids.long()
    rows = torch.arange(n, device=ids.device)[:, None].expand(n, k)
    wT, mutual = _transpose_lookup(ids, W)
    ws = torch.maximum(W, wT)
    valid_f = (ws > 0.0) & (ids != rows)
    valid_r = valid_f & ~mutual
    heads = torch.cat([rows.reshape(-1), ids.reshape(-1)])
    tails = torch.cat([ids.reshape(-1), rows.reshape(-1)])
    w2 = torch.cat([ws.reshape(-1), ws.reshape(-1)])
    valid = torch.cat([valid_f.reshape(-1), valid_r.reshape(-1)])
    return heads, tails, w2, valid, W.max()


def _edge_order(heads, tails, w2, valid, wmax, epochs_total, quantile, n_pad: int):
    """Head-major weight-descending edge order, per-head starts and degrees,
    and the degree quantile that fixes the pad width.  Edges with w <
    wmax / epochs can never fire and are dropped (keyed past every head).
    The order is jnp.lexsort((-w2, hkey)) as two stable sorts."""
    dev = w2.device
    keep = valid & (w2 * epochs_total >= wmax)
    hkey = torch.where(keep, heads, n_pad)
    by_w = torch.argsort(-w2, stable=True)
    order = by_w[torch.argsort(hkey[by_w], stable=True)]
    sh = hkey[order].contiguous()
    st = tails[order]
    sw = w2[order]
    node_ids = torch.arange(n_pad, dtype=sh.dtype, device=dev)
    starts = torch.searchsorted(sh, node_ids)
    deg = torch.searchsorted(sh, node_ids, right=True) - starts
    # linear-interpolated quantile of the NONZERO degrees (np.quantile):
    # the ascending sort puts the zero-degree rows first.  pos is one fused
    # multiply-add in XLA: exact in float64 here, rounded once
    degs = torch.sort(deg).values
    nz = (deg > 0).sum()
    q = _f32(quantile, dev)
    pos = ((n_pad - nz).double() + q.double() * torch.clamp(nz - 1, min=0).double()).float()
    lo = torch.clamp(torch.floor(pos).long(), 0, n_pad - 1)
    hi = torch.clamp(lo + 1, 0, n_pad - 1)
    frac = pos - lo.float()
    qval = degs[lo].float() * (1.0 - frac) + degs[hi].float() * frac
    qval = torch.where(nz > 0, qval, 1.0)
    return st, sw, starts, deg, qval


def _gather_layout(st, sw, starts, deg, wmax, P: int):
    """Sorted edge list -> padded head-grouped (n_pad, P) layout by gather:
    slot p of head h reads sorted position starts[h] + p, each head cut to
    its P strongest edges; empty slots self-point at weight 0.  Weights come
    out divided by wmax (the firing probability)."""
    n_pad = starts.shape[0]
    dev = st.device
    slot = torch.arange(P, device=dev)[None, :]
    in_group = slot < torch.clamp(deg, max=P)[:, None]
    idx = torch.clamp(starts[:, None] + slot, 0, st.shape[0] - 1)
    self_col = torch.arange(n_pad, device=dev)[:, None].expand(n_pad, P)
    tails_pad = torch.where(in_group, st[idx], self_col).to(torch.int32)
    w_pad = torch.where(in_group, sw[idx] / torch.clamp(wmax, min=1e-12), 0.0)
    return tails_pad, w_pad.float()


def _pad_width(qval: torch.Tensor, cap: int) -> int:
    """P from the degree quantile (the assembly's one host read)."""
    return int(min(cap, max(8, int(qval.item()), 1)))


def build_head_layout_device(
    knn_ids: torch.Tensor,
    W: torch.Tensor,
    n_pad: int,
    n_epochs: int,
    cap: int = DEGREE_CAP,
    quantile: float = DEGREE_QUANTILE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device symmetrize + dedupe + pad: (n, k) fuzzy graph -> (n_pad, P)
    head-grouped layout (int32 tails, wmax-normalized f32 weights), rows >= n
    padded with 0-weight self-loops."""
    heads, tails, w2, valid, wmax = _graph_edges(knn_ids, W)
    st, sw, starts, deg, qval = _edge_order(
        heads, tails, w2, valid, wmax, _f32(max(n_epochs, 1), W.device), quantile, n_pad
    )
    return _gather_layout(st, sw, starts, deg, wmax, _pad_width(qval, cap))


# -- spectral and random init ------------------------------------------------


def _laplacian_eigenmap_kernel(
    tails_pad: torch.Tensor,
    w_pad: torch.Tensor,
    key: torch.Tensor,
    valid_count: int,
    c: int,
    n_iter: int = 50,
) -> torch.Tensor:
    """Top non-trivial eigenvectors of A_hat = D^-1/2 W D^-1/2 by deflated
    subspace iteration on the padded head-grouped layout (the bottom
    eigenvectors of the normalized Laplacian).  The trivial eigenvector
    D^1/2 1 is projected out each iteration; rows >= valid_count start at
    zero and stay zero.  Stops at residual 3e-3 or n_iter iterations."""
    n, P = tails_pad.shape
    dev = w_pad.device
    tails = tails_pad.long()
    deg = w_pad.sum(dim=1)
    dinv = 1.0 / torch.sqrt(torch.clamp(deg, min=1e-12))
    wn_T = (w_pad * dinv[:, None] * dinv[tails]).T.contiguous()
    flat_tails_T = tails.T.reshape(-1)
    v0 = torch.sqrt(torch.clamp(deg, min=0.0))
    v0 = v0 / torch.clamp(torch.linalg.norm(v0), min=1e-12)
    eye = torch.eye(c, dtype=torch.float32, device=dev)

    def spmv(x):
        xt = x[flat_tails_T].T.reshape(c, P, n)  # one row gather
        return torch.stack([(wn_T * xt[j]).sum(dim=0) for j in range(c)], dim=1)

    def orthonormalize(y):
        y = y - v0[:, None] * (v0 @ y)[None, :]
        r = torch.linalg.cholesky(y.T @ y + 1e-12 * eye)
        # y r^-T: the JAX triangular_solve(r, y, left_side=False, lower=True,
        # transpose_a=True)
        return torch.linalg.solve_triangular(r.T, y, upper=True, left=False)

    row_valid = torch.arange(n, device=dev) < valid_count
    x = orthonormalize(prng.normal(key, (n, c)) * row_valid[:, None])
    for _ in range(n_iter):
        y = orthonormalize(spmv(x) + x)
        res = torch.linalg.norm(y - x @ (x.T @ y)) / math.sqrt(c)
        x = y
        if not bool(res > 3e-3):
            break
    return x


def _spectral_scale_noise(emb: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """10-box rescale plus a 1e-4 symmetry-breaking jitter."""
    scale = torch.clamp(emb.abs().max(), min=1e-12)
    noise = 1e-4 * prng.normal(key, tuple(emb.shape))
    return (emb / scale * 10.0 + noise).float()


def _h2d(arr, dtype: np.dtype, device: torch.device) -> torch.Tensor:
    """Counted host->device upload: a tensor passes through (cast on its
    device); a host array bumps umap.h2d_transfers / umap.h2d_bytes."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype)
    host = np.ascontiguousarray(arr, dtype)
    profiling.incr_counter("umap.h2d_transfers")
    profiling.incr_counter("umap.h2d_bytes", host.nbytes)
    return torch.from_numpy(host).to(device)


def _seed_word(seed: int) -> int:
    return int(np.int64(seed) & 0x7FFFFFFF)


def spectral_from_layout(tails_pad, w_pad, n_components: int, seed: int,
                         device: Optional[torch.device] = None) -> np.ndarray:
    """Spectral embedding (n, c) from a built padded head-grouped layout
    (host arrays or tensors), scaled to the 10-box."""
    dev = device if device is not None else _device.resolve()
    tails_dev = _h2d(tails_pad, np.int32, dev)
    w_dev = _h2d(w_pad, np.float32, dev)
    key = prng.prng_key(seed, dev)
    emb = _laplacian_eigenmap_kernel(tails_dev, w_dev, key, tails_dev.shape[0], c=int(n_components))
    return _spectral_scale_noise(emb, prng.fold_in(key, 0x5CA1E)).cpu().numpy()


def spectral_init(knn_ids: np.ndarray, W: np.ndarray, n_components: int, seed: int,
                  device: Optional[torch.device] = None) -> np.ndarray:
    """Spectral embedding of the fuzzy graph from the host: dedupe + layout
    + subspace iteration."""
    ii, jj, ww = dedupe_undirected(knn_ids, W)
    tails_pad, w_pad = padded_head_layout(ii, jj, ww, knn_ids.shape[0])
    return spectral_from_layout(tails_pad, w_pad, n_components, seed, device)


def _random_init(seed: int, n_pad: int, c: int, device: torch.device) -> torch.Tensor:
    """Uniform [-10, 10) start at the padded shape."""
    return prng.uniform(prng.prng_key(seed, device), (n_pad, c), -10.0, 10.0)


# -- layout --------------------------------------------------------------------


def _counter_uniform(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) from counter-mode threefry: element e's draw is
    word 0 of the hash of (counters[e], counters[e]), what the JAX package's
    threefry_2x32(key, counters ++ counters)[:size] returns, and a function
    of (key, counters[e]) alone."""
    k0, k1 = key[0], key[1]
    bits, _ = prng._hash(k0, k1, counters, counters)
    return (bits >> 8).float() * (1.0 / (1 << 24))


def _layout_grid(P: int, n_pad: int, device: torch.device, col0: int = 0,
                 n_loc: Optional[int] = None) -> torch.Tensor:
    """The threefry counters of the columns [col0, col0 + n_loc) (default:
    every column) of the (P, n_pad) grid, flat position p * n_pad + col;
    past 2^32 counters would alias and correlate distinct edges' draws."""
    if P * n_pad >= 1 << 32:
        raise ValueError(
            f"layout grid P*n_pad = {P}*{n_pad} exceeds the uint32 counter space of the "
            "seed-deterministic firing draws; lower degree_cap or shard the fit"
        )
    n_loc = n_pad - col0 if n_loc is None else n_loc
    return (torch.arange(P, dtype=torch.int64, device=device)[:, None] * n_pad
            + torch.arange(col0, col0 + n_loc, dtype=torch.int64, device=device)[None, :])


def _layout_epoch(emb, flat_tails_T, w_T, fire_u, neg, alpha, a, b, gamma, neg_rate, M, col0: int = 0):
    """One SGD epoch of the head-grouped layout for the heads [col0, col0 +
    n) (the shard's column block of the transposed layout, n = w_T's
    width) against the whole embedding: slot (p, h) fires where its uniform
    fire_u[p, h] < w_T[p, h]; neg is the epoch's shared negative table.
    Returns the block's new rows (n, c)."""
    P, n = w_T.shape
    c = emb.shape[1]
    comps = emb[col0 : col0 + n].T
    tT = emb[flat_tails_T].T.reshape(c, P, n)
    diffs = [comps[j][None, :] - tT[j] for j in range(c)]
    d2 = diffs[0] * diffs[0]
    for dj in diffs[1:]:
        d2 = d2 + dj * dj
    fire = fire_u < w_T
    # 2x attraction: umap-learn fires both directed copies of a pair and
    # moves both ends; the deduped layout fires each endpoint's slot once
    att = (-4.0 * a * b * pow_f32(d2, b - 1.0)) / fma_f32(a, pow_f32(d2, b), 1.0)
    att = torch.where(d2 > 0, att, 0.0) * fire
    # shared negative table, scaled by each node's expected negative count
    tblT = emb[neg].T
    diffs_n = [comps[j][None, :] - tblT[j][:, None] for j in range(c)]
    d2n = diffs_n[0] * diffs_n[0]
    for dj in diffs_n[1:]:
        d2n = d2n + dj * dj
    rep = (2.0 * gamma * b) / ((0.001 + d2n) * fma_f32(a, pow_f32(d2n, b), 1.0))
    scale = neg_rate * fire.sum(dim=0).to(emb.dtype) / M
    new_cols = []
    for cj, dj, dnj in zip(comps, diffs, diffs_n):
        upd = sum_dim0(torch.clamp(att * dj, -4.0, 4.0))
        g_rep = sum_dim0(torch.clamp(rep * dnj, -4.0, 4.0))
        new_cols.append(fma_f32(alpha, fma_f32(scale, g_rep, upd), cj))
    return torch.stack(new_cols, dim=1)


def _epoch_keys(seed: int, e0: int, block: int, device: torch.device) -> torch.Tensor:
    """split(fold_in(PRNGKey(seed), e)) for the block's epochs: (block, 2, 2)."""
    epochs = torch.arange(e0, e0 + block, dtype=torch.int64, device=device)
    return prng.split(prng.fold_in(prng.prng_key(seed, device), epochs))


def _epoch_draws(seed: int, e0: int, block: int, valid_count: int, table_size: int, lr: float,
                 epochs_total: float, device: torch.device):
    """The block's epoch keys (block, 2, 2), negative tables (block,
    table_size) and step sizes alpha (block,), drawn on `device`."""
    keys = _epoch_keys(seed, e0, block, device)
    negs = prng.randint(keys[:, 1], (table_size,), 0, max(int(valid_count), 1))
    e = torch.arange(e0, e0 + block, device=device).float()
    return keys, negs, _f32(lr, device) * (1.0 - e / _f32(epochs_total, device))


def _layout_step(
    emb: torch.Tensor,
    tails_T: torch.Tensor,
    w_T: torch.Tensor,
    e0: int,
    epochs_total: float,
    valid_count: int,
    a: float,
    b: float,
    lr: float,
    gamma: float,
    neg_rate: float,
    seed: int,
    block: int,
    table_size: int,
    counters: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`block` SGD epochs from epoch e0: the per-device body of the JAX
    package's _layout_step_sharded on one shard (col0 = 0)."""
    dev = emb.device
    P, n_pad = tails_T.shape
    if counters is None:
        counters = _layout_grid(P, n_pad, dev)
    flat_tails_T = tails_T.long().reshape(-1)
    keys, negs, alphas = _epoch_draws(seed, e0, block, valid_count, table_size, lr, epochs_total, dev)
    a_t, b_t, gamma_t, rate_t = (_f32(v, dev) for v in (a, b, gamma, neg_rate))
    for i in range(block):
        fire_u = _counter_uniform(keys[i, 0], counters)
        emb = _layout_epoch(emb, flat_tails_T, w_T, fire_u, negs[i], alphas[i],
                            a_t, b_t, gamma_t, rate_t, table_size)
    return emb


def optimize_layout(
    emb: torch.Tensor,
    tails_pad: torch.Tensor,
    w_pad: torch.Tensor,
    valid_count: int,
    a: float,
    b: float,
    n_epochs: int,
    learning_rate: float,
    repulsion_strength: float,
    negative_sample_rate: int,
    seed: int,
    table_size: int = NEG_TABLE,
    epoch_block: int = EPOCH_BLOCK,
) -> torch.Tensor:
    """The SGD layout on one device, the counterpart of the JAX
    package's optimize_layout_sharded: ceil(n_epochs / epoch_block) steps,
    each counted in umap.layout.dispatches.  The draws are those of any
    mesh of the JAX package that shares the padded geometry."""
    n_pad, P = tails_pad.shape
    counters = _layout_grid(P, n_pad, emb.device)
    tails_T = tails_pad.T.contiguous()
    w_T = w_pad.T.contiguous()
    block = max(1, int(epoch_block))
    for e0 in range(0, n_epochs, block):
        blk = min(block, n_epochs - e0)
        emb = _layout_step(
            emb, tails_T, w_T, e0, float(max(n_epochs, 1)), valid_count, a, b, learning_rate,
            repulsion_strength, float(negative_sample_rate), _seed_word(seed), blk, table_size, counters,
        )
        profiling.incr_counter("umap.layout.dispatches")
    return emb


def _layout_shards(tails_pad: torch.Tensor, w_pad: torch.Tensor, mesh: Mesh) -> list:
    """Each shard's (flat tails, weights, counter grid) of its column block
    of the transposed layout, on its device."""
    n_pad, P = tails_pad.shape
    n_dev = mesh.size
    if n_pad % n_dev:
        raise ValueError(f"{n_pad} padded rows do not split into {n_dev} column blocks")
    n_loc = n_pad // n_dev
    out = []
    for s, dev in enumerate(mesh.devices):
        cols = slice(s * n_loc, (s + 1) * n_loc)
        counters = _layout_grid(P, n_pad, dev, s * n_loc, n_loc)
        out.append((tails_pad.T[:, cols].to(dev).long().contiguous().reshape(-1),
                    w_pad.T[:, cols].to(dev).contiguous(), counters))
    return out


def _layout_step_sharded(
    embs: list,
    shards: list,
    mesh: Mesh,
    e0: int,
    epochs_total: float,
    valid_count: int,
    a: float,
    b: float,
    lr: float,
    gamma: float,
    neg_rate: float,
    seed: int,
    block: int,
    table_size: int,
) -> list:
    """`block` SGD epochs from epoch e0 over the mesh: the JAX package's
    _layout_step_sharded.  `embs` is the replicated embedding (one tensor a
    shard), `shards` _layout_shards' blocks; each epoch every shard updates
    its heads and one exchange.umap.layout_rows all-gather rebuilds the
    replicated embedding, which is returned."""
    n_loc = embs[0].shape[0] // mesh.size
    devs = set(mesh.devices)
    draws = {dev: _epoch_draws(seed, e0, block, valid_count, table_size, lr, epochs_total, dev) for dev in devs}
    scalars = {dev: tuple(_f32(v, dev) for v in (a, b, gamma, neg_rate)) for dev in devs}
    for i in range(block):
        new = []
        for s, (flat_tails, w_s, counters) in enumerate(shards):
            dev = mesh.devices[s]
            keys, negs, alphas = draws[dev]
            a_t, b_t, gamma_t, rate_t = scalars[dev]
            new.append(_layout_epoch(embs[s], flat_tails, w_s, _counter_uniform(keys[i, 0], counters), negs[i],
                                     alphas[i], a_t, b_t, gamma_t, rate_t, table_size, col0=s * n_loc))
        embs = allgather_rows(new, section="umap.layout_rows")
    return embs


def optimize_layout_sharded(
    emb: torch.Tensor,
    tails_pad: torch.Tensor,
    w_pad: torch.Tensor,
    valid_count: int,
    mesh: Mesh,
    a: float,
    b: float,
    n_epochs: int,
    learning_rate: float,
    repulsion_strength: float,
    negative_sample_rate: int,
    seed: int,
    table_size: int = NEG_TABLE,
    epoch_block: int = EPOCH_BLOCK,
) -> torch.Tensor:
    """The SGD layout over a mesh, the counterpart of the JAX package's
    optimize_layout_sharded (module header): shard s owns the head columns
    [s * n_loc, (s + 1) * n_loc) of the transposed layout, n_loc = n_pad /
    n_dev, and the replicated embedding; ceil(n_epochs / epoch_block) steps
    (_layout_step_sharded), each counted in umap.layout.dispatches.  Returns
    the embedding on shard 0's device, bit for bit optimize_layout's on the
    same device type."""
    shards = _layout_shards(tails_pad, w_pad, mesh)
    embs = replicate(emb, mesh.devices)
    block = max(1, int(epoch_block))
    for e0 in range(0, n_epochs, block):
        blk = min(block, n_epochs - e0)
        embs = _layout_step_sharded(
            embs, shards, mesh, e0, float(max(n_epochs, 1)), valid_count, a, b, learning_rate, repulsion_strength,
            float(negative_sample_rate), _seed_word(seed), blk, table_size,
        )
        profiling.incr_counter("umap.layout.dispatches")
    return embs[0]


def optimize_layout_padded(
    embedding: torch.Tensor,
    tails_pad: torch.Tensor,
    w_pad: torch.Tensor,
    a: float,
    b: float,
    n_epochs: int,
    learning_rate: float,
    repulsion_strength: float,
    negative_sample_rate: int,
    seed: int,
    table_size: int = NEG_TABLE,
) -> torch.Tensor:
    """Single-device REFERENCE layout (the JAX package's pre-sharding one):
    firing draws uniform(k1, (P, n)), negatives randint(k2, (M,), 0, n)."""
    dev = embedding.device
    n = embedding.shape[0]
    P = tails_pad.shape[1]
    flat_tails_T = tails_pad.long().T.reshape(-1)
    w_T = w_pad.T.contiguous()
    keys = _epoch_keys(_seed_word(seed), 0, n_epochs, dev)
    a_t, b_t, gamma_t, rate_t = (_f32(v, dev) for v in (a, b, repulsion_strength, negative_sample_rate))
    emb = embedding
    for e in range(n_epochs):
        alpha = _f32(learning_rate, dev) * (1.0 - _f32(e, dev) / n_epochs)
        fire_u = prng.uniform(keys[e, 0], (P, n))
        neg = prng.randint(keys[e, 1], (table_size,), 0, n)
        emb = _layout_epoch(emb, flat_tails_T, w_T, fire_u, neg, alpha, a_t, b_t, gamma_t, rate_t, table_size)
    return emb


# -- fit -----------------------------------------------------------------------


def _label_codes(y: np.ndarray) -> np.ndarray:
    """Categorical codes of the labels, -1 (unknown) for non-finite ones."""
    n = len(y)
    codes = np.full(n, -1, dtype=np.int32)
    finite = np.isfinite(np.asarray(y, dtype=np.float64))
    _, inv = np.unique(np.asarray(y)[finite], return_inverse=True)
    codes[finite] = inv.astype(np.int32)
    return codes


def umap_fit_embedding(
    knn_ids,
    knn_dists,
    n_components: int,
    a: float,
    b: float,
    n_epochs: Optional[int],
    learning_rate: float,
    init: str,
    set_op_mix_ratio: float,
    local_connectivity: float,
    repulsion_strength: float,
    negative_sample_rate: int,
    seed: int,
    y: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
    degree_cap: int = DEGREE_CAP,
    degree_quantile: float = DEGREE_QUANTILE,
    epoch_block: int = EPOCH_BLOCK,
    table_size: int = NEG_TABLE,
) -> np.ndarray:
    """The fit pipeline (graph + init + layout): the (n, k) kNN graph
    uploaded once (counted) to the mesh's first device, calibration, the
    layout assembly and the init drawn there; the SGD epochs there on one
    shard, column-sharded over the mesh (optimize_layout_sharded) on more;
    one fetch of the (n, c) embedding at the end.  With `y`, the supervised
    path intersects the fuzzy set with the label partition.  Rows are
    padded to padded_row_count(n, mesh)."""
    n = knn_ids.shape[0]
    dev = mesh.devices[0] if mesh is not None else _device.resolve()
    with profiling.phase("umap.graph", dev):
        ids_dev = _h2d(knn_ids, np.int32, dev)
        dists_dev = _h2d(knn_dists, np.float32, dev)
        W = _calibrated_weights(ids_dev, dists_dev, float(local_connectivity), float(set_op_mix_ratio))
        if y is not None:
            W = categorical_simplicial_set_intersection(W, ids_dev, _h2d(_label_codes(y), np.int32, dev))
        if n_epochs is None:
            n_epochs = 500 if n <= 10_000 else 200
        n_pad = padded_row_count(n, mesh)
        tails_pad, w_pad = build_head_layout_device(
            ids_dev, W, n_pad, int(n_epochs), degree_cap, degree_quantile
        )
        del W, dists_dev
    seed = _seed_word(seed)
    with profiling.phase("umap.init", dev):
        if init == "random":
            emb = _random_init(seed, n_pad, int(n_components), dev)
        else:
            key = prng.prng_key(seed, dev)
            emb = _spectral_scale_noise(
                _laplacian_eigenmap_kernel(tails_pad, w_pad, key, n, c=int(n_components)),
                prng.fold_in(key, 0x5CA1E),
            )
    with profiling.phase("umap.layout", dev):
        if mesh is not None and mesh.size > 1:
            out = optimize_layout_sharded(
                emb, tails_pad, w_pad, n, mesh, a, b, int(n_epochs), float(learning_rate),
                float(repulsion_strength), int(negative_sample_rate), seed, table_size, epoch_block,
            )
        else:
            out = optimize_layout(
                emb, tails_pad, w_pad, n, a, b, int(n_epochs), float(learning_rate),
                float(repulsion_strength), int(negative_sample_rate), seed, table_size, epoch_block,
            )
        return out[:n].cpu().numpy()


# -- transform -----------------------------------------------------------------


def _transform_prepare(ids_p, dists_p, train_emb, valid_count: int, local_connectivity: float):
    """Transform staging: calibration, membership weights, the
    weighted-neighbor-mean init and the wmax-normalized firing weights
    (padding rows zeroed so they never fire)."""
    bucket = ids_p.shape[0]
    rho, sigma = smooth_knn_calibration(dists_p, local_connectivity=local_connectivity)
    w = exp_f32(-torch.clamp(dists_p - rho[:, None], min=0.0) / sigma[:, None])
    row_valid = (torch.arange(bucket, device=w.device) < valid_count)[:, None]
    w = torch.where(row_valid, w, 0.0)
    wn = w / torch.clamp(sum_dim0(w.T)[:, None], min=1e-12)
    init = torch.einsum("nk,nkc->nc", wn, train_emb[ids_p.long()]).float()
    weights = (w / torch.clamp(w.max(), min=1e-12)).float()
    return init, weights


def _transform_epoch(emb, ref_emb, tails, weights, k1, k2, alpha, a, b, gamma, S):
    nr = ref_emb.shape[0]
    nq, k = tails.shape
    fire = prng.uniform(k1, (nq, k)) < weights
    diff = emb[:, None, :] - ref_emb[tails]
    d2 = (diff * diff).sum(dim=2)
    att = (-2.0 * a * b * pow_f32(d2, b - 1.0)) / (1.0 + a * pow_f32(d2, b))
    att = torch.where(d2 > 0, att, 0.0) * fire
    upd = sum_dim0(torch.clamp(att[:, :, None] * diff, -4.0, 4.0).transpose(0, 1))
    neg = prng.randint(k2, (nq, k, S), 0, nr)
    diff_n = emb[:, None, None, :] - ref_emb[neg]
    d2n = (diff_n * diff_n).sum(dim=3)
    rep = (2.0 * gamma * b) / ((0.001 + d2n) * (1.0 + a * pow_f32(d2n, b)))
    rep = rep * fire[:, :, None]
    g_rep = torch.clamp(rep[:, :, :, None] * diff_n, -4.0, 4.0)
    return emb + alpha * (upd + sum_dim0(g_rep.reshape(nq, k * S, -1).transpose(0, 1)))


def _transform_step(
    emb_q: torch.Tensor,
    ref_emb: torch.Tensor,
    tails: torch.Tensor,
    weights: torch.Tensor,
    e0: int,
    epochs_total: float,
    a: float,
    b: float,
    lr: float,
    gamma: float,
    seed: int,
    block: int,
    negative_sample_rate: int,
) -> torch.Tensor:
    """`block` refinement epochs of the transform from epoch e0: the query
    points attract to their k training neighbors and repel from S sampled
    training points an edge; only the queries move."""
    dev = emb_q.device
    keys = _epoch_keys(seed, e0, block, dev)
    a_t, b_t, lr_t, gamma_t = (_f32(v, dev) for v in (a, b, lr, gamma))
    e = torch.arange(e0, e0 + block, device=dev).float()
    alphas = lr_t * (1.0 - e / _f32(epochs_total, dev))
    tails = tails.long()
    for i in range(block):
        emb_q = _transform_epoch(emb_q, ref_emb, tails, weights, keys[i, 0], keys[i, 1], alphas[i],
                                 a_t, b_t, gamma_t, int(negative_sample_rate))
    return emb_q


def umap_transform_embedding(
    query_knn_ids: np.ndarray,
    query_knn_dists: np.ndarray,
    train_embedding: np.ndarray,
    local_connectivity: float,
    a: Optional[float] = None,
    b: Optional[float] = None,
    n_epochs: Optional[int] = None,
    learning_rate: float = 1.0,
    repulsion_strength: float = 1.0,
    negative_sample_rate: int = 5,
    seed: int = 42,
    train_embedding_dev: Optional[torch.Tensor] = None,
    epoch_block: int = EPOCH_BLOCK,
) -> np.ndarray:
    """Embed new points: the membership-weighted mean of their training
    neighbors' embeddings, then (when a and b are given) n_epochs // 3
    refinement epochs, or 100 / 30 by training size, against the frozen
    training embedding.  The query count is padded to the power-of-two
    bucket (at least 64) the JAX package draws at, so the draws match."""
    from ..ann.ivfflat import shape_bucket

    nq, k = query_knn_ids.shape
    if nq == 0:
        return np.zeros((0, train_embedding.shape[1]), np.float32)
    dev = train_embedding_dev.device if train_embedding_dev is not None else _device.resolve()
    with profiling.phase("umap.transform", dev):
        bucket = shape_bucket(nq, lo=64)
        pad = bucket - nq
        ids_dev = _h2d(np.pad(np.asarray(query_knn_ids), ((0, pad), (0, 0))), np.int32, dev)
        dists_dev = _h2d(np.pad(np.asarray(query_knn_dists), ((0, pad), (0, 0))), np.float32, dev)
        if train_embedding_dev is None:
            train_embedding_dev = _h2d(train_embedding, np.float32, dev)
        emb_q, weights = _transform_prepare(ids_dev, dists_dev, train_embedding_dev, nq, float(local_connectivity))
        if a is None or b is None:
            return emb_q[:nq].cpu().numpy()
        if n_epochs is None:
            n_epochs = 100 if train_embedding.shape[0] <= 10_000 else 30
        else:
            n_epochs = max(int(n_epochs) // 3, 1)
        block = max(1, int(epoch_block))
        for e0 in range(0, n_epochs, block):
            blk = min(block, n_epochs - e0)
            emb_q = _transform_step(
                emb_q, train_embedding_dev, ids_dev, weights, e0, float(max(n_epochs, 1)), a, b,
                learning_rate, repulsion_strength, _seed_word(seed), blk, int(negative_sample_rate),
            )
            profiling.incr_counter("umap.transform.dispatches")
        return emb_q[:nq].cpu().numpy()
