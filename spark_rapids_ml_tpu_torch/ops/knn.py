#
# Exact brute-force k-nearest-neighbours on one device.
#
# Counterpart of spark_rapids_ml_tpu/ops/knn.py for one device.  Two routes
# serve a query block against a prepared (device-resident) item set:
#
#   kernel route  B5 (knn_kernels.knn_candidates: per group of 1024 items the
#                 top m candidates) -> B7 (knn_kernels.knn_fused_merge: the
#                 lexicographic top k of that pool, sqrt distances and a
#                 per-row overflow flag).  A row whose flag fires (some group
#                 may have held more than m of its top k) is re-run once
#                 through the exact route.  Taken whenever m <= _ADAPTIVE_MAX_M,
#                 on the card and on the CPU alike (there with the kernels'
#                 plain versions).  A wide pool (many groups) only shortens
#                 the query block, so one block's pool stays under
#                 _BLOCK_BYTES.
#   exact route   knn_block_exact: torch.matmul per item chunk (fp32, TF32
#                 off) and lex_topk, a running merge.  Serves flagged rows
#                 and every shape the kernel route does not take.
#
# audit=True (knn_search_prepared) runs the JAX package's audit pairing
# instead: B6 (the same pool kernel, counted apart) -> B7, then B8 counts
# every item better than the margined threshold; rows where that count
# differs from the merged list's are re-run too, and the agreement of the
# flag with the count is recorded in knn_search_prepared's counters.
#
# Both routes order candidates by the lexicographic (d2, position) key, a
# total order.  Items are shuffled once at prepare time by the same
# np.random.default_rng(0x5EED) permutation as the JAX package, so positions
# mean the same rows in both packages; user ids stay int64 on the host.
#
# What does not carry over: the ring / all-gather exchange routes (one
# device), the pow2 query-block buckets and the AOT executable cache (XLA
# compile caching), the Pallas tile alignment of prepare_items (a TPU VMEM
# concern), the TPU eligibility cuts, and the 8 GB in-core budget ("half of
# a v5e's HBM").  The budget here is what the device can still allocate,
# less the search's own working set (_item_budget_bytes): an item set within
# it stays resident, a larger one visits the device one block at a time.
#

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as _device
from ..utils import chunk_iter
from . import knn_kernels
from .nearest_center import squared_norms

# lexicographic-(d2, pos) padding sentinel: sorts after every genuine
# candidate (inf distance, max int32 position)
LEX_POS_SENTINEL = np.iinfo(np.int32).max

_GROUP_WIDTH = knn_kernels.GROUP
# per-group candidate cap of the kernel route (the pool kernel keeps at most
# this many); shapes whose _select_m bound exceeds it take the exact route
_ADAPTIVE_MAX_M = knn_kernels.MAX_M
# exact route: bytes of the (Q, chunk) distance tile per item chunk
_TILE_BUDGET = 128 << 20
# query blocks in flight beyond the one being collected
_PIPELINE_WINDOW = 2
# device bytes of one query block on the kernel route (its queries,
# candidate pool and merged results); a wide pool shortens the block
_BLOCK_BYTES = 1 << 30
# device bytes the search holds beside the staged items: the query blocks in
# flight, and the exact route's distance tile with its sort temporaries
# (knn_block_exact keeps up to ~12 tiles live while it sorts)
_SEARCH_RESERVE = (_PIPELINE_WINDOW + 1) * _BLOCK_BYTES + 12 * _TILE_BUDGET
# device bytes per staged item beside its features: the norm, the kernels'
# masked copy of it, the valid flag
_ROW_OVERHEAD = 9
# share of the allocatable device memory the budget plans with; the rest
# absorbs the caching allocator's fragmentation
_USABLE_SHARE = 0.9
# source rows copied to the device at once while staging
_STAGE_CHUNK_BYTES = 256 << 20


def lex_topk(
    d2: torch.Tensor, pos: torch.Tensor, k: int, sentinel: int = LEX_POS_SENTINEL
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest k candidates of every row by the lexicographic (d2, pos)
    key, ascending: the columns are put in position order, then stable-sorted
    on d2.  Positions are unique among valid candidates, so the key is a
    total order and the result does not depend on how the candidates were
    split or concatenated.  Rows with fewer than k columns are padded with
    (inf, sentinel)."""
    pos_sorted, by_pos = torch.sort(pos, dim=1, stable=True)
    sd, order = torch.sort(d2.gather(1, by_pos), dim=1, stable=True)
    kk = min(k, d2.shape[1])
    sd, sp = sd[:, :kk], pos_sorted.gather(1, order[:, :kk])
    if kk < k:
        sd = torch.nn.functional.pad(sd, (0, k - kk), value=float("inf"))
        sp = torch.nn.functional.pad(sp, (0, k - kk), value=sentinel)
    return sd, sp


def _select_m(k: int, G: int, n_loc: int) -> int:
    """Per-group candidate count: mean + 6 sigma of the Binomial(k, G/n_loc)
    occupancy of one group (a safe envelope of the post-shuffle
    hypergeometric), +4 slack."""
    lam = k * G / max(n_loc, 1)
    return max(4, int(np.ceil(lam + 6.0 * np.sqrt(lam) + 4.0)))


def _scan_geometry(k: int, n_loc: int) -> Tuple[int, int]:
    """(G, m) of the candidate pool: groups of _GROUP_WIDTH items, m from
    _select_m."""
    return _GROUP_WIDTH, _select_m(k, _GROUP_WIDTH, n_loc)


def _kernel_route(k: int, n: int) -> Tuple[bool, int]:
    """(whether the kernel route serves k neighbours among n items, its m)."""
    m = _scan_geometry(k, n)[1]
    return m <= _ADAPTIVE_MAX_M, m


def _block_rows(query_block: int, n_cols: int, pool: int, k: int) -> int:
    """Queries per kernel-route block: query_block, fewer where one block's
    queries, pool (pool candidates a query) and results would pass
    _BLOCK_BYTES."""
    per_query = 4 * n_cols + 8 * pool + 8 * k + 16
    return max(1, min(query_block, _BLOCK_BYTES // per_query))


def _pad_topk_to_k(d: np.ndarray, i: np.ndarray, k: int):
    """Pad a candidate list out to k columns (a block smaller than k returns
    fewer) so running merges always keep k candidates."""
    if d.shape[1] >= k:
        return d[:, :k], i[:, :k]
    pad = k - d.shape[1]
    return (
        np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf),
        np.pad(i, ((0, 0), (0, pad)), constant_values=-1),
    )


def topk_merge(da: np.ndarray, ia: np.ndarray, db: np.ndarray, ib: np.ndarray):
    """Merge two per-row sorted (n, k) candidate lists into the best k: a
    stable argsort of the concatenation (the JAX package's numpy fallback of
    native.topk_merge)."""
    alld = np.concatenate([np.asarray(da, np.float32), np.asarray(db, np.float32)], axis=1)
    alli = np.concatenate([np.asarray(ia, np.int64), np.asarray(ib, np.int64)], axis=1)
    order = np.argsort(alld, axis=1, kind="stable")[:, : da.shape[1]]
    return np.take_along_axis(alld, order, axis=1), np.take_along_axis(alli, order, axis=1)


# ---------------------------------------------------------------------------
# Prepared (device-resident) item sets
# ---------------------------------------------------------------------------


class PreparedItems:
    """Item set on the device with its cached ||x||^2, reusable across many
    knn_search_prepared calls.  Positions are row numbers of `items`; user
    ids stay on the host in full int64 precision."""

    __slots__ = ("items", "norm", "valid", "ids", "n_items")

    def __init__(self, items: torch.Tensor, norm: torch.Tensor, valid: torch.Tensor, ids: np.ndarray,
                 n_items: int):
        self.items = items      # (n, D) float32
        self.norm = norm        # (n,) float32
        self.valid = valid      # (n,) bool: False marks rows that are not items
        self.ids = ids          # (n,) int64 host array, -1 where not valid
        self.n_items = n_items  # count of valid items


def prepare_items(
    items,
    item_ids: np.ndarray,
    device: Optional[torch.device] = None,
    shuffle: bool = True,
) -> PreparedItems:
    """Stage `items` (a numpy array, a tensor, or a sequence of numpy row
    blocks) on `device` (default: the entry points' device) as one tensor
    whose rows are shuffled by the JAX package's permutation: the candidate
    bound of the kernel route (_select_m) models group occupancy as uniform
    sampling, which a sorted or clustered order would break.  Source rows go
    up in chunks of _STAGE_CHUNK_BYTES as they lie and are scattered on the
    device into their shuffled rows, so the device holds the items once plus
    one chunk.  Ids travel with their rows."""
    dev = device if device is not None else _device.resolve()
    blocks = [items] if isinstance(items, (np.ndarray, torch.Tensor)) else list(items)
    n_items = sum(int(b.shape[0]) for b in blocks)
    ids = np.asarray(item_ids, np.int64)
    if ids.shape != (n_items,):
        raise ValueError(f"{ids.shape[0]} ids for {n_items} items")
    n_cols = int(blocks[0].shape[1])
    X = torch.empty((n_items, n_cols), dtype=torch.float32, device=dev)
    dest = None  # the shuffled row of each source row
    if shuffle and n_items > 1:
        perm = np.random.default_rng(0x5EED).permutation(n_items)
        ids = ids[perm]
        dest = np.empty(n_items, np.int64)
        dest[perm] = np.arange(n_items)
    else:
        ids = ids.copy()
    chunk_rows = max(1, _STAGE_CHUNK_BYTES // (4 * max(n_cols, 1)))
    at = 0
    for b in blocks:
        for sl in chunk_iter(int(b.shape[0]), chunk_rows):
            src = b[sl]
            if isinstance(src, torch.Tensor):
                chunk = src.to(device=dev, dtype=torch.float32)
            else:
                chunk = torch.from_numpy(np.ascontiguousarray(src, np.float32)).to(dev)
            lo, hi = at + sl.start, at + sl.stop
            if dest is None:
                X[lo:hi].copy_(chunk)
            else:
                X.index_copy_(0, torch.from_numpy(dest[lo:hi]).to(dev), chunk)
            del chunk
        at += int(b.shape[0])
    return PreparedItems(X, squared_norms(X), torch.ones(n_items, dtype=torch.bool, device=dev), ids, n_items)


def _item_budget_bytes(dev: torch.device) -> int:
    """Bytes a staged item set (features, norms, flags) may take on `dev`:
    what the card can still allocate (free memory plus the caching
    allocator's unused blocks) times _USABLE_SHARE, less the search's
    working set _SEARCH_RESERVE.  On the CPU, half of the host's memory."""
    if dev.type != "cuda":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2
    free = torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return max(0, int(_USABLE_SHARE * free) - _SEARCH_RESERVE)


def _item_block_rows(n_cols: int, dev: torch.device) -> int:
    """Items of n_cols features that one staged block may hold under the
    item budget."""
    return max(1, _item_budget_bytes(dev) // (4 * n_cols + _ROW_OVERHEAD))


# ---------------------------------------------------------------------------
# The two routes for one query block
# ---------------------------------------------------------------------------


def knn_block_exact(
    prepared: PreparedItems, queries: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest items of each query row: (distances (Q, k) ascending
    euclidean, positions (Q, k) int32).  Item chunks keep the (Q, chunk)
    distance tile under _TILE_BUDGET bytes; each chunk's lex top k merges
    into a running (Q, k).  Slots past the valid items hold (inf,
    LEX_POS_SENTINEL)."""
    items, n = prepared.items, prepared.items.shape[0]
    Q = queries.shape[0]
    chunk = min(n, max(512, _TILE_BUDGET // max(4 * Q, 1)))
    qn = squared_norms(queries)
    inorm = torch.where(prepared.valid, prepared.norm, torch.full_like(prepared.norm, float("inf")))
    best_d = best_p = None
    for sl in chunk_iter(n, chunk):
        d2 = (qn[:, None] - 2.0 * (queries @ items[sl].T)) + inorm[None, sl]
        pos = torch.arange(sl.start, sl.stop, dtype=torch.int32, device=items.device).expand(Q, -1)
        cd, cp = lex_topk(d2, pos, k)
        if best_d is not None:
            cd, cp = lex_topk(torch.cat([best_d, cd], 1), torch.cat([best_p, cp], 1), k)
        best_d, best_p = cd, cp
    return knn_kernels.sqrt_clamped(best_d), best_p


def _kernel_block(prepared: PreparedItems, queries: torch.Tensor, k: int, m: int, audit: bool):
    """The kernel route for one block: [dist, positions, flags] and, on the
    audit route, the rows whose count check failed.  Device tensors, not
    synchronised."""
    p = prepared
    pool = knn_kernels.knn_candidates_audit if audit else knn_kernels.knn_candidates
    vals, pos = pool(p.items, p.norm, p.valid, queries, m)
    dist, fpos, flags, thresh, above = knn_kernels.knn_fused_merge(vals, pos, k)
    if not audit:
        return [dist, fpos, flags]
    return [dist, fpos, flags, knn_kernels.knn_count(p.items, p.norm, p.valid, queries, thresh) != above]


def _run_block_pipeline(n_blocks: int, dispatch: Callable[[int], None], collect: Callable[[int], None],
                        window: int) -> None:
    """dispatch(b) / collect(b) over n_blocks query blocks, keeping at most
    window + 1 blocks in flight: block b + 1 .. b + window compute on the
    device while block b's results come back to the host."""
    done = 0
    for bi in range(n_blocks):
        with record_function("knn.dispatch"):
            dispatch(bi)
        if bi - done >= window:
            with record_function("knn.collect"):
                collect(done)
            done += 1
    while done < n_blocks:
        with record_function("knn.collect"):
            collect(done)
        done += 1


def _to_host(tensors: Sequence[torch.Tensor]):
    """Start copies of `tensors` to host memory; returns (host tensors, an
    event to wait on, or None when they are already on the host)."""
    if tensors[0].device.type == "cpu":
        return list(tensors), None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _ids_of(prepared: PreparedItems, dist: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """User ids of device positions; -1 where the distance is inf (slots past
    the valid items)."""
    unfilled = ~np.isfinite(dist)
    ids = prepared.ids[np.where(unfilled, 0, pos)]
    ids[unfilled] = -1
    return ids


def knn_search_prepared(
    prepared: PreparedItems,
    queries,
    k: int,
    query_block: int = 8192,
    audit: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """k nearest items of every query row: host (distances (Q, k_eff)
    float32 ascending euclidean, ids (Q, k_eff) int64), k_eff = min(k,
    n_items).  `queries` is a host array or a tensor already on the items'
    device (repeat kneighbors calls cache their query uploads).  Query blocks
    run through a dispatch/collect window; flagged rows are re-run through
    the exact route at the end.  audit=True takes the audit route (module
    header) and adds to the counters below.  On the kernel route a block
    holds query_block queries, fewer where the pool is wide
    (_block_rows)."""
    dev = prepared.items.device
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=dev, dtype=torch.float32)
    else:
        q = np.asarray(queries, np.float32)
    k_eff = min(k, prepared.n_items)
    Q = q.shape[0]
    if Q == 0:
        return np.zeros((0, k_eff), np.float32), np.zeros((0, k_eff), np.int64)
    n = prepared.items.shape[0]
    kernel_route, m = _kernel_route(k, n)
    if kernel_route:
        query_block = _block_rows(query_block, prepared.items.shape[1], -(-n // _GROUP_WIDTH) * m, k)
    starts = list(range(0, Q, query_block))

    def block(bi):
        qb = q[starts[bi] : starts[bi] + query_block]
        if isinstance(qb, np.ndarray):
            qb = torch.from_numpy(np.ascontiguousarray(qb)).to(dev)
        return qb.contiguous()

    pending: deque = deque()
    out_d: List[np.ndarray] = []
    out_i: List[np.ndarray] = []
    rerun: List[np.ndarray] = []

    def dispatch(bi):
        if kernel_route:
            pending.append(_to_host(_kernel_block(prepared, block(bi), k, m, audit)))
        else:
            pending.append(_to_host(knn_block_exact(prepared, block(bi), k)))

    def collect(bi):
        host, event = pending.popleft()
        if event is not None:
            event.synchronize()
        dist, pos = host[0].numpy(), host[1].numpy()
        out_d.append(dist)
        out_i.append(_ids_of(prepared, dist, pos))
        if kernel_route:
            flagged = host[2].numpy() != 0
            failed = host[3].numpy() if audit else np.zeros_like(flagged)
            rows = np.flatnonzero(flagged | failed)
            if rows.size:
                rerun.append(starts[bi] + rows)
            search = knn_search_prepared
            search.flagged_rows += int(flagged.sum())
            search.count_failed_rows += int(failed.sum())
            search.count_failed_unflagged_rows += int((failed & ~flagged).sum())

    _run_block_pipeline(len(starts), dispatch, collect, _PIPELINE_WINDOW)
    d_all, i_all = np.concatenate(out_d), np.concatenate(out_i)
    if rerun:
        with record_function("knn.fallback"):
            rows = np.concatenate(rerun)
            qf = q[torch.from_numpy(rows).to(dev)] if isinstance(q, torch.Tensor) else torch.from_numpy(q[rows]).to(dev)
            d_f, p_f = knn_block_exact(prepared, qf.contiguous(), k)
            d_f, p_f = d_f.cpu().numpy(), p_f.cpu().numpy()
            d_all[rows] = d_f
            i_all[rows] = _ids_of(prepared, d_f, p_f)
            knn_search_prepared.rerun_rows += int(rows.size)
    return d_all[:, :k_eff], i_all[:, :k_eff]


# rows the kernel route flagged, rows re-run through the exact route, and
# (audit route) rows whose count check failed, and those of them the flag
# missed: running totals a caller resets and reads
knn_search_prepared.flagged_rows = 0
knn_search_prepared.rerun_rows = 0
knn_search_prepared.count_failed_rows = 0
knn_search_prepared.count_failed_unflagged_rows = 0


# ---------------------------------------------------------------------------
# Item sets beyond the budget: streamed item blocks, host merges
# ---------------------------------------------------------------------------


def knn_search(
    items: np.ndarray,
    item_ids: np.ndarray,
    queries: np.ndarray,
    k: int,
    query_block: int = 8192,
    device: Optional[torch.device] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN of `queries` over host `items`: staged once when they fit
    one item block under the budget, else streamed (knn_search_out_of_core)."""
    dev = device if device is not None else _device.resolve()
    items = np.asarray(items, np.float32)
    block_rows = _item_block_rows(items.shape[1], dev)
    if items.shape[0] <= block_rows:
        return knn_search_prepared(prepare_items(items, item_ids, dev), queries, k, query_block)
    return knn_search_out_of_core(items, item_ids, queries, k, block_rows, query_block, dev)


def knn_search_out_of_core(
    items: np.ndarray,
    item_ids: np.ndarray,
    queries: np.ndarray,
    k: int,
    item_block: int,
    query_block: int = 8192,
    device: Optional[torch.device] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN with the items visiting the device in blocks of item_block
    rows: knn_search_streamed over one query part."""
    blocks = iter_prepared_item_blocks([(items, item_ids)], device, block_rows=item_block)
    return knn_search_streamed(blocks, lambda p: queries, [len(queries)], k, query_block)[0]


def iter_prepared_item_blocks(part_iter: Iterable[Tuple[np.ndarray, np.ndarray]],
                              device: Optional[torch.device] = None,
                              block_rows: Optional[int] = None):
    """Pack a stream of (features, ids) partition chunks into prepared item
    blocks of block_rows rows (default: what the item budget allows at the
    first chunk's width, taken once), the last one shorter.  The host holds
    only the incoming partitions of one block.  The consumer drops each block
    before it asks for the next, so the device holds one block at a time."""
    dev = device if device is not None else _device.resolve()
    buf_f: list = []
    buf_i: list = []
    rows = 0

    def flush():
        nonlocal rows
        prepared = prepare_items(list(buf_f), np.concatenate(buf_i), dev)
        buf_f.clear()
        buf_i.clear()
        rows = 0
        return prepared

    for feats, ids in part_iter:
        feats = np.asarray(feats, np.float32)
        if feats.shape[0] == 0:
            continue
        if block_rows is None:
            block_rows = _item_block_rows(feats.shape[1], dev)
        ids = np.asarray(ids, np.int64)
        at = 0
        while at < feats.shape[0]:
            take = min(block_rows - rows, feats.shape[0] - at)
            buf_f.append(feats[at : at + take])
            buf_i.append(ids[at : at + take])
            rows += take
            at += take
            if rows == block_rows:
                yield flush()
    if buf_f:
        yield flush()


def knn_search_streamed(
    item_block_iter: Iterable[PreparedItems],
    query_feats_fn: Callable[[int], np.ndarray],
    query_rows: Sequence[int],
    k: int,
    query_block: int = 8192,
):
    """Exact kNN with both sides streamed: item blocks visit the device once
    (outer loop); each query partition's features come from
    query_feats_fn(p) (inner loop) and its running best k merges on the
    host.  Returns per-query-partition (dists, ids) trimmed to min(k, total
    items)."""
    n_parts = len(query_rows)
    if n_parts == 0 or not any(r > 0 for r in query_rows):
        return [(np.zeros((r, 0), np.float32), np.zeros((r, 0), np.int64)) for r in query_rows]
    best: list = [None] * n_parts
    total_items = 0
    for prepared in item_block_iter:
        total_items += prepared.n_items
        for p in range(n_parts):
            if query_rows[p] == 0:
                continue
            d, i = _pad_topk_to_k(*knn_search_prepared(prepared, query_feats_fn(p), k, query_block), k)
            best[p] = (d, i) if best[p] is None else topk_merge(best[p][0], best[p][1], d, i)
        del prepared  # the block leaves the device before the next is staged
    k_eff = min(k, total_items) if total_items else 0
    out = []
    for p in range(n_parts):
        if best[p] is None:
            out.append((np.zeros((query_rows[p], k_eff), np.float32), np.zeros((query_rows[p], k_eff), np.int64)))
        else:
            out.append((best[p][0][:, :k_eff], best[p][1][:, :k_eff]))
    return out
