#
# Exact brute-force k-nearest-neighbours, on one device or a mesh.
#
# Counterpart of spark_rapids_ml_tpu/ops/knn.py.  Two routes serve a query
# block against a prepared (device-resident) item set:
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
#   exact route   one shard: knn_block_exact, torch.matmul per item chunk
#                 (fp32, TF32 off) and lex_topk, a running merge.  A mesh: the
#                 candidate exchange (knn_block_kernel_exchange, below).
#                 Serves flagged rows and every shape the kernel route does
#                 not take.
#
# On a mesh (parallel/mesh.py: one process drives every shard, shard i on the
# mesh's i-th device) the items are row-sharded at prepare time; the kernel
# route launches B5 once per shard (m from the shard's rows), gathers the
# shards' pools (the knn.cand_pool section) and runs B7 on shard 0's device.
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
# What does not carry over: the legacy all-gather block kernel (the
# pre-exchange mesh schedule), the AOT executable cache (XLA compile
# caching), the Pallas tile alignment of prepare_items (a TPU VMEM concern),
# the TPU eligibility cuts, and the 8 GB in-core budget ("half of a v5e's
# HBM").  The budget here is what the device can still allocate, less the
# search's own working set (_item_budget_bytes): an item set within it stays
# resident, a larger one visits the device one block at a time.  Of the pow2
# query-block buckets only the exchange's padding stays (_exchange_rows).  The
# environment switches of the exchange are arguments with the JAX defaults:
# SRML_KNN_EXCHANGE is _exact_block_search's `exchange`, SRML_KNN_RING_CHUNK
# _exchange_geometry's `ring_chunk`, the topology overrides
# topology.topology_map's `devs_per_host` / `pin_flat`; the search itself
# runs the defaults.
#

from __future__ import annotations

import contextlib
import math
import os
from collections import Counter, deque
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from .. import profiling
from ..parallel import topology
from ..parallel.exchange import device_collective, psum_parts
from ..parallel.mesh import Mesh, as_mesh
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
# the exchange scans' caps: item rows of a chunk, query rows of a sub-tile
# (the JAX package's defaults)
_RING_CHUNK = 16384
_RING_QT = 64


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


class ItemShard(NamedTuple):
    """One shard of a prepared item set, on the shard's device."""

    items: torch.Tensor  # (n_loc, D) float32
    norm: torch.Tensor   # (n_loc,) float32
    valid: torch.Tensor  # (n_loc,) bool: False marks rows that are not items
    base: int            # global position of the shard's first row


class PreparedItems:
    """Item set on the device (or row-sharded over a mesh) with its cached
    ||x||^2, reusable across many knn_search_prepared calls.  Positions are
    global row numbers: shard i holds positions base .. base + n_loc - 1.
    User ids stay on the host in full int64 precision."""

    __slots__ = ("shards", "ids", "n_items", "mesh")

    def __init__(self, shards: Sequence[ItemShard], ids: np.ndarray, n_items: int, mesh: Mesh):
        self.shards = tuple(shards)
        self.ids = ids          # (n_rows,) int64 host array, -1 where not valid
        self.n_items = n_items  # count of valid items
        self.mesh = mesh

    def _only(self) -> ItemShard:
        if len(self.shards) != 1:
            raise ValueError(f"the item set is sharded {len(self.shards)} ways; read its shards")
        return self.shards[0]

    @property
    def items(self) -> torch.Tensor:
        """(n, D) float32 of a one-shard set."""
        return self._only().items

    @property
    def norm(self) -> torch.Tensor:
        return self._only().norm

    @property
    def valid(self) -> torch.Tensor:
        return self._only().valid

    @property
    def n_rows(self) -> int:
        """Rows over all shards, padding included."""
        return sum(int(sh.items.shape[0]) for sh in self.shards)

    @property
    def n_cols(self) -> int:
        return int(self.shards[0].items.shape[1])


def prepare_items(
    items,
    item_ids: np.ndarray,
    device: Union[torch.device, str, Mesh, None] = None,
    shuffle: bool = True,
) -> PreparedItems:
    """Stage `items` (a numpy array, a tensor, or a sequence of numpy row
    blocks) on `device` (default: the entry points' device), or row-sharded
    over a parallel.mesh.Mesh: rows padded to a multiple of the shard count
    (padding rows invalid, id -1), shard i holding the i-th contiguous run of
    rows on mesh.devices[i].  Rows are shuffled by the JAX package's
    permutation: the candidate bound of the kernel route (_select_m) models
    group occupancy as uniform sampling, which a sorted or clustered order
    would break.  Source rows go up in chunks of _STAGE_CHUNK_BYTES as they
    lie and are scattered on the device into their shuffled rows, so the
    devices hold the items once plus one chunk.  Ids travel with their
    rows."""
    mesh = as_mesh(device)
    n_dev = mesh.size
    blocks = [items] if isinstance(items, (np.ndarray, torch.Tensor)) else list(items)
    n_items = sum(int(b.shape[0]) for b in blocks)
    ids = np.asarray(item_ids, np.int64)
    if ids.shape != (n_items,):
        raise ValueError(f"{ids.shape[0]} ids for {n_items} items")
    n_cols = int(blocks[0].shape[1])
    n_loc = -(-n_items // n_dev)
    shard_x = [torch.empty((n_loc, n_cols), dtype=torch.float32, device=d) for d in mesh.devices]
    dest = np.arange(n_items)  # the shuffled row of each source row
    if shuffle and n_items > 1:
        perm = np.random.default_rng(0x5EED).permutation(n_items)
        ids = ids[perm]
        dest[perm] = np.arange(n_items)
    else:
        ids = ids.copy()
    chunk_rows = max(1, _STAGE_CHUNK_BYTES // (4 * max(n_cols, 1)))
    at = 0
    for b in blocks:
        for sl in chunk_iter(int(b.shape[0]), chunk_rows):
            _stage_chunk(b[sl], dest[at + sl.start : at + sl.stop], shard_x, n_loc)
        at += int(b.shape[0])
    ids_pad = np.full(n_loc * n_dev, -1, np.int64)
    ids_pad[:n_items] = ids
    shards = []
    for i, X in enumerate(shard_x):
        n_valid = min(max(n_items - i * n_loc, 0), n_loc)
        X[n_valid:] = 0.0
        valid = torch.zeros(n_loc, dtype=torch.bool, device=X.device)
        valid[:n_valid] = True
        shards.append(ItemShard(X, squared_norms(X), valid, i * n_loc))
    return PreparedItems(shards, ids_pad, n_items, mesh)


def _stage_chunk(src, dest: np.ndarray, shard_x: List[torch.Tensor], n_loc: int) -> None:
    """Scatter one chunk of source rows into their rows `dest` of the
    shards.  The chunk goes up once per device."""
    on_device: Dict[torch.device, torch.Tensor] = {}
    shard_of = dest // n_loc
    for i, X in enumerate(shard_x):
        rows = np.flatnonzero(shard_of == i)
        if rows.size == 0:
            continue
        if X.device not in on_device:
            if isinstance(src, torch.Tensor):
                on_device[X.device] = src.to(device=X.device, dtype=torch.float32)
            else:
                on_device[X.device] = torch.from_numpy(np.ascontiguousarray(src, np.float32)).to(X.device)
        chunk = on_device[X.device]
        if rows.size < chunk.shape[0]:
            chunk = chunk[torch.from_numpy(rows).to(X.device)]
        X.index_copy_(0, torch.from_numpy(dest[rows] - i * n_loc).to(X.device), chunk)
    on_device.clear()


def _item_budget_bytes(dev: torch.device) -> int:
    """Bytes a staged item set (features, norms, flags) may take on `dev`:
    what the card can still allocate (free memory plus the caching
    allocator's unused blocks) times _USABLE_SHARE, less the search's
    working set _SEARCH_RESERVE.  On the CPU, half of the host's memory."""
    if dev.type != "cuda":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2
    free = torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return max(0, int(_USABLE_SHARE * free) - _SEARCH_RESERVE)


def _item_block_rows(n_cols: int, device: Union[torch.device, Mesh]) -> int:
    """Items of n_cols features that one staged block may hold under the
    item budget, a multiple of the shard count: every device's budget is
    split among the shards it holds, and the tightest device sets the rows
    of every shard."""
    mesh = as_mesh(device)
    per_row = 4 * n_cols + _ROW_OVERHEAD
    held = Counter(mesh.devices)
    per_shard = min(_item_budget_bytes(dev) // (count * per_row) for dev, count in held.items())
    return max(1, per_shard) * mesh.size


# ---------------------------------------------------------------------------
# The two routes for one query block
# ---------------------------------------------------------------------------


def knn_block_exact(
    prepared: PreparedItems, queries: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest items of each query row over a one-shard set:
    (distances (Q, k) ascending euclidean, positions (Q, k) int32).  Item
    chunks keep the (Q, chunk) distance tile under _TILE_BUDGET bytes; each
    chunk's lex top k merges into a running (Q, k).  Slots past the valid
    items hold (inf, LEX_POS_SENTINEL)."""
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


def _device_of(t: torch.Tensor):
    """A context in which `t`'s card is the current CUDA device (the kernels
    launch on the current device's context), or nothing for a CPU tensor."""
    return torch.cuda.device(t.device) if t.device.type == "cuda" else contextlib.nullcontext()


def _kernel_block(prepared: PreparedItems, queries: torch.Tensor, k: int, m: int, audit: bool):
    """The kernel route for one block: [dist, positions, flags] and, on the
    audit route, the rows whose count check failed.  On a mesh B5 (or B6)
    runs once per shard, the pools are gathered onto shard 0's device
    (knn.cand_pool) in shard order, and B7 merges them there.  Device
    tensors, not synchronised."""
    pool = knn_kernels.knn_candidates_audit if audit else knn_kernels.knn_candidates
    shards = prepared.shards
    on_shard = [queries.to(sh.items.device) for sh in shards]
    vals, pos = [], []
    for sh, q in zip(shards, on_shard):
        with _device_of(q):
            v, p = pool(sh.items, sh.norm, sh.valid, q, m)
            vals.append(v)
            pos.append(p + sh.base if sh.base else p)
    if len(shards) > 1:
        sec = device_collective("knn.cand_pool")
        Q = queries.shape[0]
        vals = [sec.gather_to_first(vals).transpose(0, 1).reshape(Q, -1, m).contiguous()]
        pos = [sec.gather_to_first(pos).transpose(0, 1).reshape(Q, -1, m).contiguous()]
    with _device_of(vals[0]):
        dist, fpos, flags, thresh, above = knn_kernels.knn_fused_merge(vals[0], pos[0], k)
    if not audit:
        return [dist, fpos, flags]
    counts = []
    for sh, q in zip(shards, on_shard):
        with _device_of(q):
            counts.append(knn_kernels.knn_count(sh.items, sh.norm, sh.valid, q, thresh.to(q.device)))
    if len(shards) > 1:
        counts = psum_parts(counts, section="knn.count")
    return [dist, fpos, flags, counts[0] != above]


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
    (first shard's) device (repeat kneighbors calls cache their query
    uploads).  Query blocks run through a dispatch/collect window; flagged
    rows are re-run through the exact route at the end.  audit=True takes the
    audit route (module header) and adds to the counters below.  On the
    kernel route a block holds query_block queries, fewer where the pool is
    wide (_block_rows).  On a mesh the exact route is the candidate exchange
    (_exact_block_search)."""
    dev = prepared.shards[0].items.device
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=dev, dtype=torch.float32)
    else:
        q = np.asarray(queries, np.float32)
    k_eff = min(k, prepared.n_items)
    Q = q.shape[0]
    if Q == 0:
        return np.zeros((0, k_eff), np.float32), np.zeros((0, k_eff), np.int64)
    n_loc = prepared.shards[0].items.shape[0]
    kernel_route, m = _kernel_route(k, n_loc)
    if kernel_route:
        pool = len(prepared.shards) * -(-n_loc // _GROUP_WIDTH) * m
        query_block = _block_rows(query_block, prepared.n_cols, pool, k)
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
            pending.append(_to_host(_exact_block_search(prepared, block(bi), k)))

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
            d_f, p_f = _exact_block_search(prepared, qf.contiguous(), k)
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
# The exact route on a mesh: the candidate exchange, ring permute or gather.
#
# The ring route row-shards the query block: each shard scans the visiting
# block against its resident items, merges into the block's travelling top
# k, and passes block and running candidates to its successor
# (DeviceSection.ring_shift, kernel B11 on the card).  After n hops every
# block is home with the global top k: each hop moves n blocks of queries
# and candidates between neighbours, where an all-gather replicates every
# shard's candidates on every shard.  The gather route replicates the query
# block, scans every shard and stacks the shards' top k (psum_merge) for one
# final merge.
#
# Both routes select by the lexicographic (d2, position) key at every stage,
# a total order, so the merged top k does not depend on the merge order.
# The scans cut queries into fixed qt-row sub-tiles and items into fixed
# chunk-wide slices, so every product has the same shape on every mesh size
# whenever qt and chunk come out mesh-independent (q a multiple of qt * n_dev,
# every shard at least chunk rows; _exchange_geometry): then ring == gather
# == one shard bit for bit.  _exact_block_search zero-pads every block to
# _exchange_rows first, as the JAX callers pad to their pow2 buckets, so a
# ragged block (the kernel route's flagged rows, the exact route's last
# block) still shards evenly onto the ring with whole sub-tiles.  As in the
# JAX package, the first hop's query shift is queued before the hop's scan;
# here both run on one stream, so they do not overlap.
# ---------------------------------------------------------------------------

_EXCHANGE_ROUTES = ("ring", "gather")


def _exchange_route(mesh: Mesh, q_rows: Optional[int] = None, exchange: str = "ring") -> str:
    """The candidate-exchange route: "local" on one shard (no exchange),
    else `exchange` ("ring", the JAX default, or "gather"); the ring takes
    only query blocks whose rows shard evenly (q_rows, when given), others
    go to the gather."""
    if exchange not in _EXCHANGE_ROUTES:
        raise ValueError(f"exchange must be one of {_EXCHANGE_ROUTES}, got {exchange!r}")
    n_dev = mesh.size
    if n_dev == 1:
        return "local"
    if exchange == "ring" and q_rows is not None and q_rows % n_dev:
        return "gather"
    return exchange


def _exchange_geometry(n_loc: int, q_rows: int, n_dev: int, route: str,
                       ring_chunk: int = _RING_CHUNK) -> Tuple[int, int]:
    """(chunk, qt) of the exchange scans: chunk = min(ring_chunk, n_loc), the
    cap whenever every shard holds at least ring_chunk rows; qt = the largest
    power-of-two divisor of the per-shard query rows up to _RING_QT, equal
    across mesh sizes whenever q_rows is a multiple of _RING_QT * n_dev."""
    chunk = max(1, min(ring_chunk, n_loc))
    rows = q_rows // n_dev if route == "ring" else q_rows
    qt = max(1, math.gcd(max(rows, 1), _RING_QT))
    return chunk, qt


def _exchange_rows(q_rows: int, n_dev: int) -> int:
    """The rows an exchange block is zero-padded to: n_dev equal shards of
    r rows, r the per-shard share rounded up to a power of two below
    _RING_QT and to a multiple of _RING_QT from there.  So the ring always
    takes the block and its sub-tile qt (_exchange_geometry) is r or
    _RING_QT, never a sliver; a block that already shards so stays as it
    is."""
    r = -(-q_rows // n_dev)
    r = 1 << (r - 1).bit_length() if r < _RING_QT else -(-r // _RING_QT) * _RING_QT
    return r * n_dev


def _sort_ordered(d2: torch.Tensor, pos: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """lex_topk of a tile whose finite entries carry ascending positions
    (every other entry holds LEX_POS_SENTINEL): one stable sort on d2 keeps
    equal distances in position order, so it gives lex_topk's bits."""
    sd, order = torch.sort(d2, dim=1, stable=True)
    kk = min(k, d2.shape[1])
    sd, sp = sd[:, :kk], pos.gather(1, order[:, :kk])
    if kk < k:
        sd = torch.nn.functional.pad(sd, (0, k - kk), value=float("inf"))
        sp = torch.nn.functional.pad(sp, (0, k - kk), value=LEX_POS_SENTINEL)
    return sd, sp


def _lex_local_scan(shard: ItemShard, q: torch.Tensor, k: int, chunk: int, qt: int):
    """One shard's lex-(d2, position) top k of `q` against its items:
    (squared distances (rows, k), positions (rows, k) int32).  Every product
    is exactly (qt, D) @ (D, chunk) — the fixed-tile contract above; a
    ragged last chunk starts early and masks the rows the previous chunk
    took.  Query rows go in batches of whole sub-tiles, so the (rows, chunk)
    tile stays under _TILE_BUDGET bytes; rows are independent, so the
    batching changes no bit."""
    items, norm, valid, base = shard
    n_loc, rows = items.shape[0], q.shape[0]
    dev = items.device
    n_chunks = -(-n_loc // chunk)
    batch = max(qt, (_TILE_BUDGET // (4 * chunk)) // qt * qt)
    out_d, out_p = [], []
    for r0 in range(0, rows, batch):
        qb = q[r0 : r0 + batch]
        nb_rows = qb.shape[0]
        qn = torch.cat([(qb[s : s + qt] * qb[s : s + qt]).sum(dim=1) for s in range(0, nb_rows, qt)])
        cross = torch.empty((nb_rows, chunk), dtype=torch.float32, device=dev)
        bd = torch.full((nb_rows, k), float("inf"), dtype=torch.float32, device=dev)
        bp = torch.full((nb_rows, k), LEX_POS_SENTINEL, dtype=torch.int32, device=dev)
        for ci in range(n_chunks):
            start = min(ci * chunk, n_loc - chunk)
            it = items[start : start + chunk]
            for s in range(0, nb_rows, qt):
                torch.matmul(qb[s : s + qt], it.T, out=cross[s : s + qt])
            d2 = (qn[:, None] - 2.0 * cross) + norm[None, start : start + chunk]
            keep = valid[start : start + chunk] & (torch.arange(start, start + chunk, device=dev) >= ci * chunk)
            d2 = torch.where(keep[None, :], d2, torch.full_like(d2, float("inf")))
            pos = torch.arange(base + start, base + start + chunk, dtype=torch.int32, device=dev).expand(nb_rows, -1)
            pos = torch.where(torch.isfinite(d2), pos, torch.full_like(pos, LEX_POS_SENTINEL))
            cd, cp = _sort_ordered(d2, pos, k)
            bd, bp = lex_topk(torch.cat([bd, cd], 1), torch.cat([bp, cp], 1), k)
        out_d.append(bd)
        out_p.append(bp)
    return torch.cat(out_d), torch.cat(out_p)


def knn_block_kernel_exchange(
    prepared: PreparedItems,
    queries: torch.Tensor,
    k: int,
    route: str,
    chunk: int,
    qt: int,
    topo: Optional[topology.TopologyMap] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest items of every query row over the candidate-exchange
    routes (section header): (distances (Q, k) ascending euclidean,
    positions (Q, k) int32, clamped into the padded item set — unfillable
    slots carry inf distance), on the first shard's device.  `route` "ring"
    row-shards the query block (its rows must divide by the shard count),
    "gather" replicates it; `topo` (None: flat) picks the sections'
    schedules."""
    shards = prepared.shards
    n_dev, Q = len(shards), queries.shape[0]
    n_pad = prepared.n_rows
    home = shards[0].items.device
    if route == "ring":
        if Q % n_dev:
            raise ValueError(f"the ring route shards {Q} query rows over {n_dev} shards: they must divide")
        rows = Q // n_dev
        q_blk = [queries[i * rows : (i + 1) * rows].to(sh.items.device) for i, sh in enumerate(shards)]
        sec_q = device_collective("knn.ring_q", topo)
        sec_c = device_collective("knn.ring_cand", topo)
        bd = [torch.full((rows, k), float("inf"), dtype=torch.float32, device=sh.items.device) for sh in shards]
        bp = [torch.full((rows, k), LEX_POS_SENTINEL, dtype=torch.int32, device=sh.items.device) for sh in shards]
        for _hop in range(n_dev):
            # the next hop's query block is queued first: it does not depend
            # on this hop's scan
            q_next = sec_q.ring_shift(q_blk)
            md, mp = [], []
            for i, sh in enumerate(shards):
                cd, cp = _lex_local_scan(sh, q_blk[i], k, chunk, qt)
                d, p = lex_topk(torch.cat([bd[i], cd], 1), torch.cat([bp[i], cp], 1), k)
                md.append(d.contiguous())
                mp.append(p.contiguous())
            # the running candidates travel with their block
            bd = sec_c.ring_shift(md)
            bp = sec_c.ring_shift(mp)
            q_blk = q_next
        # n rotations are the identity: every block is home
        fd = torch.cat([d.to(home) for d in bd])
        fp = torch.cat([p.to(home) for p in bp])
    elif route == "gather":
        cds, cps = [], []
        for sh in shards:
            cd, cp = _lex_local_scan(sh, queries.to(sh.items.device), k, chunk, qt)
            cds.append(cd)
            cps.append(cp)
        sec = device_collective("knn.gather_cand", topo)
        all_d = sec.gather_to_first(cds)  # (n_dev, Q, k) on the first shard's device
        all_p = sec.gather_to_first(cps)
        fd, fp = lex_topk(all_d.transpose(0, 1).reshape(Q, -1), all_p.transpose(0, 1).reshape(Q, -1), k)
    else:
        raise ValueError(f"route must be 'ring' or 'gather', got {route!r}")
    return knn_kernels.sqrt_clamped(fd), torch.clamp(fp, max=n_pad - 1)


def _exact_block_search(
    prepared: PreparedItems,
    qd: torch.Tensor,
    k: int,
    exchange: str = "ring",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One exact block search, the chokepoint of every exact-route caller
    (a block of the exact route, the flagged rows of the kernel route): the
    local route (knn_block_exact) on one shard, else the block zero-padded
    to _exchange_rows and the exchange route _exchange_route picks
    (`exchange`: "ring", the JAX default, or "gather"), with the geometry of
    _exchange_geometry and the mesh's topology.  Rows are independent, so
    the padding changes no bit of the rows returned.  The
    knn.exchange_route.<route> counter records the route that ran."""
    mesh = prepared.mesh
    Q = qd.shape[0]
    if mesh.size > 1:
        rows = _exchange_rows(Q, mesh.size)
        if rows > Q:
            qd = torch.cat([qd, qd.new_zeros((rows - Q, qd.shape[1]))])
    route = _exchange_route(mesh, qd.shape[0], exchange)
    profiling.incr_counter(f"knn.exchange_route.{route}")
    if route == "local":
        return knn_block_exact(prepared, qd, k)
    n_loc = prepared.shards[0].items.shape[0]
    chunk, qt = _exchange_geometry(n_loc, qd.shape[0], mesh.size, route)
    d, p = knn_block_kernel_exchange(prepared, qd, k, route, chunk, qt, topology.topology_map(mesh=mesh))
    return d[:Q], p[:Q]


# ---------------------------------------------------------------------------
# Item sets beyond the budget: streamed item blocks, host merges
# ---------------------------------------------------------------------------


def knn_search(
    items: np.ndarray,
    item_ids: np.ndarray,
    queries: np.ndarray,
    k: int,
    query_block: int = 8192,
    device: Union[torch.device, Mesh, None] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN of `queries` over host `items` on a device or a mesh: staged
    once when they fit one item block under the budget, else streamed
    (knn_search_out_of_core)."""
    dev = as_mesh(device)
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
    device: Union[torch.device, Mesh, None] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN with the items visiting the device in blocks of item_block
    rows: knn_search_streamed over one query part."""
    blocks = iter_prepared_item_blocks([(items, item_ids)], device, block_rows=item_block)
    return knn_search_streamed(blocks, lambda p: queries, [len(queries)], k, query_block)[0]


def iter_prepared_item_blocks(part_iter: Iterable[Tuple[np.ndarray, np.ndarray]],
                              device: Union[torch.device, Mesh, None] = None,
                              block_rows: Optional[int] = None):
    """Pack a stream of (features, ids) partition chunks into prepared item
    blocks of block_rows rows (default: what the item budget allows at the
    first chunk's width, taken once), the last one shorter, staged on
    `device` or row-sharded over a mesh (block_rows rounded down to a
    multiple of the shard count).  The host holds only the incoming
    partitions of one block.  The consumer drops each block before it asks
    for the next, so the device holds one block at a time."""
    dev = as_mesh(device)
    if block_rows is not None:
        block_rows = max(dev.size, block_rows - block_rows % dev.size)
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
