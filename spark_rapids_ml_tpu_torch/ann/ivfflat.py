#
# IVF-Flat approximate nearest neighbours over a device mesh.
#
# Counterpart of spark_rapids_ml_tpu/ann/ivfflat.py:
#
#   build:  the port's k-means (ops/kmeans: k-means|| init + Lloyd) trains
#           the coarse quantizer on a deterministic sample, on one device
#           (the packed payload does not depend on the mesh); list
#           assignment is the nearest-center kernel
#           (ops/nearest_center.min_dist_argmin, B1 on the card); the lists
#           are laid out on the host as one dense (nlist_pad, L_pad, D)
#           buffer, L_pad the pow2 bucket of the longest list, nlist_pad a
#           multiple of lcm(8, n_dev).
#   stage:  the list planes are sharded on the list axis over the mesh's
#           data axis (parallel/mesh.py: a sharded value is a list of
#           per-shard tensors), shard s owning the whole lists
#           [s * lps, (s + 1) * lps); the centroids and their norms are
#           replicated.  Positions stay global (list * L_pad + slot), so a
#           position means the same on every mesh.
#   search: every query picks its nprobe nearest centroids (once, on shard
#           0's device, and replicated), each shard scores the probed lists
#           it owns -- the expanded-form distances ||q||^2 - 2 q.x + ||x||^2
#           on the gathered tile (torch.bmm, fp32, TF32 off), every probe of
#           another shard's list invalid (its count 0 there) -- and keeps its
#           k best by the lexicographic (d2, position) key; one cross-shard
#           merge (merge_shard_topk) gives the global k best.  probe_sweep is
#           shared with the IVF-PQ search (pq.py).  One shard is the
#           one-element case of the same code.
#
# The selection: the probe ids of each query are sorted ascending before the
# gather, so the columns of the (Q, nprobe, L_pad) candidate pool rise with
# the position (list * L_pad + slot), and the fused merge kernel
# (ops/knn_kernels.knn_fused_merge, B7: ties to the lower pool slot) computes
# exactly the lexicographic top k of ops/knn.lex_topk, without its two full
# sorts of every row.  Which lists are probed is unchanged: the probes are
# the nprobe smallest d2 to the centroids, ties to the lower list id (a
# stable sort; jax.lax.top_k's rule).
#
# Bits across meshes: every selection orders by the total (d2, position)
# key, and every shard scores a tile of the one-shard shape (the probes of
# other shards' lists gather a clamped local list and are masked), so a
# candidate's d2 comes from the same reduction on every mesh and the N-shard
# result is bit for bit the one-shard result.  The price on the flat route
# is that each shard runs the whole block's distance products; the PQ
# kernels skip every row past a probed list's count, so there a shard reads
# only its own lists.
#
# The cross-shard merge (JAX merge_shard_topk): the fused merge (B7) takes
# each shard's pool to its (Q, k) best; their -d2 values are read back from
# the pool (B7 returns distances), the shards' (Q, k) blocks are stacked on
# shard 0 by exchange.psum_merge_parts (section ann.probe_merge, one call
# for the values and one for the positions), laid out shard after shard,
# and one more B7 over the (Q, n_dev * k) pool selects the k best.  Shard s
# owns lists below shard s + 1's and each block is in (d2, position) order,
# so wherever values tie, the lower pool slot holds the lower position: B7's
# tie rule is the lexicographic key.  Unfillable slots and tombstones carry
# -inf and the sentinel position, and lose to every real candidate.
#
# stage_padded_layout / tiered_stage_padded_layout stage a padded host
# layout as new device tensors (index_from_packed's second half, and the
# live index's restage, ann/mutable.py); the live index's tombstones are
# +inf norms, whose -inf pool values rank behind every live candidate.
#
# What does not carry over: shard_map (one process drives every shard, in
# turn), the pow2 query-block buckets and the AOT executable cache (XLA
# compile caching), warm_probe_kernels (nothing to compile here), and the
# JAX package's tile budget, which gives a chunk of one query at the ANN
# path's shapes: here a query block's candidate pool stays under _POOL_BYTES
# and each gather under _TILE_BYTES, the last block ragged.  There is no
# environment switch; tests shrink the two constants to exercise several
# blocks.
#

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as _device
from .. import profiling
from ..ops.kmeans import lloyd_iterations, scalable_kmeans_pp_init
from ..ops.knn import LEX_POS_SENTINEL
from ..ops.knn_kernels import knn_fused_merge
from ..ops.nearest_center import min_dist_argmin
from ..parallel.exchange import psum_merge_parts, replicate
from ..parallel.mesh import Mesh, as_mesh
from ..utils import chunk_iter

# nlist padding unit: the packed layout pads the list count to a multiple of
# 8, and staging to lcm(8, n_dev), so every mesh of up to 8 shards that
# divides 8 sees the same padded geometry
_LIST_ALIGN = 8
# smallest per-list slot bucket (pow2 ladder floor)
_MIN_LIST_SLOTS = 8
# positions are int32 (list * L_pad + slot); the sentinel marks invalid
# candidate slots and exceeds every real position
_POS_SENTINEL = LEX_POS_SENTINEL
# device bytes of one query block's candidate pool (values and positions,
# 8 bytes a candidate); a wider pool shortens the block
_POOL_BYTES = 1 << 30
# device bytes of one gathered tile of probed lists (flat: the items; PQ:
# the codes and their ADC sums); a wider tile takes fewer queries at once
_TILE_BYTES = 2 << 30
# host bytes of items sent to the nearest-center kernel at once
_ASSIGN_BYTES = 1 << 30
# quantizer training sample cap (the FAISS convention): the cap bounds build
# time independent of the index size
_TRAIN_CAP = 65536


def default_nlist(n_items: int) -> int:
    """sqrt(n) lists clamped to [8, 1024]: the standard IVF sizing rule."""
    return int(max(_LIST_ALIGN, min(1024, round(math.sqrt(max(n_items, 1))))))


def default_nprobe(n_lists: int) -> int:
    """A quarter of the lists, floor 8."""
    return int(max(8, n_lists // 4))


def shape_bucket(n: int, lo: int) -> int:
    """The power-of-two bucket of n (at least lo): the list slot count of
    the padded layout."""
    b = lo
    while b < n:
        b *= 2
    return b


class PackedIVF:
    """Host-side index payload: items sorted by list (stable), their ids,
    per-list counts, and the genuine (unpadded) centroids.  This is what the
    model persists; index_from_packed expands it into the device layout."""

    __slots__ = ("items", "ids", "counts", "centroids", "n_lists", "n_items")

    def __init__(self, items, ids, counts, centroids, n_lists, n_items):
        self.items = items          # (N, D) f32, list-sorted
        self.ids = ids              # (N,) int64 user ids, list-sorted
        self.counts = counts        # (nlist_base,) int64 per-list counts
        self.centroids = centroids  # (n_lists, D) f32
        self.n_lists = int(n_lists)
        self.n_items = int(n_items)


class IVFFlatIndex:
    """Device-staged IVF-Flat index (the padded layout of a PackedIVF) on a
    mesh.  Sharded fields are lists of per-shard tensors (shard s on
    mesh.devices[s], its lists [s * lps, (s + 1) * lps)); replicated fields
    are one tensor a shard."""

    __slots__ = (
        "mesh", "list_data", "list_norm", "counts", "centroids", "c_norm",
        "ids", "n_items", "n_lists", "nlist_pad", "l_pad", "dim",
    )

    def __init__(self, mesh, list_data, list_norm, counts, centroids, c_norm, ids, n_items, n_lists, nlist_pad,
                 l_pad, dim):
        self.mesh = mesh
        self.list_data = list_data  # [(lps, L_pad, D) f32] a shard
        self.list_norm = list_norm  # [(lps, L_pad) f32 ||x||^2] a shard
        self.counts = counts        # [(nlist_pad,) int32] a shard: its own lists' counts, 0 elsewhere
        self.centroids = centroids  # replicated (nlist_pad, D) f32, pad rows zero
        self.c_norm = c_norm        # replicated (nlist_pad,) f32, +inf in pad rows
        self.ids = ids              # (nlist_pad * L_pad,) int64 HOST, -1 pads
        self.n_items = n_items
        self.n_lists = n_lists
        self.nlist_pad = nlist_pad
        self.l_pad = l_pad
        self.dim = dim

    @property
    def lps(self) -> int:
        return self.nlist_pad // self.mesh.size

    def shard_planes(self, s: int):
        return (self.list_data[s], self.list_norm[s])

    def device_bytes(self) -> int:
        """Device-resident footprint of the staged index (ids stay on the
        host; a replicated field counted once): the numerator of
        index_bytes_per_item."""
        return int(
            sum(t.nbytes for t in self.list_data) + sum(t.nbytes for t in self.list_norm)
            + 4 * self.nlist_pad + self.centroids[0].nbytes + self.c_norm[0].nbytes
        )


class TieredIVFFlatIndex:
    """IVF-Flat index whose data / norm list planes live in a
    TieredListPlanes pool (hot lists pinned, cold lists paged from the host
    layout).  The same search as IVFFlatIndex: paging changes residency,
    never the arithmetic."""

    __slots__ = (
        "mesh", "tier", "counts", "centroids", "c_norm", "ids", "n_items",
        "n_lists", "nlist_pad", "l_pad", "dim", "hot_fraction",
    )

    def __init__(self, mesh, tier, counts, centroids, c_norm, ids, n_items, n_lists, nlist_pad, l_pad, dim,
                 hot_fraction):
        self.mesh = mesh
        self.tier = tier            # TieredListPlanes over [data, norms], a pool a shard
        self.counts = counts
        self.centroids = centroids
        self.c_norm = c_norm
        self.ids = ids
        self.n_items = n_items
        self.n_lists = n_lists
        self.nlist_pad = nlist_pad
        self.l_pad = l_pad
        self.dim = dim
        self.hot_fraction = float(hot_fraction)

    @property
    def lps(self) -> int:
        return self.nlist_pad // self.mesh.size

    def device_bytes(self) -> int:
        return int(self.tier.device_bytes() + 4 * self.nlist_pad + self.centroids[0].nbytes + self.c_norm[0].nbytes)

    def host_bytes(self) -> int:
        return self.tier.host_bytes()


# ---------------------------------------------------------------------------
# Build
# ---------------------------------------------------------------------------


def train_coarse_quantizer(
    items: np.ndarray,
    n_clusters: int,
    seed: int,
    max_train_rows: int = _TRAIN_CAP,
    max_iter: int = 25,
    tol: float = 1e-4,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Train an (n_clusters, D) quantizer with the port's k-means on a
    deterministic seeded sample (the JAX package's sampling rule, numpy's
    generator).  The k-means|| init draws the JAX package's threefry Gumbel
    noise from `seed` (ops/kmeans.py), so the centroids are the JAX
    package's up to float32 sums in another order.  Shared by the coarse
    quantizer and the PQ codebooks (pq.py)."""
    dev = device if device is not None else _device.resolve()
    items = np.ascontiguousarray(np.asarray(items), dtype=np.float32)
    n = items.shape[0]
    n_clusters = int(max(1, min(n_clusters, n)))
    seed = int(seed) & 0x7FFFFFFF
    if n > max_train_rows:
        rng = np.random.default_rng(seed)
        items = items[np.sort(rng.choice(n, size=max_train_rows, replace=False))]
    X = torch.from_numpy(np.ascontiguousarray(items)).to(dev)
    w = torch.ones(X.shape[0], dtype=torch.float32, device=dev)
    chunk = min(32768, X.shape[0])
    centers0 = scalable_kmeans_pp_init(
        X, w, n_clusters, seed, rounds=4, round_size=max(1, min(2 * n_clusters, X.shape[0])), chunk=chunk
    )
    centers, _, _ = lloyd_iterations(X, w, centers0, max_iter, float(tol), chunk)
    return centers.cpu().numpy().astype(np.float32)


def assign_nearest(
    items: np.ndarray,
    centroids: np.ndarray,
    device: Optional[torch.device] = None,
    phase: str = "ann.assign",
    counter: str = "ann.assign_blocks",
) -> np.ndarray:
    """Nearest-centroid id (int64) of every row, through the nearest-center
    kernel in row blocks of at most _ASSIGN_BYTES, under the range `phase`
    with the blocks counted in `counter`.  Shared by the list assignment,
    the PQ subspace encoding and the live index's adds (ann/mutable.py)."""
    dev = device if device is not None else _device.resolve()
    items = np.asarray(items, dtype=np.float32)
    n, d = items.shape
    out = np.empty(n, np.int64)
    with record_function(phase):
        c = torch.from_numpy(np.ascontiguousarray(centroids, np.float32)).to(dev)
        blocks = 0
        for sl in chunk_iter(n, max(1, _ASSIGN_BYTES // (4 * max(d, 1)))):
            x = torch.from_numpy(np.ascontiguousarray(items[sl])).to(dev)
            out[sl] = min_dist_argmin(x, c)[1].cpu().numpy()
            blocks += 1
    profiling.incr_counter(counter, blocks)
    return out


def list_order(assign: np.ndarray, n_lists: int) -> Tuple[np.ndarray, np.ndarray]:
    """(per-list counts over nlist rounded up to a multiple of 8, the stable
    list-sorted order of the items): the packed layout rule."""
    nlist_base = -(-n_lists // _LIST_ALIGN) * _LIST_ALIGN
    return np.bincount(assign, minlength=nlist_base).astype(np.int64), np.argsort(assign, kind="stable")


def pack_lists(items: np.ndarray, item_ids: np.ndarray, assign: np.ndarray, centroids: np.ndarray,
               n_lists: int) -> PackedIVF:
    """The list layout of assigned items."""
    counts, order = list_order(assign, n_lists)
    return PackedIVF(items[order], np.asarray(item_ids, np.int64)[order], counts, centroids, n_lists,
                     items.shape[0])


def build_ivfflat_packed(
    items,
    item_ids: np.ndarray,
    n_lists: int,
    seed: int = 0,
    max_train_rows: int = _TRAIN_CAP,
    max_iter: int = 25,
    tol: float = 1e-4,
    device: Optional[torch.device] = None,
) -> PackedIVF:
    """Train the coarse quantizer, assign every item to its nearest
    centroid and pack the inverted lists."""
    items = np.ascontiguousarray(np.asarray(items), dtype=np.float32)
    n = items.shape[0]
    if n == 0:
        raise ValueError("cannot build an IVF-Flat index over 0 items")
    n_lists = int(max(1, min(n_lists, n)))
    centroids = train_coarse_quantizer(items, n_lists, seed, max_train_rows, max_iter, tol, device)
    return pack_lists(items, item_ids, assign_nearest(items, centroids, device), centroids, n_lists)


# ---------------------------------------------------------------------------
# Staging
# ---------------------------------------------------------------------------


def item_norms(data: np.ndarray) -> np.ndarray:
    """||x||^2 per padded row, computed on the host in float64 and stored
    float32: index data, not per-search arithmetic."""
    return np.einsum("nd,nd->n", data.astype(np.float64), data.astype(np.float64)).astype(np.float32)


def padded_layout_geometry(n_lists: int, counts: np.ndarray, l_pad: Optional[int] = None,
                           mesh: Optional[Mesh] = None):
    """(nlist_pad, counts padded to it, L_pad) of a packed list layout on
    `mesh` (nlist_pad a multiple of lcm(8, n_dev); one shard without a
    mesh), L_pad the pow2 bucket of the longest list unless given; raises
    when the given L_pad cannot hold the longest list or the int32
    positions would overflow.  Shared by the flat and PQ layouts."""
    mult = math.lcm(_LIST_ALIGN, mesh.size if mesh is not None else 1)
    nlist_pad = -(-max(n_lists, 1) // mult) * mult
    padded = np.zeros(nlist_pad, np.int64)
    padded[: counts.shape[0]] = counts
    l_need = shape_bucket(int(max(padded.max(), 1)), lo=_MIN_LIST_SLOTS)
    if l_pad is None:
        l_pad = l_need
    elif l_pad < int(padded.max()):
        raise ValueError(f"l_pad={l_pad} cannot hold the longest list ({padded.max()} items needs {l_need} slots)")
    if nlist_pad * l_pad > int(_POS_SENTINEL):
        raise ValueError(
            f"IVF layout overflows int32 positions: {nlist_pad} lists x {l_pad} slots; raise nlist so lists shrink"
        )
    return nlist_pad, padded, l_pad


def padded_slots(counts: np.ndarray, l_pad: int) -> np.ndarray:
    """The flat slot (list * L_pad + slot) of every list-sorted row."""
    offs = np.zeros(counts.shape[0] + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    row_list = np.repeat(np.arange(counts.shape[0], dtype=np.int64), counts)
    return row_list * l_pad + (np.arange(int(offs[-1]), dtype=np.int64) - offs[row_list])


def padded_host_layout(packed: PackedIVF, l_pad: Optional[int] = None, mesh: Optional[Mesh] = None):
    """Expand a PackedIVF into the padded host layout `mesh` stages: lists
    padded to `l_pad` slots (default the pow2 slot bucket of the longest
    list), the list axis to a multiple of lcm(8, n_dev).  Returns (data
    (nlist_pad * l_pad, D), x_norm, ids_pad, counts int64, cpad, c_norm,
    nlist_pad, l_pad)."""
    nlist_pad, counts, l_pad = padded_layout_geometry(packed.n_lists, packed.counts, l_pad, mesh)
    d = packed.items.shape[1]
    flat = padded_slots(counts, l_pad)
    data = np.zeros((nlist_pad * l_pad, d), np.float32)
    data[flat] = packed.items
    ids_pad = np.full(nlist_pad * l_pad, -1, np.int64)
    ids_pad[flat] = packed.ids
    cpad = np.zeros((nlist_pad, d), np.float32)
    cpad[: packed.n_lists] = packed.centroids
    c_norm = item_norms(cpad)
    c_norm[packed.n_lists :] = np.inf  # pad lists never win a probe slot
    return data, item_norms(data), ids_pad, counts, cpad, c_norm, nlist_pad, l_pad


def shard_lists(plane: np.ndarray, mesh: Mesh) -> list:
    """A host (nlist_pad, ...) list plane split on the list axis, each
    shard's block a new tensor on its device."""
    lps = plane.shape[0] // mesh.size
    return [torch.from_numpy(plane[s * lps : (s + 1) * lps]).to(dev, copy=True) for s, dev in enumerate(mesh.devices)]


def shard_counts(counts: np.ndarray, mesh: Mesh) -> list:
    """Each shard's (nlist_pad,) int32 list counts: its own lists' counts and
    0 for every other list, so a probe of another shard's list is empty
    there."""
    lps = counts.shape[0] // mesh.size
    out = []
    for s, dev in enumerate(mesh.devices):
        own = np.zeros(counts.shape[0], np.int32)
        own[s * lps : (s + 1) * lps] = counts[s * lps : (s + 1) * lps]
        out.append(torch.from_numpy(own).to(dev))
    return out


def replicated(a: np.ndarray, mesh: Mesh) -> list:
    """A host array as one new tensor a shard (shards of one device share
    it)."""
    return replicate(torch.from_numpy(a).to(mesh.devices[0], copy=True), mesh.devices)


def stage_padded_layout(
    data: np.ndarray,
    x_norm: np.ndarray,
    ids_pad: np.ndarray,
    counts: np.ndarray,
    cpad: np.ndarray,
    c_norm: np.ndarray,
    nlist_pad: int,
    l_pad: int,
    n_items: int,
    n_lists: int,
    mesh,
) -> IVFFlatIndex:
    """Upload a padded host layout as an IVFFlatIndex on `mesh` (a Mesh or
    a device; the staging half of index_from_packed, and the live index's
    full restage): new device tensors, never views of the host arrays, each
    shard holding only its own lists."""
    mesh = as_mesh(mesh)
    d = data.shape[1]
    with record_function("ann.stage"):
        return IVFFlatIndex(
            mesh=mesh,
            list_data=shard_lists(data.reshape(nlist_pad, l_pad, d), mesh),
            list_norm=shard_lists(x_norm.reshape(nlist_pad, l_pad), mesh),
            counts=shard_counts(counts, mesh), centroids=replicated(cpad, mesh), c_norm=replicated(c_norm, mesh),
            ids=ids_pad, n_items=n_items, n_lists=n_lists, nlist_pad=nlist_pad, l_pad=l_pad, dim=d,
        )


def _plane(a, shape: Tuple[int, ...]):
    """A host plane in `shape`: a view of a numpy array or of a (pinned)
    tensor."""
    return a.view(shape) if isinstance(a, torch.Tensor) else a.reshape(shape)


def tiered_stage_padded_layout(
    data,
    x_norm,
    ids_pad: np.ndarray,
    counts: np.ndarray,
    cpad: np.ndarray,
    c_norm: np.ndarray,
    nlist_pad: int,
    l_pad: int,
    n_items: int,
    n_lists: int,
    mesh,
    hot_fraction: float,
    pool_slots: Optional[int] = None,
) -> TieredIVFFlatIndex:
    """stage_padded_layout's tiered twin: only `hot_fraction` of each
    shard's lists pinned in its device pool, the rest paged in on probe.
    The tier's host planes are views of `data` / `x_norm` (numpy arrays, or
    pinned tensors on a CUDA device), so an edit of those arrays reaches
    every later page-in."""
    from .tier import TieredListPlanes

    mesh = as_mesh(mesh)
    d = data.shape[1]
    with record_function("ann.stage"):
        tier = TieredListPlanes(
            planes=[_plane(data, (nlist_pad, l_pad, d)), _plane(x_norm, (nlist_pad, l_pad))],
            sentinels=[None, np.inf], counts=counts, device=mesh, hot_fraction=hot_fraction,
            pool_slots=pool_slots,
        )
        return TieredIVFFlatIndex(
            mesh=mesh, tier=tier, counts=shard_counts(counts, mesh), centroids=replicated(cpad, mesh),
            c_norm=replicated(c_norm, mesh), ids=ids_pad, n_items=n_items, n_lists=n_lists, nlist_pad=nlist_pad,
            l_pad=l_pad, dim=d, hot_fraction=hot_fraction,
        )


def index_from_packed(packed: PackedIVF, mesh=None) -> IVFFlatIndex:
    """Stage a PackedIVF on `mesh` (a Mesh, a device, or None: the entry
    points' device); user ids stay on the host."""
    mesh = as_mesh(mesh)
    layout = padded_host_layout(packed, mesh=mesh)
    return stage_padded_layout(*layout, packed.n_items, packed.n_lists, mesh)


def tiered_index_from_packed(
    packed: PackedIVF, hot_fraction: float, mesh=None, pool_slots: Optional[int] = None
) -> TieredIVFFlatIndex:
    """index_from_packed with only `hot_fraction` of each shard's lists
    pinned on its device and the rest paged in from the host layout on
    probe."""
    mesh = as_mesh(mesh)
    layout = padded_host_layout(packed, mesh=mesh)
    return tiered_stage_padded_layout(*layout, packed.n_items, packed.n_lists, mesh, hot_fraction, pool_slots)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def select_probes(q: torch.Tensor, centroids: torch.Tensor, c_norm: torch.Tensor, nprobe: int):
    """Probe selection shared by the flat and PQ searches: expanded-form
    query -> centroid distances and the nprobe nearest lists, ties to the
    lower list id (pad lists carry +inf norms and lose to every genuine
    one).  Returns (qn (Q,), d2p (Q, nprobe) the probed lists' distances --
    the ADC probe term --, probes (Q, nprobe) int64), the probes of each row
    in ascending list order."""
    qn = (q * q).sum(dim=1)
    d2c = qn[:, None] - 2.0 * (q @ centroids.T) + c_norm[None, :]
    d2s, order = torch.sort(d2c, dim=1, stable=True)
    probes, by_id = torch.sort(order[:, :nprobe], dim=1)
    return qn, d2s[:, :nprobe].gather(1, by_id), probes


def effective_nprobe(index, nprobe: int) -> int:
    return int(max(1, min(nprobe, index.nlist_pad)))


def probe_pool(index, qb: torch.Tensor, nprobe: int, block_scorer: Callable, sub_rows: int, shard: int = 0,
               sel=None):
    """The candidate pool of one query block on shard `shard` of the
    index's mesh: (values (rows, nprobe, L_pad) float32 = -d2, -inf where
    invalid; positions (rows, nprobe, L_pad) int32 = list * L_pad + slot,
    _POS_SENTINEL where invalid), the probes of each row in ascending list
    order.  Only the shard's own probed lists are valid; the other probes
    gather a clamped local list at the same shapes and are masked.  `qb` is
    on the shard's device; `sel` is the block's select_probes there (None:
    selected here).  block_scorer(qb, qn, d2p, counts), counts (rows,
    nprobe) int32 the probed lists' item counts on the shard, returns a
    function scores(planes, slots, rows) giving the d2 (c, nprobe, L_pad) of
    the block's rows `rows` over the lists at the (c, nprobe) plane slots
    (any value past a list's count); it is called on at most sub_rows rows
    at once.  A tiered index scores every group of the planner with the
    sub-block's full shapes and keeps the group's rows, so a row's bits do
    not depend on the paging."""
    dev = qb.device
    slot = torch.arange(index.l_pad, dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    with record_function("ann.select"):
        if sel is None:
            sel = select_probes(qb, index.centroids[shard], index.c_norm[shard], nprobe)
        qn, d2p, probes = sel
        counts = index.counts[shard][probes]
        valid = slot[None, None, :] < counts[:, :, None]
        pos = torch.where(valid, probes.to(torch.int32)[:, :, None] * index.l_pad + slot, _POS_SENTINEL)
        vals = torch.empty(pos.shape, dtype=torch.float32, device=dev)
    scores = block_scorer(qb, qn, d2p, counts)
    tier = getattr(index, "tier", None)
    with record_function("ann.scan"):
        if tier is None:
            planes = index.shard_planes(shard)
            local = (probes - shard * index.lps).clamp_(0, index.lps - 1)
            for sl in chunk_iter(qb.shape[0], sub_rows):
                vals[sl] = -torch.where(valid[sl], scores(planes, local[sl], sl), inf)
        else:
            host_probes = probes.cpu().numpy()
            for sl in chunk_iter(qb.shape[0], sub_rows):
                for s, e in tier.plan_groups(host_probes[sl], shard):
                    planes, slot_map = tier.acquire(host_probes[sl][s:e].ravel(), shard)
                    d2 = scores(planes, slot_map[probes[sl]], sl)
                    g = slice(sl.start + s, sl.start + e)
                    vals[g] = -torch.where(valid[g], d2[s:e], inf)
    return vals, pos


def sweep_geometry(n: int, width: int, tile_bytes_per_query: int) -> Tuple[int, int]:
    """(query rows a block, rows scored at once): the block's pool of
    `width` candidates a query under _POOL_BYTES, the gathered tile of
    tile_bytes_per_query bytes a query under _TILE_BYTES."""
    block_rows = max(1, min(n, _POOL_BYTES // (8 * width)))
    return block_rows, max(1, min(block_rows, _TILE_BYTES // max(1, tile_bytes_per_query)))


def pool_values(vals: torch.Tensor, probes: torch.Tensor, pos: torch.Tensor, l_pad: int) -> torch.Tensor:
    """The pool values (-d2) of the selected positions `pos` (rows, k) of a
    (rows, nprobe, L_pad) pool (B7 returns distances, the merge needs the
    values it ranked): column j * L_pad + slot, j the rank of the
    position's list among the row's ascending probes; -inf at the
    sentinel."""
    real = pos != _POS_SENTINEL
    p = torch.where(real, pos, 0).long()
    j = torch.searchsorted(probes, (p // l_pad).contiguous()).clamp_(max=probes.shape[1] - 1)
    v = vals.view(vals.shape[0], -1).gather(1, j * l_pad + p % l_pad)
    return torch.where(real, v, float("-inf"))


def merge_shard_topk(best_v, best_p, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-shard merge (module header): the shards' (rows, k) values
    and positions stacked on shard 0 by exchange.psum_merge_parts (section
    ann.probe_merge), laid out shard after shard, and one fused merge (B7)
    over the (rows, n_dev * k) pool.  Returns (distances (rows, k), positions
    (rows, k), _POS_SENTINEL where the distance is inf) on shard 0's
    device."""
    all_v = psum_merge_parts(best_v, section="ann.probe_merge")[0]
    all_p = psum_merge_parts(best_p, section="ann.probe_merge")[0]
    dist, fpos = knn_fused_merge(all_v.transpose(0, 1).contiguous(), all_p.transpose(0, 1).contiguous(), k)[:2]
    return dist, torch.where(torch.isinf(dist), _POS_SENTINEL, fpos)


def probe_sweep(
    index,
    q: torch.Tensor,
    k: int,
    nprobe: int,
    block_scorer: Callable,
    tile_bytes_per_query: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """The probed search of the flat and PQ indexes on the index's mesh:
    host (distances (Q, k) float32 ascending sqrt(max(d2, 0)), positions
    (Q, k) int32; unfillable slots carry inf and _POS_SENTINEL).  Each query
    block's probes are selected once and replicated; each shard's pool
    (probe_pool) is merged by knn_fused_merge to its k best, and the shards'
    by merge_shard_topk (module header).  `q` is on shard 0's device."""
    mesh = index.mesh
    devs = mesh.devices
    block_rows, sub_rows = sweep_geometry(q.shape[0], nprobe * index.l_pad, tile_bytes_per_query)
    qs = replicate(q, devs)
    out_d, out_p = [], []
    for blk in chunk_iter(q.shape[0], block_rows):
        with record_function("ann.select"):
            sel = select_probes(qs[0][blk], index.centroids[0], index.c_norm[0], nprobe)
            sels = list(zip(*(replicate(t, devs) for t in sel)))
        best_v, best_p = [], []
        for s in range(mesh.size):
            vals, pos = probe_pool(index, qs[s][blk], nprobe, block_scorer, sub_rows, s, sels[s])
            with record_function("ann.merge"):
                dist, fpos = knn_fused_merge(vals, pos, k)[:2]
                fpos = torch.where(torch.isinf(dist), _POS_SENTINEL, fpos)
                if mesh.size > 1:
                    best_v.append(pool_values(vals, sels[s][2], fpos, index.l_pad))
                    best_p.append(fpos)
            del vals, pos
        if mesh.size > 1:
            with record_function("ann.merge"):
                dist, fpos = merge_shard_topk(best_v, best_p, k)
        out_d.append(dist)
        out_p.append(fpos)
    return torch.cat(out_d).cpu().numpy(), torch.cat(out_p).cpu().numpy()


def _flat_block_scorer(qb: torch.Tensor, qn: torch.Tensor, _d2p: torch.Tensor, _counts: torch.Tensor):
    def scores(planes, slots, sl):
        data, norm = planes
        c, p = slots.shape
        l_pad, d = data.shape[1], data.shape[2]
        flat = slots.reshape(-1)
        tile = data.index_select(0, flat).view(c, p * l_pad, d)
        xn = norm.index_select(0, flat).view(c, p, l_pad)
        cross = torch.bmm(tile, qb[sl].unsqueeze(2)).view(c, p, l_pad)
        # the exact engine's expanded form, in its rounding order
        return (qn[sl, None, None] - 2.0 * cross) + xn

    return scores


def to_device_queries(queries, dim: int, dev: torch.device) -> torch.Tensor:
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=dev, dtype=torch.float32)
    else:
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    if q.dim() != 2 or q.shape[1] != dim:
        raise ValueError(f"queries must be (n, {dim}); got {tuple(q.shape)}")
    return q.contiguous()


def ids_of(ids_pad: np.ndarray, dist: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """User ids of padded-layout positions; -1 where the distance is inf."""
    ids = ids_pad[np.minimum(pos, ids_pad.size - 1)]
    ids[np.isinf(dist)] = -1
    return ids


def flat_tile_bytes(index, nprobe: int) -> int:
    """Device bytes a query's scoring takes: its gathered items, their
    norms, the cross terms and the distances."""
    return 4 * nprobe * index.l_pad * (index.dim + 3)


def ivfflat_search_prepared(index, queries, k: int, nprobe: int) -> Tuple[np.ndarray, np.ndarray]:
    """Probed search of `queries` (host array or tensor) against a staged
    index: (distances (Q, k_eff) ascending euclidean float32, ids (Q, k_eff)
    int64, -1 in unfillable slots), k_eff = min(k, n_items)."""
    q = to_device_queries(queries, index.dim, index.centroids[0].device)
    k_eff = min(k, index.n_items)
    if q.shape[0] == 0:
        return np.zeros((0, k_eff), np.float32), np.zeros((0, k_eff), np.int64)
    np_eff = effective_nprobe(index, nprobe)
    d_all, p_all = probe_sweep(index, q, k, np_eff, _flat_block_scorer, flat_tile_bytes(index, np_eff))
    return d_all[:, :k_eff], ids_of(index.ids, d_all, p_all)[:, :k_eff]


def recall_at_k(approx_ids, exact_ids) -> float:
    """Mean fraction of each row's exact k-nearest ids recovered by the
    probed result; the -1 unfillable sentinel never counts as a hit."""
    a = np.asarray(approx_ids)
    e = np.asarray(exact_ids)
    if a.shape[0] != e.shape[0]:
        raise ValueError(f"row mismatch: {a.shape[0]} approx vs {e.shape[0]} exact")
    if e.size == 0:
        return 1.0
    hits = 0
    for ar, er in zip(a, e):
        hits += np.intersect1d(ar[ar >= 0], er).size
    return hits / float(e.shape[0] * e.shape[1])
