#
# Live IVF-Flat index mutation (srml-stream, the ann/ half).
#
# Counterpart of spark_rapids_ml_tpu/ann/mutable.py, over a device mesh: the
# index is list-sharded as ivfflat stages it (shard s owns the lists
# [s * lps, (s + 1) * lps)), and the host mirrors stay whole.  A serving
# IVF-Flat index changes in place:
#
#   add_items:    new rows go to their nearest coarse list through the same
#                 nearest-center kernel that built the index (assign_nearest,
#                 B1 on the card, one pass on the mesh's first device; range
#                 ann.mutate.assign, its blocks counted in
#                 ann.mutate.assign_blocks) and into the free slots past
#                 each list's count in the (nlist_pad, L_pad, D) layout, on
#                 the list's owner shard;
#   delete_items: a per-list tombstone bitmap; a tombstoned slot's stored
#                 ||x||^2 becomes +inf, so its distance is +inf, its pool
#                 value -inf, and it ranks behind every live candidate in the
#                 merge (B7); the host id map turns inf distances into -1.
#                 Slots are reclaimed at repack;
#   repack:       when a list outgrows L_pad (or on request) the live rows
#                 are laid out again, in the pow2 slot bucket that fits, and
#                 staged as a new index.
#
# Concurrency: mutators take one lock; readers take the current snapshot
# (`index`, one reference read) and search it without the lock.  A search
# that overlaps a mutation sees the whole old index or the whole new one:
#   - a snapshot's counts, its norm plane after a delete, and its host id
#     table are new objects at every swap (the JAX package's _stage /
#     _swap_norms make them by device_put), so no later mutation edits them;
#   - an add writes its rows and norms into the free slots of the owner
#     shards' current device planes in place (an index_copy_ of the new
#     rows: the restage bytes of an add are its rows, not the plane).  Older
#     snapshots share those planes, but their own counts mask every slot
#     past them (probe_pool's valid), and the writes are queued on each
#     device's stream before the swap, so a reader that takes the new
#     snapshot launches after them;
#   - a delete builds a new norm plane on each shard it touches (a copy of
#     the shard's current one with +inf at the deleted slots); the data
#     planes and the other shards' norm planes are untouched;
#   - a repack, and every add to a tiered index, stages new planes on every
#     shard from the host mirrors off the readers' path; searches in flight
#     finish on the old ones.
# Tiered (hot_fraction < 1, ann/tier.py): the tier's host planes are the
# holder's own mirrors (pinned on a CUDA device), so an edit reaches every
# later page-in, and a delete re-pages the resident copies of the lists it
# touched (TieredListPlanes.refresh).
#
# The coarse quantizer is fixed for the index's life (the FAISS semantics):
# adds go to the existing centroids, so drift degrades list balance, not
# correctness.  The JAX package waits for XLA compiles of a repacked
# geometry before the swap (_warm_for); nothing compiles here, so
# register_warm only records the probe geometry the serving plane asks for.
#
# Counters: ann.mutate.adds, ann.mutate.deletes, ann.mutate.repacks, and
# ann.mutate.bytes (host-to-device bytes of every restage).
#

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import profiling
from ..parallel.mesh import as_mesh
from .ivfflat import (
    _MIN_LIST_SLOTS,
    IVFFlatIndex,
    PackedIVF,
    TieredIVFFlatIndex,
    assign_nearest,
    item_norms,
    ivfflat_search_prepared,
    padded_host_layout,
    shape_bucket,
    shard_counts,
    stage_padded_layout,
    tiered_stage_padded_layout,
)


class MutableIVFIndex:
    """A PackedIVF staged on a mesh with live add / delete / repack.

    The host mirrors (padded data, norms, ids and counts, the tombstone
    bitmap and an id -> position map) are the source of truth; each
    mutation edits them, brings the device planes up to date (module
    header) and swaps the snapshot readers search (`index`).  `mesh` is a
    parallel.mesh.Mesh, a device (one shard), or None (the entry points'
    device)."""

    def __init__(
        self,
        packed: PackedIVF,
        mesh=None,
        hot_fraction: float = 1.0,
        pool_slots: Optional[int] = None,
    ):
        self._mesh = as_mesh(mesh)
        self._dev = self._mesh.devices[0]
        self._hot_fraction = float(hot_fraction)
        self._pool_slots = pool_slots
        self._lock = threading.RLock()
        self._n_lists = packed.n_lists
        self._live = int(packed.n_items)
        self._load_layout(padded_host_layout(packed, mesh=self._mesh))
        # probe geometries the serving plane dispatches (register_warm);
        # their own lock, since noting one is on the read path
        self._spec_lock = threading.Lock()
        self._warm_specs: set = set()
        self._repacks = 0
        self._index = self._stage()

    # -- read side ---------------------------------------------------------
    @property
    def index(self):
        """The current snapshot: read without the lock (a reference read),
        so a search never waits for a mutation."""
        return self._index

    @property
    def mesh(self):
        return self._mesh

    @property
    def n_items(self) -> int:
        with self._lock:
            return self._live

    def tombstone_bitmap(self) -> np.ndarray:
        """(nlist_pad, ceil(L_pad / 8)) uint8: the packed per-list tombstone
        bitmap."""
        with self._lock:
            return np.packbits(self._tombstones, axis=1)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "n_items": self._live,
                "tombstoned": self._dead,
                "n_lists": self._n_lists,
                "l_pad": self._l_pad,
                "repacks": self._repacks,
                "device_bytes": self._index.device_bytes(),
            }

    def search(self, queries: Any, k: int, nprobe: int) -> Tuple[np.ndarray, np.ndarray]:
        """Probed search of the current snapshot, without the lock:
        (distances (Q, k_eff) float32, ids (Q, k_eff) int64, -1 where
        unfillable)."""
        idx = self.index
        self.register_warm(k, nprobe, queries.shape[0] if hasattr(queries, "shape") else None)
        return ivfflat_search_prepared(idx, queries, k, nprobe)

    def register_warm(self, k: int, nprobe: int, n_queries: Optional[int]) -> None:
        """Record a probe geometry (k, nprobe, query rows).  The JAX package
        compiles each noted geometry for a repacked index before the swap;
        the port has nothing to compile, so this only records it."""
        with self._spec_lock:
            self._warm_specs.add((int(k), int(nprobe), None if n_queries is None else int(n_queries)))

    # -- mutation ----------------------------------------------------------
    def add_items(self, items: np.ndarray, ids: np.ndarray) -> None:
        """Append rows into their nearest lists' free slots.  A list that
        would overflow L_pad triggers a repack into the pow2 bucket that
        fits (tombstones reclaimed first).  Duplicate ids fail before any
        state changes."""
        items = np.ascontiguousarray(np.asarray(items), dtype=np.float32)
        ids = np.asarray(ids, dtype=np.int64)
        if items.ndim != 2 or items.shape[1] != self._data.shape[1]:
            raise ValueError(f"items must be (n, {self._data.shape[1]}); got {items.shape}")
        if items.shape[0] != ids.shape[0]:
            raise ValueError(f"{items.shape[0]} items vs {ids.shape[0]} ids")
        if items.shape[0] == 0:
            return
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate ids within the added batch")
        # the assignment outside the lock: the centroids never change
        assign = assign_nearest(
            items, self._cpad[: self._n_lists], self._dev,
            phase="ann.mutate.assign", counter="ann.mutate.assign_blocks",
        )
        with self._lock:
            dup = [int(i) for i in ids if int(i) in self._pos_of_id]
            if dup:
                raise ValueError(f"ids already present in the index: {dup[:8]}{'...' if len(dup) > 8 else ''}")
            demand = np.bincount(assign, minlength=self._nlist_pad)
            repacked = int((self._counts + demand).max()) > self._l_pad
            if repacked:
                live_need = self._counts - self._tombstones.sum(axis=1).astype(np.int64) + demand
                self._repack_locked(shape_bucket(int(live_need.max()), lo=_MIN_LIST_SLOTS))
            norms = item_norms(items)
            order = np.argsort(assign, kind="stable")
            sorted_assign = assign[order]
            # each row's slot offset within its list for this batch
            starts = np.searchsorted(sorted_assign, sorted_assign, side="left")
            within = np.arange(len(order), dtype=np.int64) - starts
            pos = sorted_assign * self._l_pad + self._counts[sorted_assign] + within
            self._data[pos] = items[order]
            self._norms[pos] = norms[order]
            self._ids[pos] = ids[order]
            self._counts += demand
            for i, p in zip(ids[order], pos):
                self._pos_of_id[int(i)] = int(p)
            self._live += items.shape[0]
            if repacked or self._hot_fraction < 1.0:
                staged = self._stage()
            else:
                staged = self._append_rows(pos, items[order], norms[order])
            self._index = staged
            profiling.incr_counter("ann.mutate.adds", items.shape[0])

    def delete_items(self, ids: np.ndarray) -> int:
        """Tombstone rows by user id: the slot's norm becomes +inf and its id
        leaves the map.  Unknown ids are ignored (deletes are idempotent).
        Returns the number of rows deleted."""
        removed: List[int] = []
        with self._lock:
            for i in np.asarray(ids, dtype=np.int64).ravel():
                pos = self._pos_of_id.pop(int(i), None)
                if pos is None:
                    continue
                lst, slot = divmod(pos, self._l_pad)
                self._tombstones[lst, slot] = True
                self._norms[pos] = np.inf
                self._ids[pos] = -1
                removed.append(pos)
            if removed:
                self._live -= len(removed)
                self._dead += len(removed)
                self._index = self._tombstone_rows(np.asarray(removed, np.int64))
                profiling.incr_counter("ann.mutate.deletes", len(removed))
        return len(removed)

    def repack(self, l_pad: Optional[int] = None) -> None:
        """Reclaim the tombstoned slots: the live rows laid out again, L_pad
        from the longest live list (or as given), staged as a new index and
        swapped in; searches in flight finish on the old one."""
        with self._lock:
            self._repack_locked(l_pad)
            self._index = self._stage()

    def to_packed(self) -> PackedIVF:
        """The compacted payload of the live rows: what a model persists
        after a mutation session (ApproximateNearestNeighborsModel
        .freeze_mutations)."""
        with self._lock:
            return self._to_packed_locked()

    # -- internals (lock held) ---------------------------------------------
    def _load_layout(self, layout: tuple) -> None:
        data, norms, self._ids, self._counts, self._cpad, self._c_norm, self._nlist_pad, self._l_pad = layout
        if self._hot_fraction < 1.0 and any(d.type == "cuda" for d in self._mesh.devices):
            # the tier pages from these arrays: pinned, and kept as tensors
            # so that the tier takes them as they are
            self._planes_host = []
            for a in (data, norms):
                t = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
                t.numpy()[...] = a
                self._planes_host.append(t)
            data, norms = (t.numpy() for t in self._planes_host)
        else:
            self._planes_host = [data, norms]
        self._data, self._norms = data, norms
        self._tombstones = np.zeros((self._nlist_pad, self._l_pad), dtype=bool)
        self._dead = 0
        live = self._ids >= 0
        self._pos_of_id: Dict[int, int] = {int(i): int(p) for p, i in zip(np.flatnonzero(live), self._ids[live])}

    def _repack_locked(self, l_pad: Optional[int]) -> None:
        packed = self._to_packed_locked()
        new_l = l_pad or shape_bucket(int(max(packed.counts.max(), 1)), lo=_MIN_LIST_SLOTS)
        self._load_layout(padded_host_layout(packed, l_pad=new_l, mesh=self._mesh))
        self._repacks += 1
        profiling.incr_counter("ann.mutate.repacks")

    def _to_packed_locked(self) -> PackedIVF:
        live_counts = self._counts - self._tombstones.sum(axis=1).astype(np.int64)
        items, ids = [], []
        for lst in range(self._nlist_pad):
            base = lst * self._l_pad
            sl = slice(base, base + int(self._counts[lst]))
            keep = self._ids[sl] >= 0
            items.append(self._data[sl][keep])
            ids.append(self._ids[sl][keep])
        return PackedIVF(
            np.concatenate(items), np.concatenate(ids), live_counts, self._cpad[: self._n_lists].copy(),
            self._n_lists, self._live,
        )

    def _stage(self):
        """A new snapshot from the host mirrors (the id table copied: a
        snapshot's ids never change under a later mutation)."""
        common = (self._ids.copy(), self._counts, self._cpad, self._c_norm, self._nlist_pad, self._l_pad,
                  self._live, self._n_lists, self._mesh)
        if self._hot_fraction < 1.0:
            idx = tiered_stage_padded_layout(*self._planes_host, *common, self._hot_fraction, self._pool_slots)
            profiling.incr_counter("ann.mutate.bytes", int(idx.tier.device_bytes()))
            return idx
        profiling.incr_counter("ann.mutate.bytes", int(self._data.nbytes + self._norms.nbytes))
        return stage_padded_layout(self._data, self._norms, *common)

    def _by_shard(self, pos: np.ndarray):
        """(shard, the selection of `pos` it owns, those positions local to
        the shard's planes) for every shard that owns one of the padded
        positions `pos`."""
        per_shard = self._nlist_pad // self._mesh.size * self._l_pad
        owner = pos // per_shard
        for s in np.unique(owner):
            sel = owner == s
            yield int(s), sel, pos[sel] - int(s) * per_shard

    def _append_rows(self, pos: np.ndarray, rows: np.ndarray, norms: np.ndarray) -> IVFFlatIndex:
        """The add path of a resident index: the new rows and norms written
        into the owner shards' free slots, new counts tensors and id table
        (module header)."""
        old = self._index
        for s, sel, local in self._by_shard(pos):
            dev = self._mesh.devices[s]
            pos_t = torch.from_numpy(local).to(dev)
            old.list_data[s].view(-1, old.dim).index_copy_(0, pos_t, torch.from_numpy(rows[sel]).to(dev))
            old.list_norm[s].view(-1).index_copy_(0, pos_t, torch.from_numpy(norms[sel]).to(dev))
        counts = shard_counts(self._counts, self._mesh)
        profiling.incr_counter("ann.mutate.bytes", int(pos.nbytes + rows.nbytes + norms.nbytes + 4 * self._nlist_pad))
        return IVFFlatIndex(
            mesh=self._mesh, list_data=old.list_data, list_norm=old.list_norm, counts=counts,
            centroids=old.centroids, c_norm=old.c_norm, ids=self._ids.copy(), n_items=self._live,
            n_lists=self._n_lists, nlist_pad=self._nlist_pad, l_pad=self._l_pad, dim=old.dim,
        )

    def _tombstone_rows(self, pos: np.ndarray):
        """The delete path: a new norm plane with +inf at `pos` on each shard
        it touches (tiered: the touched lists' resident copies re-paged),
        and a new id table; the data planes, the other shards' norm planes
        and the counts carry over."""
        old = self._index
        if isinstance(old, TieredIVFFlatIndex):
            old.tier.refresh(np.unique(pos // self._l_pad))
            return TieredIVFFlatIndex(
                mesh=self._mesh, tier=old.tier, counts=old.counts, centroids=old.centroids, c_norm=old.c_norm,
                ids=self._ids.copy(), n_items=self._live, n_lists=self._n_lists, nlist_pad=self._nlist_pad,
                l_pad=self._l_pad, dim=old.dim, hot_fraction=self._hot_fraction,
            )
        norms = list(old.list_norm)
        for s, _sel, local in self._by_shard(pos):
            norms[s] = norms[s].clone()
            norms[s].view(-1).index_fill_(0, torch.from_numpy(local).to(self._mesh.devices[s]), float("inf"))
        profiling.incr_counter("ann.mutate.bytes", int(pos.nbytes))
        return IVFFlatIndex(
            mesh=self._mesh, list_data=old.list_data, list_norm=norms, counts=old.counts, centroids=old.centroids,
            c_norm=old.c_norm, ids=self._ids.copy(), n_items=self._live, n_lists=self._n_lists,
            nlist_pad=self._nlist_pad, l_pad=self._l_pad, dim=old.dim,
        )
