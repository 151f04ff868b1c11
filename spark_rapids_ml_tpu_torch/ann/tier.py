#
# Tiered device / host-RAM residency for IVF list planes.
#
# Counterpart of spark_rapids_ml_tpu/ann/tier.py.  The flat and PQ indexes
# stage every padded list on the device, so device memory caps the item
# count long before host RAM does.  This module keeps a fixed POOL of list
# slots on each shard of a mesh (parallel/mesh.py; shard s owns the whole
# lists [s * lps, (s + 1) * lps)) and pages the rest in on demand from the
# host-RAM padded layout:
#
#   hot lists:   the top hot_fraction of each shard's lists by population
#                (denser regions win more probes; ties by list id) are
#                pinned into the shard's pool at stage time and never
#                evicted.
#   cold lists:  stay in host memory; when a query probes one, it pages into
#                an LRU slot with one host-to-device copy per plane.
#   sentinel:    slot 0 of every shard is reserved and carries +inf in the
#                scoring plane (norms / ADC scalars), so a list probed while
#                not resident scores +inf and loses to every real candidate:
#                a residency bug degrades recall, it cannot corrupt results.
#
# The probe sweeps gather through a (nlist_pad,) list -> local slot map (0 =
# not resident), one copy on each shard's device.  Gathering through the map
# returns the bytes the resident planes hold, so a tiered search is bitwise
# the resident one, on any mesh.  The sweeps plan and page one shard at a
# time (plan_groups / acquire with `shard`); a one-shard tier is the tier of
# one device.
#
# What changes on the way: JAX arrays are immutable and dispatch is
# asynchronous, so the JAX tier replaces its buffers on every page-in.  Here
# a page-in writes its slot in place: the copy is queued on the current
# stream after every search kernel already queued, so a kernel that reads
# the slot's previous list runs before the slot is overwritten.  The host
# planes are held in pinned memory on a CUDA device, so the copies are
# asynchronous; planes given as pinned tensors are used as they are (the
# live index, ann/mutable.py, passes its own host mirrors so that its edits
# reach every later page-in, and refresh() re-pages the resident copies of
# the lists it edits).  The slot map is uploaded anew at each acquire() that
# paged.  Counters are plain integers on the object, summed over the shards
# (stats()).
#

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.exchange import replicate
from ..parallel.mesh import as_mesh

# smallest cold-list pool: even a tiny index keeps a few slots so the LRU
# has room to avoid thrashing a single slot
_MIN_POOL_SLOTS = 8


class TieredListPlanes:
    """Per-shard device slot pools for K parallel (nlist_pad, l_pad, ...)
    list planes plus the list -> slot map the tiered probe sweeps gather
    through.

    `planes` are the host padded layouts; `sentinels` gives the fill value
    of each plane's sentinel slot (+inf for the scoring plane, None to leave
    it zero); `counts` ranks the lists for the hot split and lets empty
    lists skip the pool; `device` is a device (one shard) or a
    parallel.mesh.Mesh, whose data axis splits the lists."""

    def __init__(
        self,
        planes: Sequence[np.ndarray],
        sentinels: Sequence[Optional[float]],
        counts: np.ndarray,
        device,
        hot_fraction: float,
        pool_slots: Optional[int] = None,
    ):
        if not planes:
            raise ValueError("at least one list plane is required")
        nlist_pad = int(planes[0].shape[0])
        if any(int(p.shape[0]) != nlist_pad for p in planes):
            raise ValueError("every plane must share the list axis")
        if len(sentinels) != len(planes):
            raise ValueError("one sentinel fill value per plane")
        if not 0.0 <= float(hot_fraction) <= 1.0:
            raise ValueError(f"hot_fraction ({hot_fraction}) must be in [0, 1]")
        self.mesh = as_mesh(device)
        self.n_dev = self.mesh.size
        if nlist_pad % self.n_dev:
            raise ValueError(f"{nlist_pad} padded lists do not shard over {self.n_dev} devices")
        self.nlist_pad = nlist_pad
        self.lps = nlist_pad // self.n_dev
        self._counts = np.asarray(counts, np.int64)
        self._hot_per_shard = int(min(self.lps, math.ceil(float(hot_fraction) * self.lps)))
        self.pool_slots = int(
            pool_slots if pool_slots is not None else max(_MIN_POOL_SLOTS, self.lps - self._hot_per_shard)
        )
        if self.pool_slots < 1:
            raise ValueError(f"pool_slots ({pool_slots}) must be >= 1")
        # per-shard slot layout: [0] sentinel, [1 .. h] pinned hot, [1 + h ..] the LRU pool
        self.slots_per_shard = 1 + self._hot_per_shard + self.pool_slots
        self._host = [p if isinstance(p, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(p)) for p in planes]
        if any(d.type == "cuda" for d in self.mesh.devices):
            self._host = [h if h.is_pinned() else h.pin_memory() for h in self._host]
        self._lock = threading.Lock()
        self._slot_of: Dict[int, int] = {}
        self._hot_ids: set = set()
        self._lru: List[OrderedDict] = [OrderedDict() for _ in range(self.n_dev)]  # pool slot -> list id
        self._free: List[List[int]] = [
            list(range(1 + self._hot_per_shard, self.slots_per_shard))[::-1] for _ in range(self.n_dev)
        ]
        self.hits = self.misses = self.evictions = self.page_bytes = self.refreshes = 0
        self._stage_initial(sentinels)

    # -- staging -----------------------------------------------------------
    def _hot_lists_of_shard(self, s: int) -> np.ndarray:
        ids = np.arange(s * self.lps, (s + 1) * self.lps, dtype=np.int64)
        # probe-frequency proxy: list population, ties by id
        hot = ids[np.lexsort((ids, -self._counts[ids]))][: self._hot_per_shard]
        return hot[self._counts[hot] > 0]

    def _stage_initial(self, sentinels) -> None:
        self._map = np.zeros(self.nlist_pad, np.int64)
        self._planes = []
        for dev in self.mesh.devices:
            bufs = []
            for host, sent in zip(self._host, sentinels):
                buf = torch.zeros((self.slots_per_shard,) + tuple(host.shape[1:]), dtype=host.dtype, device=dev)
                if sent is not None:
                    buf[0] = sent
                bufs.append(buf)
            self._planes.append(bufs)
        for s in range(self.n_dev):
            for j, g in enumerate(self._hot_lists_of_shard(s)):
                self._write_planes(s, 1 + j, int(g))
                self._map[g] = 1 + j
                self._slot_of[int(g)] = 1 + j
                self._hot_ids.add(int(g))
        self.page_bytes = 0  # staging is not paging
        self._upload_map()

    def _upload_map(self) -> None:
        self._map_dev = replicate(torch.from_numpy(self._map.copy()), self.mesh.devices)

    # -- sizing ------------------------------------------------------------
    def device_bytes(self) -> int:
        return int(sum(b.nbytes for bufs in self._planes for b in bufs) + 8 * self.nlist_pad)

    def host_bytes(self) -> int:
        return int(sum(h.nbytes for h in self._host))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "shards": self.n_dev,
                "hot_lists": self.n_dev * self._hot_per_shard,
                "hot_per_shard": self._hot_per_shard,
                "pool_slots": self.pool_slots,
                "slots": self.n_dev * self.slots_per_shard,
                "resident_lists": len(self._slot_of),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "page_bytes": self.page_bytes,
                "refreshes": self.refreshes,
                "device_bytes": self.device_bytes(),
                "host_bytes": self.host_bytes(),
            }

    # -- paging ------------------------------------------------------------
    def _owned(self, g: int, shard: int) -> bool:
        return 0 <= g < self.nlist_pad and g // self.lps == shard and self._counts[g] > 0

    def plan_groups(self, probes: np.ndarray, shard: int = 0) -> List[Tuple[int, int]]:
        """Split a (Q, nprobe) probe table into contiguous query ranges whose
        distinct cold probed lists of `shard` fit its pool, so every range
        can be paged in whole before it is scored.  A single query needing
        more cold lists than the pool holds is a typed error."""
        n_q = int(probes.shape[0])
        groups: List[Tuple[int, int]] = []
        need: set = set()
        start = 0
        for i in range(n_q):
            row = {int(g) for g in probes[i] if self._owned(int(g), shard) and int(g) not in self._hot_ids}
            if len(row) > self.pool_slots:
                raise ValueError(
                    f"one query probes more cold lists than the tier pool holds "
                    f"({self.pool_slots} slots a shard); restage with a larger pool"
                )
            if len(need | row) > self.pool_slots:
                groups.append((start, i))
                start = i
                need = set()
            need |= row
        groups.append((start, n_q))
        return groups

    def acquire(self, lists: Sequence[int], shard: int = 0):
        """Page every list of `shard` among `lists` into the shard's pool
        (LRU eviction; pinned hot lists stay) and return (the shard's
        device planes, the list -> slot map on its device) to gather
        through.  Already resident requests are touched first, so an
        eviction never takes a list this call needs (plan_groups bounds the
        cold requests by the pool size)."""
        with self._lock:
            req = [g for g in sorted({int(g) for g in lists}) if self._owned(g, shard)]
            misses = []
            for g in req:
                slot = self._slot_of.get(g)
                if slot is None:
                    misses.append(g)
                    continue
                self.hits += 1
                if g not in self._hot_ids:
                    self._lru[shard].move_to_end(slot)
            for g in misses:
                self._page_in_locked(shard, g)
            if misses:
                self._upload_map()
            return tuple(self._planes[shard]), self._map_dev[shard]

    def refresh(self, lists: Sequence[int]) -> None:
        """Re-page the resident lists among `lists` from the (just edited)
        host planes: a live delete's tombstones reach the resident copies at
        once, and the other lists pick the edit up at their next page-in."""
        with self._lock:
            for g in sorted({int(g) for g in lists}):
                slot = self._slot_of.get(g)
                if slot is not None:
                    self._write_planes(g // self.lps, slot, g)
                    self.refreshes += 1

    def _page_in_locked(self, s: int, g: int) -> None:
        self.misses += 1
        if self._free[s]:
            slot = self._free[s].pop()
        else:
            slot, evicted = self._lru[s].popitem(last=False)
            del self._slot_of[evicted]
            self._map[evicted] = 0
            self.evictions += 1
        self._write_planes(s, slot, g)
        self._map[g] = slot
        self._slot_of[g] = slot
        self._lru[s][slot] = g

    def _write_planes(self, s: int, slot: int, g: int) -> None:
        for buf, host in zip(self._planes[s], self._host):
            buf[slot].copy_(host[g], non_blocking=True)
            self.page_bytes += int(host[g].nbytes)
