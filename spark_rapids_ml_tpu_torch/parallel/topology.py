#
# Topology map: which shards share a host (the fast intra-host links) and
# which pairs reach each other only across hosts.
#
# Counterpart of spark_rapids_ml_tpu/parallel/topology.py (this package's own
# copy).  The map feeds the exchange sections (parallel/exchange.py): the
# hierarchical schedules of the gather-class collectives and psum (gather
# within the host group, one gateway exchange across groups, broadcast back
# inside the group), the gateway-aware ring_shift cycle, and the per-link
# `exchange.<name>.ici_bytes` / `.dcn_bytes` byte models ("ici" the
# intra-group links — NVLink between the cards of one host —, "dcn" the
# links between hosts; the names are the JAX package's).
#
# Host groups come from the devices' process.  The port drives every shard
# from one process, so a derived map is flat.  The JAX package's environment
# overrides are arguments here: devs_per_host=g groups shards g at a time
# (SRML_TOPO=hosts:g) — by CUDA device index when the list names distinct
# CUDA devices, by shard position wherever the list repeats a device or
# names the CPU (the JAX package groups by position when ids are
# unavailable) — and pin_flat=True keeps the groups but pins the flat
# schedule (SRML_EXCHANGE_TOPO=flat).
#
# Link accounting model: the split counters are whole-mesh byte models per
# collective call, not measured wire bytes.  A hierarchical schedule charges
# its intra-group stages to ici and its gateway stage to dcn; a flat schedule
# on a multi-group topology offers no locality guarantee, so all its traffic
# is charged to dcn (on a single-group topology everything is ici).
#

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class TopologyMap:
    """Host-group partition of the data axis.

    `groups` holds shard positions (a tuple per host group, groups in
    gateway order, positions ascending within a group).  Hashable, equal by
    value."""

    groups: Tuple[Tuple[int, ...], ...]
    source: str = "flat"  # "process" | "override" | "flat"
    pinned: bool = False  # pin_flat=True at derivation time

    @property
    def n_devices(self) -> int:
        return sum(len(g) for g in self.groups)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def group_size(self) -> int:
        """Uniform group size, or 0 when groups are unequal (a shape the
        hierarchical schedules refuse — they fall back to flat)."""
        sizes = {len(g) for g in self.groups}
        return sizes.pop() if len(sizes) == 1 else 0

    @property
    def group_of(self) -> Tuple[int, ...]:
        out = [0] * self.n_devices
        for k, g in enumerate(self.groups):
            for p in g:
                out[p] = k
        return tuple(out)

    @property
    def gateways(self) -> Tuple[int, ...]:
        """One gateway position per group (its first member): the shard that
        carries the group's cross-host exchange."""
        return tuple(g[0] for g in self.groups)

    @property
    def schedule(self) -> str:
        """"hier" when a two-level schedule is worthwhile and sound: more
        than one group, uniform group size > 1, and not pinned flat.
        Everything else is "flat"."""
        if self.pinned or self.n_groups <= 1 or self.group_size <= 1:
            return "flat"
        return "hier"

    @property
    def is_hierarchical(self) -> bool:
        return self.schedule == "hier"

    def describe(self) -> str:
        """Stable topology string, e.g. "2x4/hier", "1x8/flat",
        "2x4/flat-pinned"."""
        g = self.group_size
        shape = f"{self.n_groups}x{g}" if g else "x".join(str(len(g)) for g in self.groups)
        sched = self.schedule + ("-pinned" if self.pinned else "")
        return f"{shape}/{sched}"


def flat_topology(n_devices: int) -> TopologyMap:
    """The trivial single-group map."""
    return TopologyMap(groups=(tuple(range(n_devices)),), source="flat")


def _group_positions(keys: Sequence[Any]) -> Tuple[Tuple[int, ...], ...]:
    """Partition positions 0..n-1 by key; groups ordered by sorted key,
    positions ascending within each group."""
    by_key: dict = {}
    for pos, k in enumerate(keys):
        by_key.setdefault(k, []).append(pos)
    return tuple(tuple(by_key[k]) for k in sorted(by_key))


def topology_map(
    mesh: Any = None,
    devices: Optional[Sequence[Any]] = None,
    n_devices: Optional[int] = None,
    devs_per_host: Optional[int] = None,
    pin_flat: bool = False,
) -> TopologyMap:
    """The one TopologyMap derivation.  Pass exactly one of `mesh` (a
    parallel.mesh.Mesh), `devices` (an explicit device list: positions are
    list positions) or `n_devices` (positions only).

    Priority: `devs_per_host` (groups of that many shards: by CUDA device
    index over a list of distinct CUDA devices, else by position), then the
    devices' process (one process drives every shard here, so flat).
    `pin_flat` keeps the derived groups but pins the schedule flat."""
    if mesh is not None:
        devices = list(mesh.devices)
    if devices is not None:
        n = len(devices)
    elif n_devices is not None:
        n = int(n_devices)
    else:
        raise ValueError("topology_map needs a mesh, devices, or n_devices")
    if n <= 0:
        raise ValueError(f"topology_map: need at least one device, got {n}")
    if devs_per_host is not None:
        if devs_per_host < 1:
            raise ValueError(f"devs_per_host must be >= 1, got {devs_per_host}")
        keys = [pos // devs_per_host for pos in range(n)]
        if devices is not None:
            devs = [torch.device(d) for d in devices]
            if all(d.type == "cuda" and d.index is not None for d in devs) and len(set(devs)) == n:
                keys = [d.index // devs_per_host for d in devs]
        return TopologyMap(groups=_group_positions(keys), source="override", pinned=pin_flat)
    return TopologyMap(groups=(tuple(range(n)),), source="flat", pinned=pin_flat)


def ring_cycle(topo: TopologyMap, shift: int = 1) -> List[Tuple[int, int]]:
    """Topology-aware ring permutation: one n-cycle that tours each host
    group's shards consecutively with exactly one gateway edge per adjacent
    group pair.  Same (src, dst) pair format as mesh.ring_permutation, which
    this degenerates to when groups are contiguous.  Applied every hop, a
    block visits all n shards and is home after n hops."""
    order = [p for g in topo.groups for p in g]
    n = len(order)
    nxt = {order[j]: order[(j + shift) % n] for j in range(n)}
    return [(p, nxt[p]) for p in range(n)]


# -- per-link byte models ------------------------------------------------------
# Whole-mesh byte split per collective call, from the schedule the collective
# runs.  `nbytes` is the per-shard payload (what `exchange.<name>.bytes`
# records).


def _flat_split(topo: TopologyMap, total: int) -> Tuple[int, int]:
    if topo.n_groups <= 1:
        return total, 0
    return 0, total


def link_split_gather(topo: TopologyMap, nbytes: int) -> Tuple[int, int]:
    """(ici, dcn) for the gather-class collectives (allgather_rows,
    gather_stack, psum_merge): every shard's block reaches every shard.
    Flat: n*(n-1) block movements.  Hierarchical: intra-group gather, one
    g-block frame per ordered group pair across hosts, the gateway's
    rebroadcast of the foreign bytes inside the group."""
    n = topo.n_devices
    if n <= 1:
        return 0, 0
    if not topo.is_hierarchical:
        return _flat_split(topo, n * (n - 1) * nbytes)
    G, g = topo.n_groups, topo.group_size
    ici = n * (g - 1) * nbytes + G * (g - 1) * (n - g) * nbytes
    dcn = G * (G - 1) * g * nbytes
    return ici, dcn


def link_split_reduce(topo: TopologyMap, nbytes: int) -> Tuple[int, int]:
    """(ici, dcn) for psum: like the gather class, but the cross-group
    frame is the group-reduced partial (one block, not g)."""
    n = topo.n_devices
    if n <= 1:
        return 0, 0
    if not topo.is_hierarchical:
        return _flat_split(topo, n * (n - 1) * nbytes)
    G, g = topo.n_groups, topo.group_size
    ici = n * (g - 1) * nbytes + G * (g - 1) * nbytes
    dcn = G * (G - 1) * nbytes
    return ici, dcn


def link_split_ring_hop(topo: TopologyMap, nbytes: int) -> Tuple[int, int]:
    """(ici, dcn) for one ring_shift hop: n simultaneous block sends.  The
    hierarchical cycle pins all but the G gateway edges to ici; the flat
    rotation pins nothing."""
    n = topo.n_devices
    if n <= 1:
        return 0, 0
    if not topo.is_hierarchical:
        return _flat_split(topo, n * nbytes)
    G = topo.n_groups
    return (n - G) * nbytes, G * nbytes


def group_major_devices(devices: Sequence[Any], devs_per_host: Optional[int] = None) -> List[Any]:
    """Reorder a device list group-major (each host group's devices
    consecutive), keeping the order inside a group.  No-op on a flat
    topology."""
    topo = topology_map(devices=list(devices), devs_per_host=devs_per_host)
    if topo.n_groups <= 1:
        return list(devices)
    return [devices[p] for g in topo.groups for p in g]
