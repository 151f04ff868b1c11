#
# The device mesh and row-sharded ingest.
#
# Counterpart of spark_rapids_ml_tpu/parallel/mesh.py, single-controller as
# the JAX package is: one process drives every shard.  A mesh is an ordered
# tuple of torch devices, one per shard along the one data axis; a device may
# repeat, so ["cpu"] * 8 is an 8-shard mesh on the CPU and ["cuda:0"] * 4 a
# 4-shard mesh on one card (the counterpart of the JAX package's forced host
# device count).  A sharded value is a list of per-shard tensors, shard i on
# mesh.devices[i]; the collectives over such lists are parallel/exchange.py.
#
# shard_rows is the row-sharded ingest of every batch fit (core._TpuCaller
# ._build_fit_inputs): rows zero-padded to a multiple of the shard count, as
# the JAX package pads them, each shard filled straight from the frame's
# partitions.  Shard i holds global rows [i * per, (i + 1) * per), so the
# padded rows all sit at the end, past every valid row, and a draw that
# indexes global rows below n gives the same value on any shard count.
#
# slice_meshes / carve_device_slices carve the device list into the serving
# plane's replica slices (serving/slicepool.py, serving/router.py), in the
# group-major order of parallel/topology.group_major_devices.  On one card,
# N replicas get N single-device slices of cuda:0: the surplus rule below.
#
# A mesh may span processes (the multi-controller layer, parallel/runner.py):
# one process a rank, each driving `devices`, its local shards, with
# `rank`, `nranks` and the torch.distributed process `group` of the job.
# Global shard r * len(devices) + i is shard i of rank r, process-major as
# the JAX package's global_mesh orders it, and `size` counts the global
# shards.  A sharded value holds this rank's local shards only.  While a
# multi-process fit runs on a thread, process_scope makes its mesh that
# thread's process_mesh(): the collectives of parallel/exchange.py then take
# their cross-process forms, and valid_spans / global_row_base place the
# local shards' rows among the job's rows, so a solver written for one
# process runs unchanged across ranks.
#
# Not carried over yet: the 2-D (data, model) mesh and the NamedSharding
# helpers (no engine of the port shards columns).
#

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import device as _device

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: `devices[i]` holds this process's shard i, global
    shard rank * len(devices) + i of a mesh over `nranks` processes (module
    header).  Hashable, equal by value (the process group aside)."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    nranks: int = 1
    group: Any = field(default=None, compare=False, repr=False)
    backend: str = field(default="", compare=False)

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if not 0 <= self.rank < self.nranks:
            raise ValueError(f"rank {self.rank} outside 0..{self.nranks - 1}")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.size}

    @property
    def size(self) -> int:
        """Global shard count: every rank's shards."""
        return len(self.devices) * self.nranks

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def shard_offset(self) -> int:
        """Global index of this rank's first shard."""
        return self.rank * len(self.devices)


_WORLD = threading.local()


def process_mesh() -> Optional[Mesh]:
    """The multi-process mesh of the fit running on this thread (inside
    process_scope), or None."""
    return getattr(_WORLD, "mesh", None)


@contextlib.contextmanager
def process_scope(mesh: Mesh) -> Iterator[Mesh]:
    """Make `mesh` this thread's process_mesh() for the block (a mesh of one
    process leaves it None)."""
    prev = (process_mesh(), getattr(_WORLD, "rank_rows", None))
    _WORLD.mesh = mesh if mesh.nranks > 1 else None
    _WORLD.rank_rows = None
    try:
        yield mesh
    finally:
        _WORLD.mesh, _WORLD.rank_rows = prev


def set_rank_rows(rank_rows: Sequence[int]) -> None:
    """The valid rows each rank holds of the dataset the current fit staged
    (runner.DistributedFitSession.build_fit_inputs): valid_spans reads them."""
    _WORLD.rank_rows = tuple(int(r) for r in rank_rows)


def valid_spans(shard_rows: Sequence[int], n_rows: int) -> List[Tuple[int, int]]:
    """(global index of the first valid row, valid rows) of each local shard
    of a row-sharded dataset whose shards hold `shard_rows` rows: one
    process pads past the n_rows valid rows, at the end; across processes
    each rank's valid rows come first in its share and the valid rows are
    numbered rank by rank (set_rank_rows)."""
    mesh, rank_rows = process_mesh(), getattr(_WORLD, "rank_rows", None)
    if mesh is None or rank_rows is None:
        offset, mine = 0, int(n_rows)
    else:
        offset, mine = sum(rank_rows[: mesh.rank]), rank_rows[mesh.rank]
    out, at = [], 0
    for n_loc in shard_rows:
        take = max(0, min(int(n_loc), mine - at))
        out.append((offset + at, take))
        at += int(n_loc)
    return out


def global_row_base(shard_rows: Sequence[int]) -> List[int]:
    """Global padded position of each local shard's first row (every rank's
    share holds the same rows)."""
    mesh = process_mesh()
    base = mesh.rank * sum(int(n) for n in shard_rows) if mesh is not None else 0
    out = []
    for n_loc in shard_rows:
        out.append(base)
        base += int(n_loc)
    return out


def as_mesh(where: Union[Mesh, torch.device, str, None] = None) -> Mesh:
    """The mesh a staging call names: a Mesh as it is, a device as a
    one-shard mesh, None as the entry points' device."""
    if isinstance(where, Mesh):
        return where
    return Mesh((torch.device(where) if where is not None else _device.resolve(),))


def default_num_workers() -> int:
    """One logical worker per device of the entry points' device list
    (device.devices())."""
    return len(_device.devices())


def get_mesh(num_workers: Optional[int] = None) -> Mesh:
    """1-D data mesh over the first `num_workers` devices of the device
    list (all of them when None)."""
    devices = _device.devices()
    n = num_workers or len(devices)
    n = min(n, len(devices))
    return Mesh(tuple(devices[:n]))


def slice_meshes(n_slices: int, devices=None, devs_per_host: Optional[int] = None) -> List[Mesh]:
    """`n_slices` disjoint 1-D meshes over the device list (default: the
    entry points' device.devices()), carved group-major so a contiguous
    slice stays inside a host group when the count allows.  With fewer
    devices than slices the surplus slices each get ONE device,
    round-robin (the JAX package's rule)."""
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    from . import topology

    devs = list(devices) if devices is not None else list(_device.devices())
    devs = topology.group_major_devices(devs, devs_per_host)
    per = len(devs) // n_slices
    out = []
    for i in range(n_slices):
        local = devs[i * per : (i + 1) * per] if per >= 1 else [devs[i % len(devs)]]
        out.append(Mesh(tuple(local)))
    return out


def carve_device_slices(devices, slice_devices: int, devs_per_host: Optional[int] = None) -> List[list]:
    """The device list cut into as many disjoint `slice_devices`-sized
    groups as it holds (the slice pool's carve).  When host groups are
    known and a slice fits in one, the carve runs per group and devices left
    over inside a group are stranded; otherwise contiguous group-major
    runs."""
    if slice_devices < 1:
        raise ValueError(f"slice_devices must be >= 1, got {slice_devices}")
    from . import topology

    devs = list(devices) if devices is not None else list(_device.devices())
    topo = topology.topology_map(devices=devs, devs_per_host=devs_per_host)
    out = []
    if topo.n_groups > 1 and slice_devices <= min(len(g) for g in topo.groups):
        for g in topo.groups:
            members = [devs[p] for p in g]
            for i in range(len(members) // slice_devices):
                out.append(members[i * slice_devices : (i + 1) * slice_devices])
        return out
    ordered = topology.group_major_devices(devs, devs_per_host)
    for i in range(len(ordered) // slice_devices):
        out.append(ordered[i * slice_devices : (i + 1) * slice_devices])
    return out


def ring_permutation(n_dev: int, shift: int = 1) -> List[Tuple[int, int]]:
    """The (source, destination) pairs of a +shift rotation along the data
    axis: the one definition of the mesh's flat ring order
    (exchange.DeviceSection.ring_shift)."""
    return [(i, (i + shift) % n_dev) for i in range(n_dev)]


# Row-pad multiple of sharded engines whose random streams index global
# padded positions: padding to lcm(64, n_shards) keeps the padded geometry
# the same on every mesh size that divides 64.
ROW_PAD_LANES = 64


def padded_row_count(n: int, mesh: Optional[Mesh] = None) -> int:
    """Rows padded up to a multiple of lcm(ROW_PAD_LANES, data-axis size)."""
    mult = ROW_PAD_LANES
    if mesh is not None:
        mult = math.lcm(mult, mesh.shape[DATA_AXIS])
    return -(-max(n, 1) // mult) * mult


def as_shards(x: Any) -> list:
    """A sharded value as its list of per-shard parts: a list or tuple as it
    is, anything else (one tensor) as the one-shard list [x]."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def shard_row_count(n: int, n_shards: int) -> int:
    """Rows of each shard when n rows are padded to a multiple of n_shards:
    shard i holds global rows [i * per, (i + 1) * per), valid below n."""
    return -(-n // n_shards) if n else 0


def shard_rows(
    arr: Union[np.ndarray, torch.Tensor, Sequence[Any]], mesh: Mesh, dtype: Optional[torch.dtype] = None
) -> Tuple[List[torch.Tensor], int]:
    """Zero-pad rows to a multiple of the mesh's local shard count and split
    them into contiguous per-shard blocks, block i on mesh.devices[i].  Returns
    (blocks, n_valid_rows); callers mask the padded rows.

    `arr` is one array or tensor, or a sequence of row blocks (a frame's
    partitions, numpy or torch) taken as their concatenation: each shard is
    filled straight from the blocks that overlap it, with no host concat.
    A tensor already on a shard's device is sliced, not copied, where its
    rows fill the shard (one shard of a one-device mesh is the tensor
    itself); host arrays are always copied."""
    blocks_in = list(arr) if isinstance(arr, (list, tuple)) else [arr]
    # host arrays are always copied: a staged shard never aliases the
    # caller's numpy block
    from_host = any(isinstance(b, np.ndarray) for b in blocks_in)
    parts_in = [torch.from_numpy(np.ascontiguousarray(b)) if isinstance(b, np.ndarray) else b for b in blocks_in]
    if dtype is not None:
        parts_in = [t if t.dtype == dtype else t.to(dtype) for t in parts_in]
    n_valid = sum(int(t.shape[0]) for t in parts_in)
    n_shards = mesh.local_size
    per = shard_row_count(n_valid, n_shards)
    tail = tuple(parts_in[0].shape[1:])
    starts = np.cumsum([0] + [int(t.shape[0]) for t in parts_in])
    out = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = i * per, (i + 1) * per
        pieces = [
            (t[max(lo, s0) - s0 : min(hi, s1) - s0], max(lo, s0) - lo)
            for t, s0, s1 in zip(parts_in, starts[:-1], starts[1:])
            if s0 < hi and s1 > lo
        ]
        if not from_host and len(pieces) == 1 and pieces[0][0].shape[0] == per and pieces[0][0].device == dev:
            out.append(pieces[0][0].contiguous())
            continue
        block = torch.empty((per,) + tail, dtype=parts_in[0].dtype, device=dev)
        filled = 0
        for piece, at in pieces:
            block[at : at + piece.shape[0]].copy_(piece)
            filled = at + piece.shape[0]
        if filled < per:
            block[filled:].zero_()
        out.append(block)
    return out, n_valid
