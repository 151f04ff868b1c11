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
# slice_meshes / carve_device_slices carve the device list into the serving
# plane's replica slices (serving/slicepool.py, serving/router.py), in the
# group-major order of parallel/topology.group_major_devices.  On one card,
# N replicas get N single-device slices of cuda:0: the surplus rule below.
#
# Not carried over yet: the 2-D (data, model) mesh and the NamedSharding
# helpers (no engine of the port shards columns).
#

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import device as _device

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: `devices[i]` holds shard i.  Hashable, equal by
    value."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


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


def shard_rows(
    arr: Union[np.ndarray, torch.Tensor], mesh: Mesh, dtype: Optional[torch.dtype] = None
) -> Tuple[List[torch.Tensor], int]:
    """Zero-pad rows to a multiple of the data-axis size and split them into
    contiguous per-shard blocks, block i on mesh.devices[i].  Returns
    (blocks, n_valid_rows); callers mask the padded rows."""
    t = torch.from_numpy(np.ascontiguousarray(arr)) if isinstance(arr, np.ndarray) else arr
    if dtype is not None:
        t = t.to(dtype)
    n_valid = int(t.shape[0])
    n_shards = mesh.shape[DATA_AXIS]
    per = -(-n_valid // n_shards) if n_valid else 0
    blocks = []
    for i, dev in enumerate(mesh.devices):
        part = t[i * per : (i + 1) * per].to(dev)
        if part.shape[0] < per:
            pad = torch.zeros((per - part.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
            part = torch.cat([part, pad])
        blocks.append(part.contiguous())
    return blocks, n_valid

