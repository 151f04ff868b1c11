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
# Not carried over yet: the 2-D (data, model) mesh and the NamedSharding
# helpers (no engine of the port shards columns), slice_meshes and
# carve_device_slices (the serving router's replica slices, with serving).
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

