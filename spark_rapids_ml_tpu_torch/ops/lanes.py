#
# The candidate lane engine of the batched sweep: the lane bucket, lane
# padding and the packing of a candidate subset into lane vectors.
#
# Counterpart of lane_bucket, pad_lanes and pack_lane_subset in
# spark_rapids_ml_tpu/ops/lanes.py.  The JAX package pads the lanes to a
# power of two so that grids of 5, 6 and 8 candidates share one compiled
# executable; the port keeps the same lanes (a padded lane repeats the first
# candidate, and its result is discarded), so the two packages run the same
# lane count for a grid.
# Not carried over yet: stack_lanes, write_lane and lane_write_kernel, which
# serve the serving multiplex and the ANN tier (ROADMAP A13b).
#

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def lane_bucket(m: int) -> int:
    """The power-of-two lane count (at least 1) that holds `m` lanes."""
    b = 1
    while b < m:
        b *= 2
    return b


def pad_lanes(values: Sequence[float], bucket: int) -> np.ndarray:
    """(m,) lane values -> (bucket,) float64, padded with the first value (a
    duplicate lane converges as its original does; its output is
    discarded)."""
    out = np.full(bucket, values[0], dtype=np.float64)
    out[: len(values)] = np.asarray(values, dtype=np.float64)
    return out


def pack_lane_subset(
    candidates: Sequence[tuple],
    idxs: Sequence[int],
    fields: Tuple[int, ...] = (0,),
    device: Optional[torch.device] = None,
) -> Tuple[int, Tuple[torch.Tensor, ...]]:
    """Select `idxs` of the candidate grid, bucket them, and build one padded
    float64 lane vector per requested tuple field, on `device`.  Returns
    (bucket, (lane vector per field, in `fields` order))."""
    bucket = lane_bucket(len(idxs))
    vecs = tuple(
        torch.as_tensor(pad_lanes([candidates[i][f] for i in idxs], bucket), device=device) for f in fields
    )
    return bucket, vecs
