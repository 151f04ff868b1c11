#
# The lane engine: the candidate lanes of the batched sweep, and the
# stacked variant lanes of the serving multiplex.
#
# Counterpart of spark_rapids_ml_tpu/ops/lanes.py.  The JAX package pads the
# lanes to a power of two so that grids of 5, 6 and 8 candidates share one
# compiled executable; the port keeps the same lanes (a padded lane repeats
# the first candidate, and its result is discarded), so the two packages run
# the same lane count for a grid.
#
# Serving (serving/multiplex.py): stack_lanes puts K model variants' host
# parameter leaves on the device as one (bucket, ...) tensor per leaf, and
# write_lane pages one variant into one lane slot.  The JAX page-in returns
# a NEW immutable tuple, so an in-flight dispatch keeps the values it was
# routed against.  Here the write is IN PLACE: an H2D copy of the variant
# from a pinned staging buffer into the lane's slice, on the server's copy
# stream, with a CUDA event recorded after it.  In-place is safe because:
#   - the multiplex server writes only a lane whose pending count is 0 (the
#     JAX eviction rule): no queued or in-flight request reads it, and every
#     earlier request that read it resolved after its readback's event
#     wait, so no launch that reads the old values is still on the card;
#   - the request that caused the page-in is admitted only after the event
#     has completed, and each dispatch makes its stream wait on the newest
#     page-in event before it launches, so no launch reads a lane before
#     its write lands;
#   - what else may read a lane while it changes has no reader: the warm-up
#     and recovery re-warm batches (lane 0, outputs discarded) and the rows
#     of a request cancelled while queued.
# The staging buffer comes from torch's pinned host cache, which keeps a
# block until the copies recorded on it complete.  On the CPU the write is
# a plain synchronous copy and there is no event.  Each leaf's write is a
# key of the warm cache (ops/precompile.py) under `<name>.write<i>`: the
# multiplex server warms it at construction by rewriting lane 0, so a
# page-in adds no steady-state warm-up.
#

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import precompile


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


# -- serving-side lane stacking / paging -------------------------------------


def by_lane(X: torch.Tensor, lanes: torch.Tensor, fn: Callable[[torch.Tensor, int], torch.Tensor]) -> torch.Tensor:
    """Run `fn(rows, lane)` once per distinct lane of `lanes` ((N,) lane ids
    of X's rows, on any device; read on the host) on that lane's rows, and
    put the outputs back in row order.  The rows are grouped by one gather
    (stable, so a lane's rows keep their order) and scattered back by one
    index_copy_; a batch of one lane calls fn on X itself."""
    host = lanes.cpu().numpy()
    first = int(host[0])
    if (host == first).all():
        return fn(X, first)
    order = np.argsort(host, kind="stable")
    cuts = np.flatnonzero(np.diff(host[order])) + 1
    order_dev = torch.from_numpy(order).to(X.device)
    Xs = X.index_select(0, order_dev)  # each lane's rows contiguous
    bounds = zip(np.concatenate([[0], cuts]).tolist(), np.concatenate([cuts, [len(host)]]).tolist())
    grouped = torch.cat([fn(Xs[a:b], int(host[order[a]])) for a, b in bounds])
    return torch.empty_like(grouped).index_copy_(0, order_dev, grouped)



def stack_lanes(leaves_list: Sequence[tuple], bucket: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """K variants' host parameter leaves -> one lane-stacked tensor per leaf
    position on `device`: leaf i has shape (bucket,) + leaf shape (a 0-d
    leaf gives (bucket,)).  Pad lanes repeat variant 0: a duplicate lane
    computes a real lane's math and nothing routes to it."""
    if not leaves_list:
        raise ValueError("stack_lanes: at least one variant is required")
    if bucket < len(leaves_list):
        raise ValueError(f"stack_lanes: bucket {bucket} < {len(leaves_list)} variants")
    stacked = []
    for i in range(len(leaves_list[0])):
        rows = [np.asarray(v[i]) for v in leaves_list]
        rows += [rows[0]] * (bucket - len(rows))
        stacked.append(torch.from_numpy(np.stack(rows, axis=0)).to(device))
    return tuple(stacked)


def lane_write_kernel(buf: torch.Tensor, val: torch.Tensor, lane: int) -> torch.Tensor:
    """One lane page-in, in place: buf[lane] <- val (non-blocking when `val`
    is pinned host memory and `buf` is on the card); returns buf."""
    buf[lane].copy_(val, non_blocking=True)
    return buf


def write_lane(
    stacked: Tuple[torch.Tensor, ...],
    lane: int,
    leaves: tuple,
    *,
    name: str,
    stream: Optional["torch.cuda.Stream"] = None,
) -> Optional["torch.cuda.Event"]:
    """Page one variant's host leaves into lane slot `lane` of the stacked
    tensors, in place (module header).  On the card the copies run on
    `stream` from pinned staging buffers and the returned event follows
    them; the caller waits on it before it routes rows to the lane.  On the
    CPU the copies are synchronous and the result is None."""
    dev = stacked[0].device
    cuda = dev.type == "cuda"
    for i, (buf, val) in enumerate(zip(stacked, leaves)):
        precompile.dispatch(precompile.warm_key(f"{name}.write{i}", buf.shape[0], buf.dtype, dev))
        # a staging tensor of the slot's shape and dtype (a 0-d leaf stays 0-d)
        src = torch.empty(buf.shape[1:], dtype=buf.dtype, pin_memory=cuda)
        src.numpy()[...] = np.asarray(val)
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            lane_write_kernel(buf, src, lane)
    if not cuda:
        return None
    done = torch.cuda.Event()
    done.record(stream)
    return done
