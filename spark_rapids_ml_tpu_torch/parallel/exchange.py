#
# The in-mesh exchange: typed collective sections over sharded values.
#
# Counterpart of the in-mesh half of spark_rapids_ml_tpu/parallel/exchange.py,
# single-controller as the JAX package is.  A sharded value is a list of
# per-shard tensors, shard i on the mesh's i-th device (parallel/mesh.py);
# where the JAX package calls a collective inside a shard_map body over one
# shard, the port calls it once over the list.  Every engine names its call
# site (`device_collective("knn.ring_q")`, ...) and gets uniform
# `exchange.<name>.bytes` / `.calls` / `.time_ns` counters (profiling.py)
# and a host range of the same name in torch.profiler traces.  The JAX
# package counts a device section once per trace (a compiled geometry); the
# port runs eagerly and counts once per call.  `.bytes` is the per-shard
# payload, as there.
#
# The collectives: allgather_rows (row blocks concatenated, replicated),
# gather_stack and psum_merge (blocks stacked along a new leading shard axis,
# replicated; gather_to_first the same slab on shard 0's device only), psum
# (element-wise sum, replicated) and ring_shift (each shard sends its block
# to its ring successor and receives its predecessor's: the kNN ring's hop).
# A replicated result is one tensor per shard, on the shard's device; shards
# that share a device share the tensor.  With a
# hierarchical topology (parallel/topology.py) the gather class and psum run
# the two-level schedule — gathered (or summed) inside each host group on its
# gateway, one exchange between gateways, broadcast back inside the group —
# and ring_shift follows the gateway cycle; the movement collectives are
# bitwise the flat schedule, psum is re-associated.  Every method also
# records its modeled traffic split into `.ici_bytes` / `.dcn_bytes`.
#
# psum_fields is the batch fits' reduction over shards (the KMeans, PCA and
# GLM statistics, the logistic objective, the forest engine's histograms):
# each shard's partial sums flattened into one vector, one psum_parts, the
# totals on shard 0's device, where the replicated solve runs; replicate
# hands a replicated operand (centers, coefficients) back to every shard.
#
# ring_shift runs kernel B11 (ops/exchange_kernels.ring_shift) on CUDA
# tensors, the flat rotation and the gateway cycle alike; with one shard it
# returns its input and launches nothing.
#
# Not carried over yet: the host-frame helpers (pack_arrays, allgather_bytes,
# ring_pass_bytes, alltoall_bytes), which move bytes between processes over a
# control plane: they come with the multi-controller layer.
#

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import profiling
from ..ops import exchange_kernels
from . import topology
from .mesh import ring_permutation

Sharded = List[torch.Tensor]


@contextlib.contextmanager
def section(name: str, nbytes: Optional[int] = None) -> Iterator[None]:
    """A collective section: a host range named `exchange.<name>` and the
    `.calls`, `.time_ns` (host clock) and `.bytes` counters."""
    full = f"exchange.{name}"
    t0 = time.perf_counter()
    with record_function(full):
        yield
    profiling.incr_counter(f"{full}.calls")
    profiling.incr_counter(f"{full}.time_ns", int((time.perf_counter() - t0) * 1e9))
    if nbytes:
        profiling.incr_counter(f"{full}.bytes", int(nbytes))


def _nbytes(t: torch.Tensor) -> int:
    return t.element_size() * t.numel()


def device_section(name: str, xs: Sharded):
    """The section of one in-mesh collective call over the sharded value
    `xs`: its per-shard payload bytes (shard 0's block) are recorded."""
    return section(name, _nbytes(xs[0]))


def _record_link_bytes(name: str, ici: int, dcn: int) -> None:
    """Per-link split counters beside `.bytes`: `exchange.<name>.ici_bytes`
    / `.dcn_bytes` are whole-mesh byte models of the schedule that ran
    (topology.link_split_*), where `.bytes` stays the per-shard payload.
    The `_bytes` suffix keeps them out of byte_totals()'s `.bytes` scan."""
    if ici:
        profiling.incr_counter(f"exchange.{name}.ici_bytes", int(ici))
    if dcn:
        profiling.incr_counter(f"exchange.{name}.dcn_bytes", int(dcn))


def _replicate(value: torch.Tensor, xs: Sharded) -> Sharded:
    """One copy of `value` per shard, on the shard's device (shards that
    share a device share it)."""
    return replicate(value, [x.device for x in xs])


class DeviceSection:
    """Typed handle for one named in-mesh collective section.  Construct via
    device_collective(name[, topo]).  Every method takes a sharded value (a
    list of per-shard tensors of one shape and dtype, shard i on the mesh's
    i-th device) and returns one.

    With a hierarchical topology.TopologyMap attached, the gather-class
    collectives and psum run the two-level schedule and ring_shift follows
    the gateway cycle; every method splits its modeled traffic into
    `.ici_bytes` / `.dcn_bytes`."""

    __slots__ = ("name", "topo")

    def __init__(self, name: str, topo: Optional[topology.TopologyMap] = None):
        self.name = name
        self.topo = topo

    def _resolved(self, n_dev: int) -> topology.TopologyMap:
        """The attached map when it matches the shard count, else the flat
        map."""
        if self.topo is not None and self.topo.n_devices == n_dev:
            return self.topo
        return topology.flat_topology(n_dev)

    def _hier_slab(self, xs: Sharded, topo: topology.TopologyMap) -> torch.Tensor:
        """The (n_dev, ...) all-shards slab by the two-level schedule: each
        host group's blocks gathered on its gateway, one frame of g blocks
        between every pair of gateways, the slab assembled on the first
        gateway.  A movement only, so bitwise the flat stack."""
        parts = {}
        for g in topo.groups:
            gate = xs[g[0]].device
            parts[g] = torch.stack([xs[p].to(gate) for p in g])
        home = xs[topo.gateways[0]].device
        slab = torch.empty((len(xs),) + tuple(xs[0].shape), dtype=xs[0].dtype, device=home)
        for g, part in parts.items():
            slab[list(g)] = part.to(home)
        return slab

    def _stack(self, xs: Sharded, topo: topology.TopologyMap) -> torch.Tensor:
        if topo.is_hierarchical:
            return self._hier_slab(xs, topo)
        home = xs[0].device
        return torch.stack([x.to(home) for x in xs])

    def _gathered(self, xs: Sharded) -> torch.Tensor:
        """The (n_dev, ...) slab of a gather, with its link bytes recorded."""
        topo = self._resolved(len(xs))
        _record_link_bytes(self.name, *topology.link_split_gather(topo, _nbytes(xs[0])))
        return self._stack(xs, topo)

    def allgather_rows(self, xs: Sharded) -> Sharded:
        """Per-shard row blocks concatenated along axis 0, replicated."""
        with device_section(self.name, xs):
            slab = self._gathered(xs)
            return _replicate(slab.reshape((-1,) + tuple(xs[0].shape[1:])), xs)

    def gather_stack(self, xs: Sharded) -> Sharded:
        """Per-shard blocks stacked along a new leading (n_dev, ...) axis,
        replicated."""
        with device_section(self.name, xs):
            return _replicate(self._gathered(xs), xs)

    def gather_to_first(self, xs: Sharded) -> torch.Tensor:
        """gather_stack's slab on shard 0's device alone, for a caller that
        merges there (the exact kNN search's candidate pools): no copy goes
        to the other shards' devices.  Counted as gather_stack."""
        with device_section(self.name, xs):
            return self._gathered(xs).to(xs[0].device)

    def psum(self, xs: Sharded) -> Sharded:
        """Element-wise sum of the per-shard partials, replicated; summed in
        shard order.  The hierarchical schedule sums within each group on
        its gateway first, then the group partials in group order: the sum
        is re-associated, so for floats it is not bitwise the flat one."""
        with device_section(self.name, xs):
            topo = self._resolved(len(xs))
            _record_link_bytes(self.name, *topology.link_split_reduce(topo, _nbytes(xs[0])))
            if topo.is_hierarchical:
                partials = []
                for g in topo.groups:
                    gate = xs[g[0]].device
                    part = xs[g[0]].to(gate, copy=True)
                    for p in g[1:]:
                        part += xs[p].to(gate)
                    partials.append(part)
                home = partials[0].device
                total = partials[0]
                for part in partials[1:]:
                    total += part.to(home)
            else:
                home = xs[0].device
                total = xs[0].to(home, copy=True)
                for x in xs[1:]:
                    total += x.to(home)
            return _replicate(total, xs)

    def psum_merge(self, xs: Sharded) -> Sharded:
        """Per-shard candidate blocks stacked into one (n_dev, ...) slab,
        replicated: the JAX package's psum of zero slabs, which is exact as
        a gather, so here a gather."""
        return self.gather_stack(xs)

    def ring_shift(self, xs: Sharded, shift: int = 1) -> Sharded:
        """Each shard sends its block to its ring successor (+shift) and
        receives its predecessor's: the hop of the kNN candidate exchange.
        The counters record the per-hop payload.  With a hierarchical
        topology the cycle tours each host group's shards consecutively
        (topology.ring_cycle); flat keeps the +shift rotation
        (mesh.ring_permutation).  Kernel B11 on the card; one shard returns
        its input."""
        with device_section(self.name, xs):
            n_dev = len(xs)
            if n_dev == 1:
                return list(xs)
            topo = self._resolved(n_dev)
            _record_link_bytes(self.name, *topology.link_split_ring_hop(topo, _nbytes(xs[0])))
            perm = topology.ring_cycle(topo, shift) if topo.is_hierarchical else ring_permutation(n_dev, shift)
            return exchange_kernels.ring_shift([x.contiguous() for x in xs], perm)


def device_collective(name: str, topo: Optional[topology.TopologyMap] = None) -> DeviceSection:
    """The typed-section constructor: one named handle per call site.
    `topo` opts the section into the hierarchical schedules."""
    return DeviceSection(name, topo)


# -- un-named-section shims ----------------------------------------------------


def allgather_rows(xs: Sharded, section: str = "allgather_rows") -> Sharded:
    """Per-shard row blocks concatenated along axis 0 (DeviceSection)."""
    return device_collective(section).allgather_rows(xs)


def psum_parts(xs: Sharded, section: str = "psum_parts") -> Sharded:
    """Element-wise sum of per-shard partials (DeviceSection.psum)."""
    return device_collective(section).psum(xs)


def psum_fields(parts, section: str) -> Tuple[torch.Tensor, ...]:
    """Per-shard tuples of partial sums (parts[i]: shard i's fields, one
    dtype) summed over the shards by ONE psum_parts of the fields flattened
    into one vector a shard: the fit reductions' collective.  Returns the
    fields' totals, in their shapes, on shard 0's device.  One shard's
    fields are its totals: no collective runs (as XLA drops a one-device
    psum)."""
    if len(parts) == 1:
        return tuple(parts[0])
    shapes = [tuple(t.shape) for t in parts[0]]
    flat = [torch.cat([t.reshape(-1) for t in fields]) for fields in parts]
    total = psum_parts(flat, section=section)[0]
    out, at = [], 0
    for shape in shapes:
        size = int(np.prod(shape)) if shape else 1
        out.append(total[at : at + size].reshape(shape))
        at += size
    return tuple(out)


def replicate(value: torch.Tensor, devices) -> Sharded:
    """One copy of `value` per device of `devices` (a mesh's device list),
    shared by the shards of one device: a replicated operand of a sharded
    step."""
    copies = {value.device: value}
    out = []
    for d in devices:
        d = torch.device(d)
        if d not in copies:
            copies[d] = value.to(d)
        out.append(copies[d])
    return out


def psum_merge_parts(xs: Sharded, section: str = "psum_merge_parts") -> Sharded:
    """Per-shard candidate blocks stacked into one (n_dev, ...) slab."""
    return device_collective(section).psum_merge(xs)


def ring_shift(xs: Sharded, shift: int = 1, section: str = "ring_shift") -> Sharded:
    """Module-level shim over DeviceSection.ring_shift."""
    return device_collective(section).ring_shift(xs, shift)


def byte_totals(prefix: str = "exchange.") -> Tuple[int, dict]:
    """(total bytes, {section: bytes}) over every exchange section's
    `.bytes` counter.  The per-link rollup is link_totals()."""
    per = {}
    for name, v in profiling.counters(prefix).items():
        if name.endswith(".bytes"):
            per[name[len(prefix) : -len(".bytes")]] = int(v)
    return sum(per.values()), per


def link_totals(prefix: str = "exchange.") -> dict:
    """{"ici": bytes, "dcn": bytes}: the rollup of the per-section link-split
    counters."""
    out = {"ici": 0, "dcn": 0}
    for name, v in profiling.counters(prefix).items():
        if name.endswith(".ici_bytes"):
            out["ici"] += int(v)
        elif name.endswith(".dcn_bytes"):
            out["dcn"] += int(v)
    return out
