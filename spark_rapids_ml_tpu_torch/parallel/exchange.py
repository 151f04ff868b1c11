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
# Across processes (a mesh of several ranks, parallel/mesh.process_mesh():
# a sharded value holds this rank's local shards) every collective takes its
# cross-process form over the mesh's torch.distributed group.  The gather
# class all-gathers each rank's stacked local blocks, in global shard order;
# psum adds the partials in global shard order along a chain through the
# ranks (each rank continues the running sum of the ranks before it, the
# last one broadcasts the total), so its bits are the one-process mesh's of
# the same global shard count (it never pre-sums a rank's shards on their
# own and all-reduces, which would re-associate the floats); ring_shift
# moves the hops inside a rank with B11 and each hop that crosses a rank
# boundary with a send/recv.  On gloo the blocks are staged through (pinned) host copies;
# on nccl they stay on the card.  Cross-process bytes are counted as
# `.dcn_bytes` (whole-job model: each rank's payload to every other rank).
#
# The host-frame helpers move bytes between processes over a control plane,
# with the JAX package's wire format unchanged: pack_arrays / unpack_arrays
# (the SRX1 frame), allgather_bytes, ring_pass_bytes (fault site
# exchange.ring_pass) and alltoall_bytes, chunked under CHUNK_BYTES, raw
# bytes where the plane has allGatherBytes and base64 otherwise.
#

from __future__ import annotations

import base64
import contextlib
import json
import struct
import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import profiling
from ..ops import exchange_kernels
from . import faults, topology
from .mesh import Mesh, process_mesh, ring_permutation

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


def _cross(xs: Sharded) -> Optional[Mesh]:
    """The multi-process mesh these local shards belong to, or None on one
    process."""
    mesh = process_mesh()
    if mesh is None:
        return None
    if len(xs) != mesh.local_size:
        raise ValueError(f"a cross-process collective takes this rank's {mesh.local_size} shards, got {len(xs)}")
    return mesh


def _staging_device(mesh: Mesh, home: torch.device) -> torch.device:
    """Where a block crosses processes: the card on nccl, the host on gloo."""
    if mesh.backend == "nccl":
        return home if home.type == "cuda" else next(d for d in mesh.devices if d.type == "cuda")
    return torch.device("cpu")


def _to_stage(t: torch.Tensor, where: torch.device) -> torch.Tensor:
    """`t` as a contiguous tensor on `where`, a pinned host copy for a CUDA
    tensor bound for the host; bool travels as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if t.device == where:
        return t.contiguous()
    if where.type == "cpu" and t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t.to(where).contiguous()


def _process_slab(name: str, xs: Sharded, mesh: Mesh) -> torch.Tensor:
    """The (global shards, ...) slab of every rank's local blocks, in global
    shard order, on xs[0]'s device: one all_gather over the mesh's group."""
    import torch.distributed as dist

    home = xs[0].device
    where = _staging_device(mesh, home)
    local = _to_stage(torch.stack([x.to(home) for x in xs]), where)
    pin = where.type == "cpu" and home.type == "cuda"
    out = torch.empty((mesh.nranks,) + tuple(local.shape), dtype=local.dtype, device=where, pin_memory=pin)
    dist.all_gather(list(out.unbind(0)), local, group=mesh.group)
    slab = out.reshape((-1,) + tuple(local.shape[1:])).to(home)
    if xs[0].dtype == torch.bool:
        slab = slab.to(torch.bool)
    per_rank = local.element_size() * local.numel()
    _record_link_bytes(name, 0, per_rank * mesh.nranks * (mesh.nranks - 1))
    return slab


def _process_psum(name: str, xs: Sharded, mesh: Mesh) -> torch.Tensor:
    """psum across processes in global shard order, as a chain through the
    ranks: rank 0 starts from its first shard, each rank adds its shards in
    order to the running sum of the ranks before it and passes it on, and
    the last rank's total is broadcast.  Every element is summed in the
    one-process order (((p0 + p1) + p2) + ...), and each rank moves one
    block out and one in (plus the broadcast), where an all-gather of the
    partials moves every shard's block to every rank."""
    import torch.distributed as dist

    home = xs[0].device
    where = _staging_device(mesh, home)
    pin = where.type == "cpu" and home.type == "cuda"
    last = mesh.nranks - 1
    if mesh.rank == 0:
        total, rest = xs[0].to(home, copy=True), xs[1:]
    else:
        buf = torch.empty(xs[0].shape, dtype=xs[0].dtype, device=where, pin_memory=pin)
        dist.recv(buf, src=mesh.rank - 1, group=mesh.group)
        total, rest = buf.to(home), xs
    for x in rest:
        total += x.to(home)
    if mesh.rank < last:
        dist.send(_to_stage(total, where), dst=mesh.rank + 1, group=mesh.group)
        final = torch.empty(xs[0].shape, dtype=xs[0].dtype, device=where, pin_memory=pin)
        dist.broadcast(final, src=last, group=mesh.group)
        total = final.to(home)
    else:
        dist.broadcast(_to_stage(total, where), src=last, group=mesh.group)
    _record_link_bytes(name, 0, 2 * _nbytes(xs[0]) * last)
    return total


def _process_ring_shift(name: str, xs: Sharded, shift: int, mesh: Mesh) -> Sharded:
    """ring_shift across processes: global shard g's block goes to shard
    (g + shift) mod size.  The hops inside this rank run as one B11 launch
    (the rank's blocks permuted among themselves, the pairs that leave or
    enter the rank completed to a bijection and overwritten), each hop that
    crosses a rank boundary is a send/recv."""
    import torch.distributed as dist

    n, L, off = mesh.size, mesh.local_size, mesh.shard_offset
    blocks = [x.contiguous() for x in xs]
    local_pairs, recv_from, send_to = [], {}, []
    for i in range(L):
        src = (off + i - shift) % n
        if src // L == mesh.rank:
            local_pairs.append((src - off, i))
        else:
            recv_from[i] = src
        dst = (off + i + shift) % n
        if dst // L != mesh.rank:
            send_to.append((i, dst))
    free_src = sorted(set(range(L)) - {s for s, _ in local_pairs})
    free_dst = sorted(set(range(L)) - {d for _, d in local_pairs})
    out = exchange_kernels.ring_shift(blocks, local_pairs + list(zip(free_src, free_dst)))
    if not (recv_from or send_to):
        return out
    where = _staging_device(mesh, blocks[0].device)
    ops, recvs = [], {}
    for i, dst in send_to:
        ops.append(dist.P2POp(dist.isend, _to_stage(blocks[i], where), dst // L, group=mesh.group, tag=dst % L))
    for i, src in sorted(recv_from.items()):
        buf = torch.empty(blocks[i].shape, dtype=torch.uint8 if blocks[i].dtype == torch.bool else blocks[i].dtype,
                          device=where)
        recvs[i] = buf
        ops.append(dist.P2POp(dist.irecv, buf, src // L, group=mesh.group, tag=i))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for i, buf in recvs.items():
        out[i] = buf.to(device=blocks[i].device, dtype=blocks[i].dtype)
    _record_link_bytes(name, 0, _nbytes(blocks[0]) * len(send_to) * mesh.nranks)
    return out


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
        """The (n_dev, ...) slab of a gather, with its link bytes recorded
        (every global shard's block across processes)."""
        mesh = _cross(xs)
        if mesh is not None:
            return _process_slab(self.name, xs, mesh)
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
            mesh = _cross(xs)
            if mesh is not None:
                return _replicate(_process_psum(self.name, xs, mesh), xs)
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
            mesh = _cross(xs)
            if mesh is not None:
                return _process_ring_shift(self.name, xs, shift, mesh)
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
    psum); across processes the psum always runs."""
    if len(parts) == 1 and process_mesh() is None:
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


# -- host frames over a control plane -------------------------------------------

CHUNK_BYTES = 8 << 20

_MAGIC = b"SRX1"


def pack_arrays(arrays: Sequence[np.ndarray]) -> bytes:
    """One binary frame: magic, array count, then per array a dtype/shape
    header followed by the raw C-order buffer.  No base64, no JSON."""
    parts = [_MAGIC, struct.pack("<I", len(arrays))]
    bufs = []
    for a in arrays:
        a = np.asarray(a)
        if not a.flags.c_contiguous:
            # (ascontiguousarray would also promote 0-dim to 1-dim)
            a = np.ascontiguousarray(a)
        dt = a.dtype.str.encode("ascii")  # e.g. b'<f4' — endian-explicit
        parts.append(struct.pack("<B", len(dt)))
        parts.append(dt)
        parts.append(struct.pack("<B", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}q", *a.shape))
        parts.append(struct.pack("<q", a.nbytes))
        bufs.append(a.tobytes())
    return b"".join(parts) + b"".join(bufs)


def unpack_arrays(buf: bytes) -> List[np.ndarray]:
    if buf[:4] != _MAGIC:
        raise ValueError("not an SRX1 frame")
    (count,) = struct.unpack_from("<I", buf, 4)
    off = 8
    metas = []
    for _ in range(count):
        (dl,) = struct.unpack_from("<B", buf, off)
        off += 1
        dt = np.dtype(buf[off : off + dl].decode("ascii"))
        off += dl
        (nd,) = struct.unpack_from("<B", buf, off)
        off += 1
        shape = struct.unpack_from(f"<{nd}q", buf, off)
        off += 8 * nd
        (nb,) = struct.unpack_from("<q", buf, off)
        off += 8
        metas.append((dt, shape, nb))
    out = []
    for dt, shape, nb in metas:
        out.append(
            np.frombuffer(buf, dtype=dt, count=nb // dt.itemsize, offset=off)
            .reshape(shape)
            .copy()
        )
        off += nb
    return out


def _chunks(payload: bytes, chunk: int) -> List[bytes]:
    return [payload[i : i + chunk] for i in range(0, len(payload), chunk)] or [
        b""
    ]


def _send(cp: Any, data: bytes, use_bytes: bool) -> List[Any]:
    if use_bytes:
        return cp.allGatherBytes(data)
    return cp.allGather(base64.b64encode(data).decode("ascii"))


def _recv(frame: Any, use_bytes: bool) -> bytes:
    if use_bytes:
        return frame
    out = base64.b64decode(frame)
    return out


def allgather_bytes(
    cp: Any, payload: bytes, chunk: int = CHUNK_BYTES
) -> List[bytes]:
    """Broadcast allGather of one binary payload per rank (every receiver
    materializes every rank's payload — use for data all sides need, e.g.
    the query broadcast).  Chunked under the transport frame limit.
    Wall-clock and payload bytes land in the "exchange.allgather" section
    (span + counters) so control-plane time is separable from device compute
    in fit reports and telemetry snapshots."""
    with section("allgather", nbytes=len(payload)):
        use_bytes = hasattr(cp, "allGatherBytes")
        mine = _chunks(payload, chunk)
        counts = [int(c) for c in cp.allGather(str(len(mine)))]
        parts: List[List[bytes]] = [[] for _ in counts]
        for r in range(max(counts)):
            got = _send(cp, mine[r] if r < len(mine) else b"", use_bytes)
            for s, g in enumerate(got):
                if r < counts[s]:
                    parts[s].append(_recv(g, use_bytes))
        return [b"".join(p) for p in parts]


def ring_pass_bytes(
    cp: Any,
    rank: int,
    nranks: int,
    payload: bytes,
    chunk: int = CHUNK_BYTES,
) -> bytes:
    """One ring hop over the control plane: contribute `payload` and
    return the payload received from the flat-ring predecessor,
    (rank - 1) % nranks — the HOST-plane analog of
    DeviceSection.ring_shift, used by distributed_kneighbors' ring route
    to rotate query blocks + running candidate lists between ranks as
    binary frames.

    The wire rides the broadcast allGather (the only collective a Spark
    barrier offers) but the decode is p2p-shaped: a receiver b64-decodes /
    joins ONLY its predecessor's chunks and drops the rest by reference, so
    per-rank decode volume is O(one neighbor's payload) per hop instead of
    O(sum of all ranks').  COLLECTIVE: every rank must call it once per
    hop, empty payloads included."""
    # srml-shield: corrupt here flips bytes in the outgoing frame (the
    # receiver's SRX1 magic check must fail loudly); die/raise simulate a
    # rank lost mid-ring
    payload = faults.site("exchange.ring_pass", rank=rank, payload=payload)
    with section("ring", nbytes=len(payload)):
        use_bytes = hasattr(cp, "allGatherBytes")
        src = (rank - 1) % nranks
        mine = _chunks(payload, chunk)
        counts = [int(c) for c in cp.allGather(str(len(mine)))]
        parts: List[bytes] = []
        for r in range(max(counts)):
            got = _send(cp, mine[r] if r < len(mine) else b"", use_bytes)
            if r < counts[src]:
                parts.append(_recv(got[src], use_bytes))
        return b"".join(parts)


def alltoall_bytes(
    cp: Any,
    rank: int,
    nranks: int,
    dests: Sequence[bytes],
    chunk: int = CHUNK_BYTES,
) -> List[bytes]:
    """All-to-all of per-destination binary payloads: rank s passes
    dests[d] for every destination d and receives the nranks payloads
    addressed to IT (result[s] = what rank s sent to this rank).

    The wire rides the broadcast allGather (the only collective a Spark
    barrier offers), but chunks are framed dest-major with a counts
    round first, so a receiver b64-decodes/joins ONLY the chunk rounds
    addressed to it and drops the rest by reference — per-rank decode
    volume is O(own share), the p2p shape of the reference's UCX return
    (knn.py:549-560: each query partition's results land only on their
    owning rank)."""
    if len(dests) != nranks:
        raise ValueError(f"need {nranks} destination payloads, got {len(dests)}")
    with section("alltoall", nbytes=sum(len(d) for d in dests)):
        use_bytes = hasattr(cp, "allGatherBytes")
        frames = [_chunks(d, chunk) for d in dests]
        meta = json.dumps([len(f) for f in frames])
        all_meta = [json.loads(s) for s in cp.allGather(meta)]  # [src][dest]
        # canonical send order: dest-major concatenation of each source's
        # chunks
        my_seq = [c for f in frames for c in f]
        # position range of (src -> me) chunks inside src's send sequence
        lo = [sum(all_meta[s][:rank]) for s in range(nranks)]
        hi = [lo[s] + all_meta[s][rank] for s in range(nranks)]
        rounds = max(sum(m) for m in all_meta)
        mine: List[List[bytes]] = [[] for _ in range(nranks)]
        for r in range(rounds):
            got = _send(cp, my_seq[r] if r < len(my_seq) else b"", use_bytes)
            for s in range(nranks):
                if lo[s] <= r < hi[s]:
                    mine[s].append(_recv(got[s], use_bytes))
        return [b"".join(p) for p in mine]
