#
# The ring-shift kernel of the in-mesh exchange.
#
# Counterpart of the remote-DMA kernel of spark_rapids_ml_tpu/parallel/
# exchange.py.  The wrapper takes its plain PyTorch version for CPU tensors
# and launches its hand-written CUDA kernel (sm_90a) for CUDA tensors, or
# raises; there is no fallback.
#
#   ring_shift  B11, replaces _ring_shift_remote_dma (the Pallas kernel at
#               exchange.py:484, pallas_call :508): csrc/ring_shift.cu
#
# ring_shift(srcs, perm) moves a sharded value: srcs[i] is shard i's block,
# on shard i's device, and for every (source, destination) pair of `perm`
# the destination shard receives the source shard's block, in a buffer the
# wrapper allocates on the destination shard's device (out of place, as the
# TPU kernel).  `perm` is the flat rotation (mesh.ring_permutation) or the
# gateway cycle (topology.ring_cycle): every shard sends once and receives
# once.  The blocks must agree in shape and dtype.
#
# On the card: one launch for every source device, with the (source,
# destination) pointer pairs passed by value (at most MAX_PAIRS).  All shards
# on one card (a mesh that repeats the device) take one launch.  Shards on
# several cards store through their peers' pointers: the wrapper enables
# peer access once for every ordered pair of cards, raises if the hardware
# refuses it, makes the source stream wait for the destination streams'
# earlier work, and makes each destination device's current stream wait for
# an event recorded after the launch (the TPU kernel's receive semaphore).
# Bound: bytes, 2 x block bytes x n over 3.35 TB/s on one card; across
# cards the writes cross NVLink at 450 GB/s each way.
#

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Sequence, Set, Tuple

import torch

from . import _build

MAX_PAIRS = 64  # the kernel's parameter struct holds at most this many pairs
_LIBRARY = "ring_shift"

_peer_lock = threading.Lock()
_peers: Set[Tuple[int, int]] = set()  # (device, peer) pairs with access enabled


def _check(srcs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> None:
    n = len(srcs)
    if not 1 <= n <= MAX_PAIRS:
        raise ValueError(f"ring_shift takes 1 to {MAX_PAIRS} blocks, got {n}")
    pairs = [(int(s), int(d)) for s, d in perm]
    if len(pairs) != n or sorted(s for s, _ in pairs) != list(range(n)) or sorted(d for _, d in pairs) != list(range(n)):
        raise ValueError(f"perm must send every one of the {n} blocks once and fill every one once, got {pairs}")
    first = srcs[0]
    for i, t in enumerate(srcs):
        if t.shape != first.shape:
            raise ValueError(f"block {i} has shape {tuple(t.shape)}, block 0 {tuple(first.shape)}")
        if t.dtype != first.dtype:
            raise ValueError(f"block {i} is {t.dtype}, block 0 {first.dtype}")
        if t.element_size() * t.numel() != first.element_size() * first.numel():
            raise ValueError(f"block {i} holds {t.element_size() * t.numel()} bytes, block 0 "
                             f"{first.element_size() * first.numel()}")
        if not t.is_contiguous():
            raise ValueError(f"block {i} is not contiguous")
    kinds = {t.device.type for t in srcs}
    if kinds not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"ring_shift runs on cpu tensors or on cuda tensors, not on {sorted(kinds)}")


def ring_shift(srcs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """The blocks after one exchange: out[d] holds a copy of srcs[s] for
    every (s, d) in perm, on srcs[d]'s device."""
    _check(srcs, perm)
    if srcs[0].device.type == "cpu":
        return ring_shift_plain(srcs, perm)
    out: List[torch.Tensor] = [None] * len(srcs)  # type: ignore[list-item]
    by_device: Dict[torch.device, List[Tuple[int, int]]] = {}
    for s, d in perm:
        out[d] = torch.empty(srcs[s].shape, dtype=srcs[s].dtype, device=srcs[d].device)
        by_device.setdefault(srcs[s].device, []).append((s, d))
    fn = _function("srml_ring_shift")
    for dev, pairs in by_device.items():
        peers = sorted({out[d].device.index for _, d in pairs} - {dev.index})
        for peer in peers:
            _enable_peer_access(dev.index, peer)
        stream = torch.cuda.current_stream(dev)
        for peer in peers:  # the destinations' memory may still be in use by their streams' earlier work
            stream.wait_stream(torch.cuda.current_stream(torch.device("cuda", peer)))
        n = len(pairs)
        src_ptrs = (ctypes.c_ulonglong * n)(*[srcs[s].data_ptr() for s, _ in pairs])
        dst_ptrs = (ctypes.c_ulonglong * n)(*[out[d].data_ptr() for _, d in pairs])
        nbytes = (ctypes.c_longlong * n)(*[srcs[s].element_size() * srcs[s].numel() for s, _ in pairs])
        err = fn(dev.index, src_ptrs, dst_ptrs, nbytes, n, stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"ring_shift kernel launch failed on {dev}: CUDA error {err}")
        ring_shift.launches += 1
        for peer in peers:
            torch.cuda.current_stream(torch.device("cuda", peer)).wait_stream(stream)
    return out


# launches of the CUDA kernel, for runs that must show the path went through it
ring_shift.launches = 0


_ARGTYPES = {
    "srml_ring_shift": [ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_ulonglong),
                        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p],
    "srml_enable_peer_access": [ctypes.c_int, ctypes.c_int],
}


def _function(name: str):
    """A C entry point of the library with its argument types set (once:
    ctypes keeps them on the library's function object)."""
    fn = getattr(_build.load(_LIBRARY), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _enable_peer_access(device: int, peer: int) -> None:
    with _peer_lock:
        if (device, peer) in _peers:
            return
        err = _function("srml_enable_peer_access")(device, peer)
        if err == -1:
            raise RuntimeError(f"cuda:{device} cannot access the memory of cuda:{peer} (no peer access)")
        if err != 0:
            raise RuntimeError(f"enabling peer access cuda:{device} -> cuda:{peer} failed: CUDA error {err}")
        _peers.add((device, peer))


def ring_shift_plain(srcs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """The exchange in plain PyTorch: dst[perm[i]].copy_(src[i]).  Runs on
    any device."""
    out: List[torch.Tensor] = [None] * len(srcs)  # type: ignore[list-item]
    for s, d in perm:
        out[d] = torch.empty(srcs[s].shape, dtype=srcs[s].dtype, device=srcs[d].device)
        out[d].copy_(srcs[s])
    return out
