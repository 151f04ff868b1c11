#
# The IVF-PQ lookup-table kernels: ADC accumulation over one-byte codes and
# over 4-bit codes packed two a byte (fast-scan).
#
# Counterpart of spark_rapids_ml_tpu/ops/pallas_pq.py.  Each wrapper takes its
# plain PyTorch version for CPU tensors and launches its hand-written CUDA
# kernel (sm_90a) for CUDA tensors, or raises; there is no fallback.
#
#   lut_accumulate_probed           B9, replaces _lut_accum_kernel
#                                   (_lut_accumulate_pallas): csrc/pq_lut.cu,
#                                   the codes read in place at each query's
#                                   probed list slots, padding rows skipped
#   lut_accumulate                  B9 on a contiguous tile: the same kernel,
#                                   each query its own plane
#   fastscan_lut_accumulate_probed  B10, replaces _fastscan_kernel
#                                   (_fastscan_pallas): csrc/pq_lut.cu, the
#                                   packed codes read in place the same way
#   fastscan_lut_accumulate         B10 on a contiguous tile: the same
#                                   kernel, each query its own plane
#
# All compute out[b, r] = sum_j tables[b, j, code(b, r, j)], summed in j
# order in float32, each term an exact table read, so the kernels, their
# plain versions, the JAX package's numpy oracle and its interpret-mode
# Pallas kernels agree bit for bit.  A code >= ksub adds 0.0, as in the
# Pallas kernels (the JAX package's XLA route clamps instead; the PQ encoder
# never writes such a code).  The TPU kernels' pre-transposed lane-major
# layouts and their 512-row tiles are VMEM concerns that do not carry over:
# here tables are (B, m_sub, ksub) and codes (B, R, m_bytes) or a plane of
# lists (n_planes, L_pad, m_bytes) as the callers hold them.  Bound and
# design: see the source.
#

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

_LIBRARY = "pq_lut"
_ROWS_A_BLOCK = 256   # the probed kernel's rows a (list, tile) unit, one a thread
_FASTSCAN_ROWS = 128  # the fast-scan kernel's rows a warp unit (32 lanes x 4 rows)
_FASTSCAN_WARPS = 4   # ... and warps a block
_MAX_KSUB = 256       # one-byte codes address at most 256 table entries
_FASTSCAN_KSUB = 16   # a nibble addresses at most 16


def _check(tables: torch.Tensor, codes: torch.Tensor, m_bytes: int, max_ksub: int) -> None:
    if tables.dtype != torch.float32:
        raise TypeError(f"tables must be float32, not {tables.dtype}")
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, not {codes.dtype}")
    if tables.dim() != 3 or codes.dim() != 3:
        raise ValueError(f"tables {tuple(tables.shape)} and codes {tuple(codes.shape)} must be 3-D")
    if codes.shape[0] != tables.shape[0] or codes.shape[2] != m_bytes:
        raise ValueError(
            f"codes {tuple(codes.shape)} must be ({tables.shape[0]}, R, {m_bytes}) for tables {tuple(tables.shape)}"
        )
    if not 1 <= tables.shape[2] <= max_ksub:
        raise ValueError(f"tables must have 1 <= ksub <= {max_ksub}; got ksub={tables.shape[2]}")
    if codes.device != tables.device:
        raise ValueError(f"codes are on {codes.device}, tables on {tables.device}")
    if not tables.is_contiguous() or not codes.is_contiguous():
        raise ValueError("tables and codes must be contiguous")
    if tables.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the PQ kernels run on cpu or cuda tensors, not {tables.device}")


def _fastscan_check(tables: torch.Tensor, packed: torch.Tensor) -> int:
    """Validate the packed fast-scan geometry; returns m_sub.  The typed
    rejections of the JAX package's _fastscan_check: an odd m_sub cannot
    pack two codes a byte, a nibble cannot address ksub > 16, and the packed
    width must be m_sub / 2."""
    m_sub = int(tables.shape[1])
    if m_sub % 2 != 0:
        raise ValueError(
            f"fast-scan requires an even m_sub (two 4-bit codes pack per "
            f"byte); got m_sub={m_sub} — use n_bits=8 or an even M"
        )
    if int(tables.shape[2]) > 16:
        raise ValueError(
            f"fast-scan tables must have ksub <= 16 (4-bit codes); got "
            f"ksub={int(tables.shape[2])}"
        )
    if int(packed.shape[2]) * 2 != m_sub:
        raise ValueError(
            f"packed codes carry {int(packed.shape[2])} bytes/item but "
            f"tables expect m_sub={m_sub} subspaces ({m_sub // 2} bytes)"
        )
    return m_sub


def lut_accumulate(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC lookup-table accumulation: out[b, r] = sum_j tables[b, j,
    codes[b, r, j]] (B, R) float32, sequential in j; tables (B, m_sub, ksub)
    float32, codes (B, R, m_sub) uint8."""
    _check(tables, codes, tables.shape[1], _MAX_KSUB)
    if tables.device.type == "cpu":
        return lut_accumulate_plain(tables, codes)
    out = _launch_probed(tables, codes, *_own_planes(codes), packed=False)
    if out.numel() > 0:
        lut_accumulate.launches += 1
    return out.view(codes.shape[0], codes.shape[1])


def _own_planes(codes: torch.Tensor):
    """(slots, counts) that make a contiguous (B, R, m_bytes) tile a plane
    of B lists, each query probing its own list of R rows, all valid."""
    b, r = codes.shape[0], codes.shape[1]
    slots = torch.arange(b, dtype=torch.int64, device=codes.device)[:, None]
    return slots, torch.full((b, 1), r, dtype=torch.int32, device=codes.device)


def _check_probed(tables, code_plane, slots, counts, packed: bool = False) -> None:
    """The probed entries' typed rejections; packed: the fast-scan form
    (code_plane (n_planes, L_pad, m_sub / 2), _fastscan_check's three)."""
    if tables.dtype != torch.float32:
        raise TypeError(f"tables must be float32, not {tables.dtype}")
    if code_plane.dtype != torch.uint8:
        raise TypeError(f"code_plane must be uint8, not {code_plane.dtype}")
    if slots.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"slots must be int32 or int64, not {slots.dtype}")
    if counts.dtype != torch.int32:
        raise TypeError(f"counts must be int32, not {counts.dtype}")
    m_bytes = "m_sub / 2" if packed else "m_sub"
    if tables.dim() != 3 or code_plane.dim() != 3 or slots.dim() != 2:
        raise ValueError(
            f"tables {tuple(tables.shape)}, code_plane {tuple(code_plane.shape)} and slots "
            f"{tuple(slots.shape)} must be (B, m_sub, ksub), (n_planes, L_pad, {m_bytes}) and (B, nprobe)"
        )
    if packed:
        _fastscan_check(tables, code_plane)
    elif code_plane.shape[2] != tables.shape[1]:
        raise ValueError(f"code_plane {tuple(code_plane.shape)} does not match tables {tuple(tables.shape)}")
    if slots.shape[0] != tables.shape[0]:
        raise ValueError(f"slots {tuple(slots.shape)} do not match tables {tuple(tables.shape)}")
    if tuple(counts.shape) != tuple(slots.shape):
        raise ValueError(f"counts {tuple(counts.shape)} must have the shape of slots {tuple(slots.shape)}")
    max_ksub = _FASTSCAN_KSUB if packed else _MAX_KSUB
    if not 1 <= tables.shape[2] <= max_ksub:
        raise ValueError(f"tables must have 1 <= ksub <= {max_ksub}; got ksub={tables.shape[2]}")
    for name, t in (("code_plane", code_plane), ("slots", slots), ("counts", counts)):
        if t.device != tables.device:
            raise ValueError(f"{name} is on {t.device}, tables on {tables.device}")
    if not (tables.is_contiguous() and code_plane.is_contiguous() and counts.is_contiguous()):
        raise ValueError("tables, code_plane and counts must be contiguous")
    if tables.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the PQ kernels run on cpu or cuda tensors, not {tables.device}")


def lut_accumulate_probed(
    tables: torch.Tensor, code_plane: torch.Tensor, slots: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """The accumulation over each query's probed lists, read in place:
    out[b, p, r] (B, nprobe, L_pad) float32 = sum_j tables[b, j,
    code_plane[slots[b, p], r, j]], sequential in j, for r < counts[b, p]
    (clamped to [0, L_pad]); +inf for every other row, and for every row of
    a slot outside [0, n_planes).  tables (B, m_sub, ksub) float32,
    code_plane (n_planes, L_pad, m_sub) uint8, slots (B, nprobe) int32 or
    int64, counts (B, nprobe) int32."""
    _check_probed(tables, code_plane, slots, counts)
    if tables.device.type == "cpu":
        return lut_accumulate_probed_plain(tables, code_plane, slots, counts)
    out = _launch_probed(tables, code_plane, slots.to(torch.int64).contiguous(), counts, packed=False)
    if out.numel() > 0:
        lut_accumulate_probed.launches += 1
    return out


def probed_splits(tables: torch.Tensor, nprobe: int, l_pad: int, vec: int) -> int:
    """Blocks a query of a probed launch over `tables` (B, m_sub, ksub) on
    the card: the blocks the card holds at once (its SMs times the blocks
    an SM holds at the table's shared memory) across the B queries, at most
    one a (list, 256-row tile) unit."""
    b, m_sub, ksub = tables.shape
    return _blocks_a_query(tables, b, nprobe * -(-l_pad // _ROWS_A_BLOCK), resident_blocks(m_sub, ksub, vec))


def _blocks_a_query(tables: torch.Tensor, b: int, most: int, per_sm: int) -> int:
    """The blocks the card holds at once (its SMs times per_sm) across b
    queries, at least 1 and at most `most`."""
    sms = torch.cuda.get_device_properties(tables.device).multi_processor_count
    return max(1, min(most, sms * per_sm // max(1, b)))


@functools.lru_cache(maxsize=None)
def resident_blocks(m_sub: int, ksub: int, vec: int) -> int:
    """Blocks of the probed kernel one SM of the current card holds at once
    for an m_sub x ksub table (CUDA's occupancy calculator)."""
    fn = _build.load(_LIBRARY).srml_lut_probed_occupancy
    fn.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(m_sub, ksub, vec, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"srml_lut_probed_occupancy({m_sub}, {ksub}, {vec}): CUDA error {err}, {blocks.value} blocks")
    return blocks.value


def lut_accumulate_probed_plain(
    tables: torch.Tensor, code_plane: torch.Tensor, slots: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """The probed accumulation in plain PyTorch: the probed lists gathered
    with index_select, lut_accumulate_plain over the tile, +inf past each
    list's count (and for a slot outside the plane).  Runs on any device."""
    return _probed_plain(lut_accumulate_plain, tables, code_plane, slots, counts)


def _probed_plain(tile_sum, tables, code_plane, slots, counts) -> torch.Tensor:
    b, nprobe = slots.shape
    n_planes, l_pad, m_bytes = code_plane.shape
    s = slots.long()
    inside = (s >= 0) & (s < n_planes)
    tile = code_plane.index_select(0, torch.where(inside, s, 0).reshape(-1)).view(b, nprobe * l_pad, m_bytes)
    acc = tile_sum(tables, tile).view(b, nprobe, l_pad)
    n = torch.where(inside, counts.clamp(0, l_pad), 0)
    valid = torch.arange(l_pad, device=tables.device)[None, None, :] < n[:, :, None]
    return torch.where(valid, acc, torch.full_like(acc, float("inf")))


def fastscan_lut_accumulate(tables: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The same sum over 4-bit codes packed two a byte: tables (B, m_sub,
    ksub <= 16) float32, packed (B, R, m_sub / 2) uint8 (code j in the low
    nibble of byte j // 2 when j is even, in the high nibble when odd)."""
    if tables.dim() != 3 or packed.dim() != 3:
        raise ValueError(f"tables {tuple(tables.shape)} and packed {tuple(packed.shape)} must be 3-D")
    m_sub = _fastscan_check(tables, packed)
    _check(tables, packed, m_sub // 2, _FASTSCAN_KSUB)
    if tables.device.type == "cpu":
        return fastscan_lut_accumulate_plain(tables, packed)
    out = _launch_probed(tables, packed, *_own_planes(packed), packed=True)
    if out.numel() > 0:
        fastscan_lut_accumulate.launches += 1
    return out.view(packed.shape[0], packed.shape[1])


def fastscan_lut_accumulate_probed(
    tables: torch.Tensor, packed_plane: torch.Tensor, slots: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """The fast-scan accumulation over each query's probed lists, read in
    place: out[b, p, r] (B, nprobe, L_pad) float32 = sum_j tables[b, j,
    code(packed_plane[slots[b, p], r], j)], sequential in j, for r <
    counts[b, p] (clamped to [0, L_pad]); +inf for every other row, and for
    every row of a slot outside [0, n_planes).  tables (B, m_sub, ksub <=
    16) float32, packed_plane (n_planes, L_pad, m_sub / 2) uint8 (the
    nibbles as fastscan_lut_accumulate's), slots (B, nprobe) int32 or
    int64, counts (B, nprobe) int32."""
    _check_probed(tables, packed_plane, slots, counts, packed=True)
    if tables.device.type == "cpu":
        return fastscan_lut_accumulate_probed_plain(tables, packed_plane, slots, counts)
    out = _launch_probed(tables, packed_plane, slots.to(torch.int64).contiguous(), counts, packed=True)
    if out.numel() > 0:
        fastscan_lut_accumulate_probed.launches += 1
    return out


def _launch_probed(tables, plane, slots, counts, packed: bool) -> torch.Tensor:
    """One launch of a probed C entry on int64 slots: B10's
    (srml_fastscan_accumulate_probed_f32) when packed, else B9's
    (srml_lut_accumulate_probed_f32); the two take the same arguments.  No
    launch when the output is empty."""
    b, nprobe = slots.shape
    n_planes, l_pad, _ = plane.shape
    out = torch.empty((b, nprobe, l_pad), dtype=torch.float32, device=tables.device)
    if out.numel() == 0:
        return out
    if packed:
        entry = "srml_fastscan_accumulate_probed_f32"
        vec = int(tables.shape[1] % 32 == 0 and plane.data_ptr() % 16 == 0)
        splits = fastscan_splits(tables, nprobe, l_pad, vec)
    else:
        entry = "srml_lut_accumulate_probed_f32"
        vec = _vec(plane)
        splits = probed_splits(tables, nprobe, l_pad, vec)
    fn = getattr(_build.load(_LIBRARY), entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        tables.data_ptr(), plane.data_ptr(), slots.data_ptr(), counts.data_ptr(), out.data_ptr(),
        b, nprobe, n_planes, l_pad, tables.shape[1], tables.shape[2], vec, splits,
        torch.cuda.current_stream(tables.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return out


def fastscan_splits(tables: torch.Tensor, nprobe: int, l_pad: int, vec: int) -> int:
    """Blocks a query of a fast-scan launch on the card: the blocks the card
    holds at once across the B queries, at most one a _FASTSCAN_WARPS
    (list, row-tile) units."""
    units = nprobe * -(-l_pad // _FASTSCAN_ROWS)
    return _blocks_a_query(tables, tables.shape[0], -(-units // _FASTSCAN_WARPS), fastscan_resident_blocks(vec))


@functools.lru_cache(maxsize=None)
def fastscan_resident_blocks(vec: int) -> int:
    """Blocks of the fast-scan kernel one SM of the current card holds at
    once (CUDA's occupancy calculator)."""
    fn = _build.load(_LIBRARY).srml_fastscan_probed_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(vec, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"srml_fastscan_probed_occupancy({vec}): CUDA error {err}, {blocks.value} blocks")
    return blocks.value


# launches of the CUDA kernel by each wrapper, for runs that must show the
# path went through it
lut_accumulate.launches = 0
lut_accumulate_probed.launches = 0
fastscan_lut_accumulate.launches = 0
fastscan_lut_accumulate_probed.launches = 0


def _vec(codes: torch.Tensor) -> int:
    """1 where the one-byte kernel reads each row's code bytes as 16-byte
    words: the row width a multiple of 16 bytes, the codes 16-byte
    aligned."""
    return int(codes.shape[-1] % 16 == 0 and codes.data_ptr() % 16 == 0)


def lut_accumulate_plain(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The accumulation in plain PyTorch: an explicit loop over j of one
    gather and one add (a sum over the j axis would not keep the order); a
    code >= ksub adds 0.0.  Runs on any device."""
    b, m_sub, ksub = tables.shape
    acc = torch.zeros(codes.shape[:2], dtype=torch.float32, device=tables.device)
    for j in range(m_sub):
        c = codes[:, :, j].long()
        term = tables[:, j, :].gather(1, c.clamp(max=ksub - 1))
        acc = acc + torch.where(c < ksub, term, torch.zeros_like(term))
    return acc


def fastscan_lut_accumulate_plain(tables: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The fast-scan accumulation in plain PyTorch: unpack the nibbles, then
    lut_accumulate_plain.  Runs on any device."""
    return lut_accumulate_plain(tables, unpack_codes4(packed))


def fastscan_lut_accumulate_probed_plain(
    tables: torch.Tensor, packed_plane: torch.Tensor, slots: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """The probed fast-scan accumulation in plain PyTorch: index_select of
    the probed lists, fastscan_lut_accumulate_plain over the tile, +inf past
    each list's count (and for a slot outside the plane).  Runs on any
    device."""
    return _probed_plain(fastscan_lut_accumulate_plain, tables, packed_plane, slots, counts)


def pack_codes4(codes: np.ndarray) -> np.ndarray:
    """Host packer, the unpack_codes4 inverse: (N, m_sub even) uint8 4-bit
    codes -> (N, m_sub // 2) bytes, byte p = code[:, 2p] | code[:, 2p+1] << 4."""
    codes = np.asarray(codes, np.uint8)
    if codes.ndim != 2 or codes.shape[1] % 2:
        raise ValueError(f"pack_codes4 needs (N, even m_sub) codes; got {codes.shape}")
    if codes.size and int(codes.max()) > 0xF:
        raise ValueError("pack_codes4 codes must be 4-bit (values < 16)")
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def unpack_codes4(packed: torch.Tensor) -> torch.Tensor:
    """(B, R, m_sub // 2) packed bytes -> (B, R, m_sub) uint8 4-bit codes in
    the j order the kernels sweep: byte p holds j = 2p (low nibble) and
    j = 2p + 1 (high nibble)."""
    b, r, m_half = packed.shape
    return torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(b, r, 2 * m_half)
