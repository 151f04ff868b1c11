#
# IVF-PQ: residual product quantization on top of the IVF lists, over a
# device mesh.
#
# Counterpart of spark_rapids_ml_tpu/ann/pq.py.  Each item is stored as m_sub
# codes (one byte each, or two 4-bit codes a byte: fast-scan) plus one
# float32 ADC scalar:
#
#   build:  the coarse quantizer and the list assignment are the IVF-Flat
#           helpers (ivfflat.train_coarse_quantizer / assign_nearest).
#           Residuals r = x - centroid[list] are split into m_sub subspaces
#           (features zero-padded to m_sub * dsub, dsub a power of two);
#           each subspace trains its own ksub = 2^n_bits codebook with the
#           same k-means, and encoding is the nearest-center kernel again
#           (B1).  With opq, a learned rotation of the residuals comes first
#           (the Procrustes step is host float64 numpy, as in the JAX
#           package).  The ADC scalars are host float64, rounded once.
#   search: asymmetric distance computation.  With r^ the item's
#           reconstructed residual,
#
#             d2(q, item) = ||q - centroid_l||^2             (probe term)
#                         + sum_j -2 q_j . cb[j, code_j]     (query table)
#                         + (||r^||^2 + 2 centroid_l . r^)   (item scalar)
#
#           The probe term comes out of probe selection, the scalar is
#           stored per item, and the per-query table T (m_sub, ksub) feeds
#           the lookup-table kernels (ops/pq_kernels: B9 for one-byte codes,
#           B10 fast-scan for n_bits = 4 and an even m_sub, both reading the
#           probed lists' codes in place).  Selection, the list-sharded
#           staging and the cross-shard merge are the flat search's
#           (ivfflat.probe_sweep): on a mesh each shard passes a count of 0
#           for the lists it does not own, so the kernels keep the
#           one-shard launch shape and read only the shard's own codes.
#   refine: the top k * refine_ratio ADC candidates are re-scored against
#           the float32 vectors kept on the host (_refine_host, numpy: given
#           the same candidates, bit for bit the JAX package's), once over
#           the merged candidates.
#
# What does not carry over: shard_map, the AOT executable cache and
# warm_pq_probe_kernels, the SRML_PQ_FASTSCAN escape hatch (fast-scan follows
# from n_bits = 4 and an even m_sub alone), and the pow2 query chunks of
# _pq_probe_chunk (ivfflat.probe_sweep sizes the blocks).
#

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.pq_kernels import fastscan_lut_accumulate_probed, lut_accumulate_probed, pack_codes4
from ..parallel.mesh import Mesh, as_mesh
from .ivfflat import (
    _TRAIN_CAP,
    assign_nearest,
    effective_nprobe,
    ids_of,
    item_norms,
    list_order,
    padded_layout_geometry,
    padded_slots,
    probe_sweep,
    replicated,
    shard_counts,
    shard_lists,
    to_device_queries,
    train_coarse_quantizer,
)

# host bytes of gathered (q_chunk, R, D) float32 candidates the refine
# materializes at once
_REFINE_BUDGET = 256 << 20
# subspace-seed stride: each codebook trains with its own deterministic seed
_SUBSPACE_SEED_STRIDE = 0x51F1_5EED
# OPQ training sample cap and alternation counts
_OPQ_TRAIN_CAP = 65536
_OPQ_ITERS = 4
_OPQ_KMEANS_ITERS = 8

DEFAULT_N_BITS = 8
DEFAULT_REFINE_RATIO = 4


def pq_fastscan(n_bits: int, m_sub: int) -> bool:
    """Whether a payload takes the fast-scan layout and kernel: n_bits = 4
    and an even m_sub (an odd m_sub cannot pack two codes a byte and stays
    on one byte per code)."""
    return int(n_bits) == 4 and int(m_sub) % 2 == 0


def default_m_sub(dim: int) -> int:
    """Subspace count: the largest power of two <= dim / 8 clamped to
    [4, 64] (and never above dim): ~8 feature dims per code."""
    target = max(4, dim // 8)
    m = 1 << (target.bit_length() - 1)
    return int(max(1, min(64, m, dim)))


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pq_geometry(dim: int, m_sub: int) -> Tuple[int, int, int]:
    """(m_sub, dsub, d_pad): the subspace width is the pow2 bucket of
    ceil(dim / m_sub) and the features zero-pad to m_sub * dsub."""
    m_sub = int(max(1, min(m_sub, dim)))
    dsub = _pow2_ceil(-(-dim // m_sub))
    return m_sub, dsub, m_sub * dsub


def _pad_features(x: np.ndarray, d_pad: int) -> np.ndarray:
    if x.shape[1] == d_pad:
        return x
    out = np.zeros((x.shape[0], d_pad), np.float32)
    out[:, : x.shape[1]] = x
    return out


def _rotate(x: np.ndarray, rotation: Optional[np.ndarray]) -> np.ndarray:
    """x @ R.T in float64, rounded once to float32 (identity for None)."""
    if rotation is None:
        return x
    return (x.astype(np.float64) @ rotation.astype(np.float64).T).astype(np.float32)


class PackedPQ:
    """Host-side IVF-PQ payload: per-item codes and ADC scalars sorted by
    list (the PackedIVF layout rule), the per-list counts, the coarse
    centroids, the subspace codebooks and the optional OPQ rotation.  This
    is what the model persists."""

    __slots__ = (
        "codes", "scalars", "ids", "items", "counts", "centroids",
        "codebooks", "n_lists", "n_items", "dim", "m_sub", "n_bits",
        "rotation",
    )

    def __init__(self, codes, scalars, ids, items, counts, centroids, codebooks, n_lists, n_items, dim, m_sub,
                 n_bits, rotation=None):
        self.codes = codes          # (N, m_sub) uint8, list-sorted
        self.scalars = scalars      # (N,) f32 ADC item scalars, list-sorted
        self.ids = ids              # (N,) int64 user ids, list-sorted
        self.items = items          # (N, dim) f32 list-sorted: the host refine payload
        self.counts = counts        # (nlist_base,) int64 per-list counts
        self.centroids = centroids  # (n_lists, dim) f32 coarse quantizer
        self.codebooks = codebooks  # (m_sub, ksub, dsub) f32
        self.n_lists = int(n_lists)
        self.n_items = int(n_items)
        self.dim = int(dim)
        self.m_sub = int(m_sub)
        self.n_bits = int(n_bits)
        self.rotation = rotation    # (d_pad, d_pad) f32 orthogonal OPQ rotation or None


def reconstruct(packed: PackedPQ, rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode rows back to (approximate) vectors: coarse centroid plus the
    subspace codewords, truncated to the true feature dim."""
    m_sub, dsub, d_pad = pq_geometry(packed.dim, packed.m_sub)
    if rows is None:
        rows = np.arange(packed.codes.shape[0])
    codes = packed.codes[rows].astype(np.int64)
    rec = np.zeros((codes.shape[0], d_pad), np.float32)
    for j in range(m_sub):
        rec[:, j * dsub : (j + 1) * dsub] = packed.codebooks[j][codes[:, j]]
    if packed.rotation is not None:
        # the codewords live in rotated space: un-rotate (r^ @ R)
        rec = (rec.astype(np.float64) @ packed.rotation.astype(np.float64)).astype(np.float32)
    row_list = np.repeat(np.arange(packed.counts.shape[0]), packed.counts)[rows]
    cpad = _pad_features(packed.centroids, d_pad)
    return (rec + cpad[row_list])[:, : packed.dim]


def _train_opq_rotation(
    res: np.ndarray,
    dsub: int,
    ksub: int,
    seed: int,
    max_train_rows: int = _OPQ_TRAIN_CAP,
    opq_iters: int = _OPQ_ITERS,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Learn the OPQ rotation R (d_pad x d_pad, orthogonal) over the coarse
    residuals: alternate per-subspace codebook training on the rotated
    sample, encoding, and the orthogonal Procrustes update (Ge et al. 2014):
    with M = X^T X^ = U S V^T, R = V U^T, host float64."""
    n, d_pad = res.shape
    m_sub = d_pad // dsub
    seed = int(seed) & 0x7FFFFFFF
    if n > max_train_rows:
        rng = np.random.default_rng(seed)
        res = res[np.sort(rng.choice(n, size=max_train_rows, replace=False))]
    X = res.astype(np.float64)
    R = np.eye(d_pad)
    for it in range(int(opq_iters)):
        Xr = (X @ R.T).astype(np.float32)
        rec = np.zeros_like(X)
        for j in range(m_sub):
            sl = slice(j * dsub, (j + 1) * dsub)
            cb = train_coarse_quantizer(
                Xr[:, sl], ksub, (seed + _SUBSPACE_SEED_STRIDE * (m_sub * it + j + 1)) & 0x7FFFFFFF,
                max_train_rows, _OPQ_KMEANS_ITERS, 1e-3, device,
            )
            rec[:, sl] = cb[assign_nearest(Xr[:, sl], cb, device)]
        U, _s, Vh = np.linalg.svd(X.T @ rec)
        R = Vh.T @ U.T
    return R.astype(np.float32)


def residuals(items: np.ndarray, centroids: np.ndarray, assign: np.ndarray, d_pad: int,
              rotation: Optional[np.ndarray] = None) -> np.ndarray:
    """Coarse residuals on the padded feature axis (pad dims exactly zero),
    rotated when an OPQ rotation is given."""
    return _rotate(_pad_features(items, d_pad) - _pad_features(centroids, d_pad)[assign], rotation)


def encode_pq(
    items: np.ndarray,
    item_ids: np.ndarray,
    assign: np.ndarray,
    res: np.ndarray,
    centroids: np.ndarray,
    codebooks: np.ndarray,
    n_lists: int,
    n_bits: int,
    rotation: Optional[np.ndarray] = None,
    device: Optional[torch.device] = None,
) -> PackedPQ:
    """Encode the (rotated) residuals with trained codebooks, compute the
    ADC scalars and pack the code lists.  res is residuals(...) of the same
    assignment."""
    n, d = items.shape
    m_sub, dsub, d_pad = codebooks.shape[0], codebooks.shape[2], res.shape[1]
    codes = np.empty((n, m_sub), np.uint8)
    for j in range(m_sub):
        codes[:, j] = assign_nearest(res[:, j * dsub : (j + 1) * dsub], codebooks[j], device).astype(np.uint8)
    # s_item = ||r^||^2 + 2 c~ . r^ in float64, stored float32; under OPQ both
    # factors live in rotated space (c~ = c @ R.T, the centroids the stager
    # puts on the device)
    rec = np.zeros((n, d_pad), np.float64)
    idx = codes.astype(np.int64)
    for j in range(m_sub):
        rec[:, j * dsub : (j + 1) * dsub] = codebooks[j][idx[:, j]]
    cass = _pad_features(centroids, d_pad)[assign].astype(np.float64)
    if rotation is not None:
        cass = cass @ rotation.astype(np.float64).T
    scalars = (np.einsum("nd,nd->n", rec, rec) + 2.0 * np.einsum("nd,nd->n", cass, rec)).astype(np.float32)
    counts, order = list_order(assign, n_lists)
    return PackedPQ(codes[order], scalars[order], np.asarray(item_ids, np.int64)[order], items[order], counts,
                    centroids, codebooks.astype(np.float32), n_lists, n, d, m_sub, n_bits, rotation=rotation)


def build_ivfpq_packed(
    items,
    item_ids: np.ndarray,
    n_lists: int,
    m_sub: int,
    n_bits: int = DEFAULT_N_BITS,
    seed: int = 0,
    max_train_rows: int = _TRAIN_CAP,
    max_iter: int = 25,
    tol: float = 1e-4,
    opq: bool = False,
    device: Optional[torch.device] = None,
) -> PackedPQ:
    """Train the coarse quantizer and the per-subspace codebooks (after the
    OPQ rotation, with opq) and pack the code lists."""
    items = np.ascontiguousarray(np.asarray(items), dtype=np.float32)
    n, d = items.shape
    if n == 0:
        raise ValueError("cannot build an IVF-PQ index over 0 items")
    if not 1 <= int(n_bits) <= 8:
        raise ValueError(f"n_bits must be in [1, 8]; got {n_bits}")
    n_lists = int(max(1, min(n_lists, n)))
    m_sub, dsub, d_pad = pq_geometry(d, m_sub)
    ksub = 1 << int(n_bits)
    seed = int(seed) & 0x7FFFFFFF
    centroids = train_coarse_quantizer(items, n_lists, seed, max_train_rows, max_iter, tol, device)
    assign = assign_nearest(items, centroids, device)
    res = residuals(items, centroids, assign, d_pad)
    rotation = None
    if opq:
        rotation = _train_opq_rotation(res, dsub, ksub, seed, device=device)
        res = _rotate(res, rotation)
    codebooks = np.stack([
        train_coarse_quantizer(res[:, j * dsub : (j + 1) * dsub], ksub,
                               (seed + _SUBSPACE_SEED_STRIDE * (j + 1)) & 0x7FFFFFFF,
                               max_train_rows, max_iter, tol, device)
        for j in range(m_sub)
    ])  # (m_sub, min(ksub, n), dsub)
    return encode_pq(items, item_ids, assign, res, centroids, codebooks, n_lists, n_bits, rotation, device)


class IVFPQIndex:
    """Device-staged IVF-PQ index on a mesh: m_sub bytes of codes (m_sub / 2
    packed) and 4 bytes of ADC scalar per item, list-sharded as the flat
    index's planes (ivfflat.IVFFlatIndex); the small planes replicated."""

    __slots__ = (
        "mesh", "codes", "scalars", "counts", "centroids", "c_norm", "codebooks",
        "ids", "rows", "n_items", "n_lists", "nlist_pad", "l_pad",
        "dim", "d_pad", "m_sub", "dsub", "ksub", "n_bits", "fastscan",
        "rotation",
    )

    def __init__(self, mesh, codes, scalars, counts, centroids, c_norm, codebooks, ids, rows, n_items, n_lists,
                 nlist_pad, l_pad, dim, d_pad, m_sub, dsub, ksub, n_bits, fastscan=False, rotation=None):
        self.mesh = mesh
        self.codes = codes          # [(lps, L_pad, m_bytes) uint8] a shard
        self.scalars = scalars      # [(lps, L_pad) f32 ADC scalars] a shard
        self.counts = counts        # [(nlist_pad,) int32] a shard: its own lists' counts, 0 elsewhere
        self.centroids = centroids  # replicated (nlist_pad, d_pad) f32 (rotated under OPQ)
        self.c_norm = c_norm        # replicated (nlist_pad,) f32, +inf pad rows
        self.codebooks = codebooks  # replicated (m_sub, ksub, dsub) f32
        self.ids = ids              # (nlist_pad * L_pad,) int64 HOST, -1 pads
        self.rows = rows            # (nlist_pad * L_pad,) int64 HOST packed row per slot, -1 pads
        self.n_items = n_items
        self.n_lists = n_lists
        self.nlist_pad = nlist_pad
        self.l_pad = l_pad
        self.dim = dim
        self.d_pad = d_pad
        self.m_sub = m_sub
        self.dsub = dsub
        self.ksub = ksub
        self.n_bits = n_bits
        self.fastscan = bool(fastscan)
        self.rotation = rotation    # HOST (d_pad, d_pad) f32 or None

    @property
    def lps(self) -> int:
        return self.nlist_pad // self.mesh.size

    def shard_planes(self, s: int):
        return (self.codes[s], self.scalars[s])

    def _replicated_bytes(self) -> int:
        return int(4 * self.nlist_pad + self.centroids[0].nbytes + self.c_norm[0].nbytes + self.codebooks[0].nbytes)

    def device_bytes(self) -> int:
        """Device-resident footprint (ids, rows and the refine payload stay
        on the host; a replicated field counted once)."""
        return int(sum(t.nbytes for t in self.codes) + sum(t.nbytes for t in self.scalars)
                   + self._replicated_bytes())


class TieredIVFPQIndex(IVFPQIndex):
    """IVF-PQ index whose codes / scalars planes live in a TieredListPlanes
    pool; the small planes (centroids, norms, codebooks) and the counts stay
    resident.  Slot 0 of the scalars plane is the +inf sentinel."""

    __slots__ = ("tier", "hot_fraction")

    def __init__(self, tier, hot_fraction, **kw):
        super().__init__(codes=None, scalars=None, **kw)
        self.tier = tier
        self.hot_fraction = float(hot_fraction)

    def device_bytes(self) -> int:
        return int(self.tier.device_bytes() + self._replicated_bytes())

    def host_bytes(self) -> int:
        return self.tier.host_bytes()


def _pq_host_layout(packed: PackedPQ, mesh: Optional[Mesh] = None) -> dict:
    """The padded host layout `mesh` stages of a PackedPQ (the flat layout's
    geometry).  Fast-scan packs two codes a byte here, and OPQ rotates the
    coarse centroids here (c~ = c @ R.T, host float64 rounded once)."""
    m_sub, dsub, d_pad = pq_geometry(packed.dim, packed.m_sub)
    fastscan = pq_fastscan(packed.n_bits, m_sub)
    nlist_pad, counts, l_pad = padded_layout_geometry(packed.n_lists, packed.counts, mesh=mesh)
    n = packed.codes.shape[0]
    flat = padded_slots(counts, l_pad)
    src = pack_codes4(packed.codes) if fastscan else packed.codes
    codes = np.zeros((nlist_pad * l_pad, src.shape[1]), np.uint8)
    codes[flat] = src
    scal = np.zeros(nlist_pad * l_pad, np.float32)
    scal[flat] = packed.scalars
    ids_pad = np.full(nlist_pad * l_pad, -1, np.int64)
    ids_pad[flat] = packed.ids
    rows_pad = np.full(nlist_pad * l_pad, -1, np.int64)
    rows_pad[flat] = np.arange(n, dtype=np.int64)
    cpad = np.zeros((nlist_pad, d_pad), np.float32)
    cpad[: packed.n_lists] = _pad_features(packed.centroids, d_pad)
    cpad = _rotate(cpad, packed.rotation)
    c_norm = item_norms(cpad)
    c_norm[packed.n_lists :] = np.inf  # pad lists never win a probe slot
    return dict(
        codes=codes.reshape(nlist_pad, l_pad, src.shape[1]), scalars=scal.reshape(nlist_pad, l_pad),
        counts=counts, ids=ids_pad, rows=rows_pad, cpad=cpad, c_norm=c_norm, nlist_pad=nlist_pad, l_pad=l_pad,
        m_sub=m_sub, dsub=dsub, d_pad=d_pad, ksub=packed.codebooks.shape[1], fastscan=fastscan,
    )


def _index_fields(packed: PackedPQ, lay: dict, mesh: Mesh) -> dict:
    return dict(
        mesh=mesh,
        counts=shard_counts(lay["counts"], mesh),
        centroids=replicated(lay["cpad"], mesh),
        c_norm=replicated(lay["c_norm"], mesh),
        codebooks=replicated(np.ascontiguousarray(packed.codebooks, np.float32), mesh),
        ids=lay["ids"], rows=lay["rows"], n_items=packed.n_items, n_lists=packed.n_lists,
        nlist_pad=lay["nlist_pad"], l_pad=lay["l_pad"], dim=packed.dim, d_pad=lay["d_pad"], m_sub=lay["m_sub"],
        dsub=lay["dsub"], ksub=lay["ksub"], n_bits=packed.n_bits, fastscan=lay["fastscan"],
        rotation=packed.rotation,
    )


def index_from_packed_pq(packed: PackedPQ, mesh=None) -> IVFPQIndex:
    """Stage a PackedPQ on `mesh` (a Mesh, a device, or None: the entry
    points' device): (nlist_pad, L_pad, m_bytes) uint8 codes and
    (nlist_pad, L_pad) float32 ADC scalars, sharded on the list axis."""
    mesh = as_mesh(mesh)
    lay = _pq_host_layout(packed, mesh)
    return IVFPQIndex(
        codes=shard_lists(lay["codes"], mesh), scalars=shard_lists(lay["scalars"], mesh),
        **_index_fields(packed, lay, mesh),
    )


def tiered_index_from_packed_pq(
    packed: PackedPQ, hot_fraction: float, mesh=None, pool_slots: Optional[int] = None
) -> TieredIVFPQIndex:
    """Stage a PackedPQ with only `hot_fraction` of each shard's lists on
    its device; the rest page in on probe."""
    from .tier import TieredListPlanes

    mesh = as_mesh(mesh)
    lay = _pq_host_layout(packed, mesh)
    tier = TieredListPlanes(
        planes=[lay["codes"], lay["scalars"]], sentinels=[None, np.inf], counts=lay["counts"], device=mesh,
        hot_fraction=hot_fraction, pool_slots=pool_slots,
    )
    return TieredIVFPQIndex(tier, hot_fraction, **_index_fields(packed, lay, mesh))


def _probe_k(k_eff: int, refine_ratio: int, n_items: int) -> int:
    """Candidates the probe selects: k without refine, k * refine_ratio
    (clamped to the item count) with it."""
    if refine_ratio <= 1:
        return k_eff
    return int(max(k_eff, min(k_eff * int(refine_ratio), n_items)))


def adc_tables(qp: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """The per-query ADC tables T[q, j, c] = -2 q_j . cb[j, c], (Q, m_sub,
    ksub) float32 (fp32 products, TF32 off)."""
    m_sub, _ksub, dsub = codebooks.shape
    return (-2.0 * torch.einsum("qjd,jcd->qjc", qp.view(qp.shape[0], m_sub, dsub), codebooks)).contiguous()


def pq_tile_bytes(index, nprobe: int) -> int:
    """Device bytes a query's scoring is budgeted: its codes (both paths
    read them in place; the budget keeps their bytes, so a launch takes as
    many queries as when they were gathered), its gathered scalars, the ADC
    sums and the distances."""
    m_bytes = index.m_sub // 2 if index.fastscan else index.m_sub
    return nprobe * index.l_pad * (m_bytes + 12)


def pq_block_scorer(index):
    def block(qb, _qn, d2p, counts):
        """ADC d2 of the block's rows, the tables computed once a block.
        Both paths read the probed lists' codes in place, +inf past a
        list's count: lut_accumulate_probed (8-bit codes) or
        fastscan_lut_accumulate_probed (4-bit codes packed two a byte)."""
        tables = adc_tables(qb, next(cb for cb in index.codebooks if cb.device == qb.device))
        probed = fastscan_lut_accumulate_probed if index.fastscan else lut_accumulate_probed

        def scores(planes, slots, sl):
            codes, scalars = planes
            c, p = slots.shape
            st = scalars.index_select(0, slots.reshape(-1)).view(c, p, codes.shape[1])
            acc = probed(tables[sl], codes, slots, counts[sl])
            # probe term + query-table term + item scalar, the JAX
            # package's association order
            return d2p[sl, :, None] + (acc + st)

        return scores

    return block


def ivfpq_search_prepared(
    index: IVFPQIndex,
    queries,
    k: int,
    nprobe: int,
    refine_items: Optional[np.ndarray] = None,
    refine_ratio: int = DEFAULT_REFINE_RATIO,
) -> Tuple[np.ndarray, np.ndarray]:
    """Probed ADC search plus the optional float32 refine: (distances
    (Q, k_eff) ascending euclidean float32, ids (Q, k_eff) int64, -1 where
    unfillable), k_eff = min(k, n_items).  With refine_items (the model's
    list-sorted float32 payload) and refine_ratio > 1 the probe selects the
    top k * refine_ratio ADC candidates and the host re-scores them."""
    q = np.asarray(queries, dtype=np.float32)
    if q.ndim != 2 or q.shape[1] != index.dim:
        raise ValueError(f"queries must be (n, {index.dim}); got {q.shape}")
    k_eff = min(k, index.n_items)
    if q.shape[0] == 0:
        return np.zeros((0, k_eff), np.float32), np.zeros((0, k_eff), np.int64)
    refine = refine_items is not None and int(refine_ratio) > 1
    kp = _probe_k(k_eff, int(refine_ratio) if refine else 1, index.n_items)
    np_eff = effective_nprobe(index, nprobe)
    # OPQ: the device side lives in rotated space; queries rotate on the
    # host in float64, rounded once
    qp = to_device_queries(_rotate(_pad_features(q, index.d_pad), index.rotation), index.d_pad,
                           index.centroids[0].device)
    d_all, p_all = probe_sweep(index, qp, kp, np_eff, pq_block_scorer(index), pq_tile_bytes(index, np_eff))
    if refine:
        return _refine_host(index, refine_items, q, d_all, p_all, k_eff)
    return d_all[:, :k_eff], ids_of(index.ids, d_all, p_all)[:, :k_eff]


def _refine_host(
    index: IVFPQIndex,
    items: np.ndarray,      # (N, dim) f32 list-sorted (the packed payload)
    q: np.ndarray,          # (Q, dim) f32 queries, true feature width
    d_probe: np.ndarray,    # (Q, R) ADC distances (inf = invalid)
    pos: np.ndarray,        # (Q, R) padded-layout positions
    k_eff: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-score the probed ADC candidates against the float32 vectors: the
    expanded form (||q||^2 - 2 q.x + ||x||^2, float32) and the
    lexicographic (d2, pos) selection, on the host, in query chunks of at
    most _REFINE_BUDGET bytes of gathered candidates."""
    Q, R = d_probe.shape
    rows = index.rows[np.minimum(pos, index.rows.size - 1)]
    invalid = np.isinf(d_probe) | (rows < 0)
    rows = np.where(invalid, 0, rows)
    qn = np.einsum("qd,qd->q", q, q, dtype=np.float32)
    q_chunk = max(1, _REFINE_BUDGET // max(R * index.dim * 4, 1))
    out_d = np.empty((Q, k_eff), np.float32)
    out_i = np.empty((Q, k_eff), np.int64)
    for s in range(0, Q, q_chunk):
        e = min(s + q_chunk, Q)
        cand = items[rows[s:e]]                      # (c, R, D) f32
        xn = np.einsum("crd,crd->cr", cand, cand, dtype=np.float32)
        cross = np.einsum("cd,crd->cr", q[s:e], cand, dtype=np.float32)
        d2 = qn[s:e, None] - 2.0 * cross + xn
        d2 = np.where(invalid[s:e], np.inf, d2)
        order = np.lexsort((pos[s:e], d2), axis=-1)[:, :k_eff]
        rsel = np.take_along_axis(d2, order, axis=1)
        psel = np.take_along_axis(pos[s:e], order, axis=1)
        ids = index.ids[np.minimum(psel, index.ids.size - 1)]
        ids[np.isinf(rsel)] = -1
        out_d[s:e] = np.sqrt(np.maximum(rsel, 0.0))
        out_i[s:e] = ids
    return out_d, out_i

