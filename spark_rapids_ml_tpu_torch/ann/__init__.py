#
# Approximate nearest-neighbour engines on a device mesh (one device is the
# one-shard mesh): IVF-Flat (ivfflat.py) and IVF-PQ (pq.py), list-sharded,
# with tiered device / host residency of the list planes (tier.py), and live
# add / delete / repack of a serving IVF-Flat index (mutable.py).
# Counterpart of spark_rapids_ml_tpu/ann.
#

from .ivfflat import (
    IVFFlatIndex,
    PackedIVF,
    build_ivfflat_packed,
    default_nlist,
    default_nprobe,
    index_from_packed,
    ivfflat_search_prepared,
    recall_at_k,
)
from .mutable import MutableIVFIndex
from .pq import (
    IVFPQIndex,
    PackedPQ,
    build_ivfpq_packed,
    default_m_sub,
    index_from_packed_pq,
    ivfpq_search_prepared,
)

__all__ = [
    "IVFPQIndex",
    "PackedPQ",
    "build_ivfpq_packed",
    "default_m_sub",
    "index_from_packed_pq",
    "ivfpq_search_prepared",
    "IVFFlatIndex",
    "MutableIVFIndex",
    "PackedIVF",
    "build_ivfflat_packed",
    "default_nlist",
    "default_nprobe",
    "index_from_packed",
    "ivfflat_search_prepared",
    "recall_at_k",
]
