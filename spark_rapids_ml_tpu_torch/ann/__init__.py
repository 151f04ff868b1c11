#
# Approximate nearest-neighbour engines on one device: IVF-Flat (ivfflat.py)
# and IVF-PQ (pq.py), with tiered device / host residency of the list planes
# (tier.py).  Counterpart of spark_rapids_ml_tpu/ann; the live-mutation tier
# (mutable.py) comes with the serving and streaming slices.
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
    "PackedIVF",
    "build_ivfflat_packed",
    "default_nlist",
    "default_nprobe",
    "index_from_packed",
    "ivfflat_search_prepared",
    "recall_at_k",
]
