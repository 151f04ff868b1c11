#
# Partition metadata of a fit.
#
# Counterpart of spark_rapids_ml_tpu/parallel/partition.py (this package's
# own copy).  The port fits on one device, so only the single-controller
# constructor is carried over; the multi-process `gather` waits for the
# multi-device slice.
#

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class PartitionDescriptor:
    """m: total rows, n: cols, rank: this worker, parts_rank_size: flat list of
    (rank, size) for every partition in rank order."""

    m: int
    n: int
    rank: int
    parts_rank_size: List[tuple] = field(default_factory=list)
    extras: List[dict] = field(default_factory=list)

    @classmethod
    def build(cls, partition_rows: List[int], total_cols: int, rank: int = 0) -> "PartitionDescriptor":
        """Single-controller constructor: each partition is tagged with its
        own index."""
        parts = [(r, size) for r, size in enumerate(partition_rows)]
        return cls(
            m=sum(partition_rows), n=total_cols, rank=rank, parts_rank_size=parts
        )

    def rank_rows(self, rank: int) -> int:
        """Total rows held by `rank` across its partitions."""
        return sum(s for r, s in self.parts_rank_size if r == rank)
